"""Batched reprojection residuals and analytic Jacobians.

JAX replacement for the reference's visual g2o edges
(reference: src/G2oTypes.{h,cc} EdgeMono/EdgeStereo with `cam_idx` banding,
src/OptimizableTypes.h SE3 reprojection edges). One function computes
residual + Jacobians for *all* observations of a problem at once; per-camera
rigs are handled by gathering each observation's extrinsic from a [C] table
(the batched analog of `ImuCamPose`'s per-camera pose vector,
reference: src/G2oTypes.h:54-93).

Pose convention: body-to-world (R_wb, t_wb); right-multiplicative tangent
update [omega, rho]: R <- R exp(omega^), t <- t + R rho — identical to the
reference's `ImuCamPose::Update` (src/G2oTypes.cc).
Camera extrinsics: (R_cb, t_cb) camera-from-body per camera; visual-only
problems use a single camera with R_cb = I.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import cameras, lie


@jax.tree_util.register_pytree_node_class
class RigParams:
    """Camera rig: `kind` is static (pytree aux data, so jitted functions
    can dispatch camera models at trace time), arrays are leaves."""

    def __init__(self, kind: int, params, R_cb, t_cb):
        self.kind = kind          # camera model kind (static python int)
        self.params = params      # [C, 8] intrinsics
        self.R_cb = R_cb          # [C, 3, 3] camera-from-body rotation
        self.t_cb = t_cb          # [C, 3]

    def tree_flatten(self):
        return (self.params, self.R_cb, self.t_cb), self.kind

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux, *children)


def mono_residual_jac(R_wb, t_wb, p_w, cam_idx, uv_obs, rig: RigParams):
    """Residuals + Jacobians for a batch of mono observations.

    Args:
      R_wb, t_wb: [O, 3, 3], [O, 3] — observing body pose per observation
        (already gathered per obs).
      p_w: [O, 3] world points per observation.
      cam_idx: [O] camera index within the rig.
      uv_obs: [O, 2] measured pixels.
    Returns:
      r [O, 2] (obs - projection), J_pose [O, 2, 6] (d r / d [omega, rho]),
      J_point [O, 2, 3] (d r / d p_w), depth_c [O] (camera-frame z).
    """
    Rcb = rig.R_cb[cam_idx]               # [O, 3, 3]
    tcb = rig.t_cb[cam_idx]
    params = rig.params[cam_idx]

    p_b = jnp.einsum("oji,oj->oi", R_wb, p_w - t_wb)   # R_wb^T (p - t)
    p_c = jnp.einsum("oij,oj->oi", Rcb, p_b) + tcb

    uv_hat = cameras.project(rig.kind, params, p_c)
    r = uv_obs - uv_hat

    Jproj = cameras.project_jac(rig.kind, params, p_c)  # [O, 2, 3]
    # d p_b / d omega = hat(p_b); d p_b / d rho = -I
    dpb_dw = lie.so3_hat(p_b)                           # [O, 3, 3]
    JR = jnp.einsum("oab,obc,ocd->oad", Jproj, Rcb, dpb_dw)
    Jt = -jnp.einsum("oab,obc->oac", Jproj, Rcb)
    # r = obs - proj -> d r = -Jproj d p_c
    J_pose = -jnp.concatenate([JR, Jt], axis=-1)        # [O, 2, 6]
    # d p_b / d p_w = R_wb^T
    J_point = -jnp.einsum("oab,obc,odc->oad", Jproj, Rcb, R_wb)
    return r, J_pose, J_point, p_c[..., 2]


def mono_residual(R_wb, t_wb, p_w, cam_idx, uv_obs, rig: RigParams):
    """Residual-only variant of `mono_residual_jac` — used by the LM
    accept/reject test, where Jacobians would be dead code."""
    Rcb = rig.R_cb[cam_idx]
    tcb = rig.t_cb[cam_idx]
    params = rig.params[cam_idx]
    p_b = jnp.einsum("oji,oj->oi", R_wb, p_w - t_wb)
    p_c = jnp.einsum("oij,oj->oi", Rcb, p_b) + tcb
    uv_hat = cameras.project(rig.kind, params, p_c)
    return uv_obs - uv_hat, p_c[..., 2]


def stereo_residual_jac(R_wb, t_wb, p_w, cam_idx, uvr_obs, bf, rig: RigParams):
    """3-dof rectified-stereo residual [u, v, u_r] (reference: EdgeStereo).

    u_r = u - bf / z. Only valid for the pinhole model.
    Returns r [O,3], J_pose [O,3,6], J_point [O,3,3], depth [O].
    """
    assert rig.kind == cameras.PINHOLE
    Rcb = rig.R_cb[cam_idx]
    tcb = rig.t_cb[cam_idx]
    params = rig.params[cam_idx]

    p_b = jnp.einsum("oji,oj->oi", R_wb, p_w - t_wb)
    p_c = jnp.einsum("oij,oj->oi", Rcb, p_b) + tcb
    z = p_c[..., 2]
    uv_hat = cameras.pinhole_project(params, p_c)
    ur_hat = uv_hat[..., 0] - bf / jnp.maximum(z, 1e-6)
    pred = jnp.concatenate([uv_hat, ur_hat[..., None]], axis=-1)
    r = uvr_obs - pred

    J2 = cameras.pinhole_project_jac(params, p_c)       # [O, 2, 3]
    # d ur / d p_c = d u / d p_c + bf / z^2 * dz/dp_c
    dz = jnp.zeros_like(p_c).at[..., 2].set(1.0)
    Jur = J2[:, 0, :] + (bf / jnp.maximum(z, 1e-6) ** 2)[:, None] * dz
    Jproj = jnp.concatenate([J2, Jur[:, None, :]], axis=1)  # [O, 3, 3]

    dpb_dw = lie.so3_hat(p_b)
    JR = jnp.einsum("oab,obc,ocd->oad", Jproj, Rcb, dpb_dw)
    Jt = -jnp.einsum("oab,obc->oac", Jproj, Rcb)
    J_pose = -jnp.concatenate([JR, Jt], axis=-1)
    J_point = -jnp.einsum("oab,obc,odc->oad", Jproj, Rcb, R_wb)
    return r, J_pose, J_point, z
