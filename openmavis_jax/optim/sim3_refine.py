"""Sim3 refinement by mutual reprojection (the OptimizeSim3 analog).

JAX replacement for Optimizer::OptimizeSim3 (reference:
src/Optimizer.cc:2460 — g2o refinement of a loop-candidate Sim3 with
EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ pairs and chi2 outlier
removal; called from loop detection, src/LoopClosing.cc:899).

Given matched landmark pairs expressed in the two keyframes' body frames
and their observed keypoints, refine S_21 (body2-from-body1 similarity) by
Gauss-Newton over the 7-dim tangent, minimizing BOTH projections:
  r2 = project(cam, T_cb * S(p1)) - uv2      (forward edge)
  r1 = project(cam, T_cb * S^{-1}(p2)) - uv1 (inverse edge)
with Huber weighting and a chi2 gate matching the reference's th2=10.
Jacobians come from forward-mode autodiff through the Sim3 chain — this
runs only on verified loop candidates, so exactness beats hand-derivation.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import cameras, lie


class Sim3RefineResult(NamedTuple):
    s: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    inlier: jnp.ndarray     # [N] bool (passes chi2 in both directions)
    n_inliers: jnp.ndarray
    chi2: jnp.ndarray


def _residuals(dx, s, R, t, p1, p2, rig_kind, cam1, cam2,
               R_cb1, t_cb1, R_cb2, t_cb2):
    """cam1/cam2 [N,8], R_cb* [N,3,3], t_cb* [N,3]: per-match camera —
    the reference's OptimizeSim3 projects each match through the camera
    band (cameraID) it was observed in."""
    ds, dR, dt = lie.sim3_exp(dx)
    s_n, R_n, t_n = lie.sim3_compose(ds, dR, dt, s, R, t)
    si, Ri, ti = lie.sim3_inverse(s_n, R_n, t_n)
    # forward: p1 (body1) -> body2 -> cam2 -> uv2
    q2 = lie.sim3_apply(s_n[None], R_n[None], t_n[None], p1)
    c2 = jnp.einsum("nij,nj->ni", R_cb2, q2) + t_cb2
    uv2_hat = cameras.project(rig_kind, cam2, c2)
    # inverse: p2 (body2) -> body1 -> cam1 -> uv1
    q1 = lie.sim3_apply(si[None], Ri[None], ti[None], p2)
    c1 = jnp.einsum("nij,nj->ni", R_cb1, q1) + t_cb1
    uv1_hat = cameras.project(rig_kind, cam1, c1)
    depth_ok = (c2[:, 2] > 0.05) & (c1[:, 2] > 0.05)
    return uv2_hat, uv1_hat, depth_ok


@partial(jax.jit, static_argnames=("rig_kind", "iters", "fix_scale"))
def refine_sim3(s, R, t, p1, p2, uv1, uv2, sigma2_1, sigma2_2, valid,
                rig_kind: int, cam1, cam2, R_cb1, t_cb1, R_cb2, t_cb2,
                iters: int = 8, chi2_th: float = 9.99,
                huber: float = jnp.sqrt(10.0),
                fix_scale: bool = False,
                scale_prior_weight: float = 1e3):
    """Refine S_21 from matched body-frame points + image observations.

    Args:
      s, R, t: initial Sim3 (p2 = s R p1 + t), e.g. from ransac_sim3.
      p1, p2 [N,3]: matched landmarks in each keyframe's body frame.
      uv1, uv2 [N,2]: observed keypoints of the match in each image.
      sigma2_1, sigma2_2 [N]: per-observation scale variance (level sigma2).
      valid [N]: match validity mask.
      cam1, cam2 [N,8] + R_cb*/t_cb*: per-match camera intrinsics/extrinsics
        (band-dependent for multi-camera rigs).
    Returns Sim3RefineResult.
    """
    dtype = t.dtype
    N = p1.shape[0]

    def res_vec(st, dx):
        s_, R_, t_ = st
        uv2_hat, uv1_hat, depth_ok = _residuals(
            dx, s_, R_, t_, p1, p2, rig_kind, cam1, cam2,
            R_cb1, t_cb1, R_cb2, t_cb2)
        r = jnp.concatenate([
            (uv2_hat - uv2) / jnp.sqrt(sigma2_2)[:, None],
            (uv1_hat - uv1) / jnp.sqrt(sigma2_1)[:, None]], axis=0)
        return r.reshape(-1), depth_ok

    # weak prior anchoring log-scale to the initial (Horn/RANSAC) value:
    # reprojection cannot observe scale when the relative translation is
    # near zero, but the 3D closed form already fixed it — keep it there
    # unless the images truly disagree
    s_init = s

    def chi2_of(st):
        r, depth_ok = res_vec(st, jnp.zeros(7, dtype))
        w_obs = jnp.concatenate([valid & depth_ok, valid & depth_ok])
        e2 = jnp.sum(r.reshape(-1, 2) ** 2, axis=-1)
        # Huber-saturated chi2 so outliers can't dominate acceptance
        rho = jnp.where(e2 > huber * huber,
                        2 * huber * jnp.sqrt(e2) - huber * huber, e2)
        sig_dev = jnp.log(st[0] / s_init)
        return (jnp.sum(jnp.where(w_obs, rho, 0.0))
                + scale_prior_weight * sig_dev * sig_dev)

    def lm_step(carry, _):
        st, lam, chi = carry
        s_, R_, t_ = st
        z7 = jnp.zeros(7, dtype)
        r, depth_ok = res_vec(st, z7)
        J = jax.jacfwd(lambda dx: res_vec(st, dx)[0])(z7)   # [4N, 7]
        w_obs = jnp.concatenate([valid & depth_ok, valid & depth_ok])
        e2 = jnp.sum(r.reshape(-1, 2) ** 2, axis=-1)
        hw = jnp.where(e2 > huber * huber,
                       huber / jnp.maximum(jnp.sqrt(e2), 1e-9), 1.0)
        w = (w_obs.astype(dtype) * hw)
        w4 = jnp.repeat(w, 2)
        Jw = jnp.where(w4[:, None] > 0, J, 0.0)
        rw = jnp.where(w4 > 0, r, 0.0)
        H = (Jw * w4[:, None]).T @ Jw
        g = (Jw * w4[:, None]).T @ rw
        sig_dev = jnp.log(s_ / s_init)
        H = H.at[6, 6].add(scale_prior_weight)
        g = g.at[6].add(scale_prior_weight * sig_dev)
        # LM damping with an ABSOLUTE floor: near-degenerate directions
        # (e.g. scale when the relative translation ~ 0 — reprojection is
        # scale-invariant then) must not produce unbounded steps
        d = jnp.maximum(jnp.diagonal(H), 1e-2)
        Hd = H + lam * jnp.diag(d)
        dx = -jnp.linalg.solve(Hd, g)
        if fix_scale:   # inertial/stereo: scale is observable, hold it
            dx = dx.at[6].set(0.0)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros(7, dtype))
        ds, dR, dt = lie.sim3_exp(dx)
        s_n, R_n, t_n = lie.sim3_compose(ds, dR, dt, s_, R_, t_)
        R_n = lie.normalize_rotation(R_n)
        new_st = (s_n, R_n, t_n)
        chi_new = chi2_of(new_st)
        accept = chi_new < chi
        st = jax.tree.map(lambda a, b: jnp.where(accept, b, a),
                          st, new_st)
        chi = jnp.where(accept, chi_new, chi)
        lam = jnp.clip(jnp.where(accept, lam * 0.3, lam * 5.0),
                       1e-6, 1e6)
        return (st, lam, chi), None

    chi0 = chi2_of((s, R, t))
    ((s_f, R_f, t_f), _, _), _ = jax.lax.scan(
        lm_step, ((s, R, t), jnp.asarray(1e-3, dtype), chi0), None,
        length=iters)

    uv2_hat, uv1_hat, depth_ok = _residuals(
        jnp.zeros(7, dtype), s_f, R_f, t_f, p1, p2, rig_kind, cam1, cam2,
        R_cb1, t_cb1, R_cb2, t_cb2)
    e_fwd = jnp.sum((uv2_hat - uv2) ** 2, axis=-1) / sigma2_2
    e_inv = jnp.sum((uv1_hat - uv1) ** 2, axis=-1) / sigma2_1
    inlier = valid & depth_ok & (e_fwd < chi2_th) & (e_inv < chi2_th)
    chi2 = jnp.sum(jnp.where(inlier, e_fwd + e_inv, 0.0))
    ok = jnp.isfinite(s_f) & (s_f > 1e-3) & (s_f < 1e3)
    return Sim3RefineResult(
        s=jnp.where(ok, s_f, s), R=jnp.where(ok, R_f, R),
        t=jnp.where(ok, t_f, t),
        inlier=inlier, n_inliers=jnp.sum(inlier.astype(jnp.int32)),
        chi2=chi2)
