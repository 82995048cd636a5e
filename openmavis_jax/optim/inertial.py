"""Inertial factors: preintegration edge, bias random walk, pose-imu prior.

JAX replacement for the reference's inertial g2o edges
(reference: src/G2oTypes.h:433-560 EdgeInertial + analytic Jacobians in
src/G2oTypes.cc:478-620; bias RW edges G2oTypes.h:567-633; 15-dim prior
EdgePriorPoseImu G2oTypes.h:635-702).

State per frame: (R_wb [3,3], t_wb [3], v [3], bg [3], ba [3]).
Tangent/update order per frame: [omega(3), rho(3), dv(3), dbg(3), dba(3)]
with right-multiplicative pose update (R <- R exp(w^), t <- t + R rho).

All functions are batched over an edge axis; Jacobians are analytic
(Forster-style right-Jacobian forms, matching the reference).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import lie
from ..imu import preintegration as pre_mod

GRAVITY = pre_mod.GRAVITY


def inertial_residual(R1, p1, v1, bg1, ba1, R2, p2, v2, pre,
                      gravity=None):
    """9-dim residual [er, ev, ep] of the preintegration constraint.

    (reference: EdgeInertial::computeError, src/G2oTypes.cc:478-504)
    All args batched over leading edge axis; `pre` is a batched
    Preintegrated pytree.
    """
    g = jnp.asarray(GRAVITY if gravity is None else gravity)
    b1 = jnp.concatenate([bg1, ba1], axis=-1)
    dR = pre_mod.delta_rotation(pre, b1)
    dV = pre_mod.delta_velocity(pre, b1)
    dP = pre_mod.delta_position(pre, b1)
    dt = pre.dT[..., None]

    er = lie.so3_log(jnp.swapaxes(dR, -1, -2)
                     @ jnp.swapaxes(R1, -1, -2) @ R2)
    ev = jnp.einsum("...ji,...j->...i", R1, v2 - v1 - g * dt) - dV
    ep = jnp.einsum("...ji,...j->...i", R1,
                    p2 - p1 - v1 * dt - 0.5 * g * dt * dt) - dP
    return jnp.concatenate([er, ev, ep], axis=-1)


def inertial_residual_jac(R1, p1, v1, bg1, ba1, R2, p2, v2, pre,
                          gravity=None):
    """Residual + analytic Jacobians of the inertial edge.

    Returns:
      r [...,9],
      J1 [...,9,15] w.r.t. frame-1 tangent [w, rho, dv, dbg, dba],
      J2 [...,9,9]  w.r.t. frame-2 tangent [w, rho, dv] (frame 2 biases do
        not enter the edge — the reference ties the edge to bias *1*).
    (reference: EdgeInertial::linearizeOplus, src/G2oTypes.cc:506-620)
    """
    g = jnp.asarray(GRAVITY if gravity is None else gravity)
    b1 = jnp.concatenate([bg1, ba1], axis=-1)
    dbg = bg1 - pre.b[..., :3]
    dt = pre.dT[..., None]

    dR = pre_mod.delta_rotation(pre, b1)
    dV = pre_mod.delta_velocity(pre, b1)
    dP = pre_mod.delta_position(pre, b1)

    R1T = jnp.swapaxes(R1, -1, -2)
    er = lie.so3_log(jnp.swapaxes(dR, -1, -2) @ R1T @ R2)
    u_v = v2 - v1 - g * dt
    u_p = p2 - p1 - v1 * dt - 0.5 * g * dt * dt
    ev = jnp.einsum("...ji,...j->...i", R1, u_v) - dV
    ep = jnp.einsum("...ji,...j->...i", R1, u_p) - dP
    r = jnp.concatenate([er, ev, ep], axis=-1)

    invJr = lie.so3_right_jacobian_inv(er)
    eR = lie.so3_exp(er)

    batch = er.shape[:-1]
    Z3 = jnp.zeros(batch + (3, 3), dtype=er.dtype)

    # --- d er ---
    der_dw1 = -invJr @ jnp.swapaxes(R2, -1, -2) @ R1
    der_dw2 = invJr
    # bias-gyro: er(bg) via dR(bg) = dR exp(JRg dbg):
    # d er/d dbg = -invJr @ exp(er)^T @ Jr(JRg dbg) @ JRg
    JRg_dbg = jnp.einsum("...ij,...j->...i", pre.JRg, dbg)
    der_dbg = -invJr @ jnp.swapaxes(eR, -1, -2) \
        @ lie.so3_right_jacobian(JRg_dbg) @ pre.JRg

    # --- d ev ---
    dev_dw1 = lie.so3_hat(jnp.einsum("...ji,...j->...i", R1, u_v))
    dev_dv1 = -R1T
    dev_dv2 = R1T
    dev_dbg = -pre.JVg
    dev_dba = -pre.JVa

    # --- d ep ---
    dep_dw1 = lie.so3_hat(jnp.einsum("...ji,...j->...i", R1, u_p))
    dep_drho1 = -jnp.broadcast_to(jnp.eye(3, dtype=er.dtype),
                                  batch + (3, 3))
    dep_drho2 = R1T @ R2
    dep_dv1 = -R1T * dt[..., None]
    dep_dbg = -pre.JPg
    dep_dba = -pre.JPa

    def rows(blocks):
        return jnp.concatenate(blocks, axis=-1)

    J1 = jnp.concatenate([
        rows([der_dw1, Z3, Z3, der_dbg, Z3]),
        rows([dev_dw1, Z3, dev_dv1, dev_dbg, dev_dba]),
        rows([dep_dw1, dep_drho1, dep_dv1, dep_dbg, dep_dba]),
    ], axis=-2)                                         # [...,9,15]
    J2 = jnp.concatenate([
        rows([der_dw2, Z3, Z3]),
        rows([Z3, Z3, dev_dv2]),
        rows([Z3, dep_drho2, Z3]),
    ], axis=-2)                                         # [...,9,9]
    return r, J1, J2


def inertial_information(pre, eps: float = 1e-8):
    """Information matrix of the 9-dim edge = inv(C[0:9,0:9]), symmetrized.

    (reference: EdgeInertial ctor uses C.block<9,9>(0,0).inverse())
    """
    C = pre.C[..., :9, :9]
    C = 0.5 * (C + jnp.swapaxes(C, -1, -2))
    C = C + eps * jnp.eye(9, dtype=C.dtype)
    return jnp.linalg.inv(C)


def bias_rw_information(pre, eps: float = 1e-12):
    """Information of the gyro/acc random-walk edges between consecutive
    keyframes: inverse of C[9:12,9:12] and C[12:15,12:15].

    (reference: EdgeGyroRW/EdgeAccRW info set from C blocks,
    src/Optimizer.cc LocalInertialBA edge construction)
    Returns (info_g [...,3,3], info_a [...,3,3]).
    """
    Cg = pre.C[..., 9:12, 9:12] + eps * jnp.eye(3, dtype=pre.C.dtype)
    Ca = pre.C[..., 12:15, 12:15] + eps * jnp.eye(3, dtype=pre.C.dtype)
    return jnp.linalg.inv(Cg), jnp.linalg.inv(Ca)


class PoseImuPrior(NamedTuple):
    """Marginalization prior on one frame's full inertial state.

    (reference: ConstraintPoseImu / EdgePriorPoseImu, G2oTypes.h:635-702)
    """
    R: jnp.ndarray       # [3,3]
    p: jnp.ndarray       # [3]
    v: jnp.ndarray       # [3]
    bg: jnp.ndarray      # [3]
    ba: jnp.ndarray      # [3]
    H: jnp.ndarray       # [15,15] information


def prior_residual_jac(R, p, v, bg, ba, prior: PoseImuPrior):
    """15-dim prior residual [er, ep, ev, ebg, eba] + Jacobian [15,15].

    er = Log(Rp^T R); ep = p - pp; ev = v - vp; biases additive.
    Jacobian w.r.t. [w, rho, dv, dbg, dba] (right-mult pose update).
    """
    er = lie.so3_log(jnp.swapaxes(prior.R, -1, -2) @ R)
    ep = p - prior.p
    ev = v - prior.v
    ebg = bg - prior.bg
    eba = ba - prior.ba
    r = jnp.concatenate([er, ep, ev, ebg, eba], axis=-1)

    batch = er.shape[:-1]
    dtype = er.dtype
    Z3 = jnp.zeros(batch + (3, 3), dtype=dtype)
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch + (3, 3))
    invJr = lie.so3_right_jacobian_inv(er)

    def rows(blocks):
        return jnp.concatenate(blocks, axis=-1)

    J = jnp.concatenate([
        rows([invJr, Z3, Z3, Z3, Z3]),        # d er / d w  (right update)
        rows([Z3, R, Z3, Z3, Z3]),            # d ep / d rho: p += R rho
        rows([Z3, Z3, I3, Z3, Z3]),
        rows([Z3, Z3, Z3, I3, Z3]),
        rows([Z3, Z3, Z3, Z3, I3]),
    ], axis=-2)
    return r, J
