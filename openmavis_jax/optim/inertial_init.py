"""Staged visual-inertial initialization: scale / gravity / bias solve.

JAX replacement for Optimizer::InertialOptimization (reference:
src/Optimizer.cc:3469/3655/3815 — IMU-only optimization with camera poses
fixed: solves gravity direction (2-dof), scale (monocular), one shared bias
and per-keyframe velocities against the preintegration chain; used by
LocalMapping::InitializeIMU's staged schedule, src/LocalMapping.cc:1255)
and Map::ApplyScaledRotation (src/Map.cc, applied at LocalMapping.cc:1367).

This runs rarely (initialization), so Jacobians come from forward-mode
autodiff over the packed parameter vector — exact and compact.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import lie
from ..imu import preintegration as pre_mod


class InertialInitResult(NamedTuple):
    scale: jnp.ndarray    # []
    R_wg: jnp.ndarray     # [3,3] gravity rotation: g_world = R_wg @ g0
    bg: jnp.ndarray       # [3] shared gyro bias
    ba: jnp.ndarray       # [3]
    v: jnp.ndarray        # [K,3] refined velocities
    chi2: jnp.ndarray


def initial_gravity_velocity(R, p, pre, edge_valid):
    """Warm starts for the inertial init: per-keyframe velocities by finite
    differences and the gravity-direction rotation from the accumulated
    bias-free velocity deltas.

    (reference: LocalMapping::InitializeIMU's dirG loop,
    src/LocalMapping.cc:1301-1329 — dirG -= R_prev * dV; velocities =
    (p2 - p1) / dT.)
    Returns (v0 [K,3], R_wg0 [3,3]).
    """
    K = R.shape[0]
    dt = jnp.maximum(pre.dT, 1e-6)
    ev = edge_valid.astype(p.dtype)
    vel = (p[1:] - p[:-1]) / dt[:, None] * ev[:, None]
    v0 = jnp.zeros((K, 3), p.dtype)
    v0 = v0.at[1:].set(vel)
    v0 = v0.at[:-1].max(vel)  # prev KF gets the same estimate
    dirG = -jnp.einsum("eij,ej,e->i", R[:-1], pre.dV, ev)
    nrm = jnp.linalg.norm(dirG)
    dirG = jnp.where(nrm > 1e-6, dirG / jnp.maximum(nrm, 1e-6),
                     jnp.asarray([0.0, 0.0, -1.0], p.dtype))
    gI = jnp.asarray([0.0, 0.0, -1.0], p.dtype)
    vx = jnp.cross(gI, dirG)
    nv = jnp.linalg.norm(vx)
    ang = jnp.arccos(jnp.clip(jnp.dot(gI, dirG), -1.0, 1.0))
    axis = jnp.where(nv > 1e-6, vx / jnp.maximum(nv, 1e-6),
                     jnp.asarray([1.0, 0.0, 0.0], p.dtype))
    R_wg0 = lie.so3_exp(axis * ang)
    return v0, R_wg0


def inertial_optimization(R, p, v0, pre, edge_valid,
                          fix_scale: bool = False,
                          prior_g: float = 1e2, prior_a: float = 1e6,
                          iters: int = 30,
                          R_wg0=None, bias0=None,
                          fix_bias: bool = False) -> InertialInitResult:
    """Solve (scale, gravity dir, shared bias, velocities), poses fixed.

    Args:
      R [K,3,3], p [K,3]: keyframe body poses (FIXED; up-to-scale for mono).
      v0 [K,3]: initial velocities.
      pre: batched Preintegrated over the K-1 consecutive intervals.
      edge_valid [K-1]: mask.
      prior_g/prior_a: bias priors (reference: priorG/priorA, 1e2/1e6 at the
        first InitializeIMU stage, LocalMapping.cc:224-265).
    """
    K = R.shape[0]
    g0 = jnp.asarray(pre_mod.GRAVITY)
    Rwg_base = jnp.eye(3) if R_wg0 is None else R_wg0
    b_base = jnp.zeros(6) if bias0 is None else bias0
    info9 = jnp.linalg.inv(
        0.5 * (pre.C[..., :9, :9]
               + jnp.swapaxes(pre.C[..., :9, :9], -1, -2))
        + 1e-9 * jnp.eye(9))

    n_params = 3 + 6 + 3 * K  # [log_s, phi_g(2)] + [bg, ba] + velocities

    def unpack(x):
        s = jnp.exp(x[0]) if not fix_scale else jnp.asarray(1.0)
        phi = jnp.concatenate([x[1:3], jnp.zeros(1)])
        R_wg = Rwg_base @ lie.so3_exp(phi)
        if fix_bias:
            bg, ba = b_base[:3], b_base[3:]   # ScaleRefinement mode
        else:
            bg = b_base[:3] + x[3:6]
            ba = b_base[3:] + x[6:9]
        v = x[9:].reshape(K, 3)
        return s, R_wg, bg, ba, v

    # whitening factor hoisted: cholesky(info9) is x-independent, and the
    # old in-closure placement recomputed it inside every jacfwd tangent
    L_white = jnp.linalg.cholesky(info9)

    def residuals(x):
        s, R_wg, bg, ba, v = unpack(x)
        g = R_wg @ g0
        b = jnp.concatenate([bg, ba])
        dt = pre.dT[:, None]
        dR = pre_mod.delta_rotation(pre, b)
        dV = pre_mod.delta_velocity(pre, b)
        dP = pre_mod.delta_position(pre, b)
        R1, R2 = R[:-1], R[1:]
        p1, p2 = s * p[:-1], s * p[1:]
        v1, v2 = v[:-1], v[1:]
        er = lie.so3_log(jnp.swapaxes(dR, -1, -2)
                         @ jnp.swapaxes(R1, -1, -2) @ R2)
        ev = jnp.einsum("eji,ej->ei", R1, v2 - v1 - g * dt) - dV
        ep = jnp.einsum("eji,ej->ei", R1,
                        p2 - p1 - v1 * dt - 0.5 * g * dt * dt) - dP
        r = jnp.concatenate([er, ev, ep], axis=-1)       # [E,9]
        w = edge_valid.astype(r.dtype)
        # whiten by the info cholesky so GN sees unit-covariance residuals
        rw = jnp.einsum("eab,eb->ea", jnp.swapaxes(L_white, -1, -2), r)
        rw = rw * w[:, None]
        # bias priors
        r_pg = jnp.sqrt(prior_g) * bg
        r_pa = jnp.sqrt(prior_a) * ba
        return jnp.concatenate([rw.reshape(-1), r_pg, r_pa])

    def res_jac(x):
        return residuals(x), jax.jacfwd(residuals)(x)

    x0 = jnp.zeros((n_params,))
    x0 = x0.at[9:].set(v0.reshape(-1))
    r0, J0 = res_jac(x0)

    def body(carry):
        # one residual+Jacobian evaluation per iteration: the candidate's
        # (r, J) become the next iteration's on acceptance
        x, r, J, lam, chi, it = carry
        H = J.T @ J
        g_ = J.T @ r
        d = jnp.diagonal(H)
        Hd = H + jnp.diag(lam * jnp.maximum(d, 1e-9) + 1e-9)
        dx = jnp.linalg.solve(Hd, -g_)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        x_new = x + dx
        r_new, J_new = res_jac(x_new)
        chi_new = jnp.sum(r_new * r_new)
        accept = chi_new < chi
        x = jnp.where(accept, x_new, x)
        r = jnp.where(accept, r_new, r)
        J = jnp.where(accept, J_new, J)
        chi = jnp.where(accept, chi_new, chi)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
        return x, r, J, lam, chi, it + 1

    x, _, _, _, chi, _ = jax.lax.while_loop(
        lambda c: c[5] < iters, body,
        (x0, r0, J0, jnp.asarray(1e-2), jnp.sum(r0 * r0),
         jnp.asarray(0)))
    s, R_wg, bg, ba, v = unpack(x)
    return InertialInitResult(scale=s, R_wg=R_wg, bg=bg, ba=ba, v=v,
                              chi2=chi)


def apply_scaled_rotation(R, p, v, points, R_gw, s):
    """Re-express the map in the gravity-aligned, metric frame.

    (reference: Map::ApplyScaledRotation used after InertialOptimization,
    src/LocalMapping.cc:1367): world' = s * R_gw * world.
    Returns (R', p', v', points').
    """
    Rn = jnp.einsum("ij,kjl->kil", R_gw, R)
    pn = s * jnp.einsum("ij,kj->ki", R_gw, p)
    vn = s * jnp.einsum("ij,kj->ki", R_gw, v)
    ptn = s * jnp.einsum("ij,mj->mi", R_gw, points)
    return Rn, pn, vn, ptn
