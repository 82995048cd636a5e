"""Batched Sim(3) pose-graph optimization (essential graph).

JAX replacement for Optimizer::OptimizeEssentialGraph (reference:
src/Optimizer.cc:1826/2121 — g2o Sim3 pose graph over all keyframes after a
loop detection; 4DoF variant at 6171). All edge residuals and Jacobians are
evaluated in one batched kernel (Jacobians by forward-mode autodiff through
the Sim3 chain — exact, and this path runs only at loop closures), the dense
[K*7, K*7] system is solved by Cholesky, iterated under LM damping.

Node convention: S_i = (s_i, R_i, t_i) maps WORLD -> KEYFRAME i
(like the reference's Scw). Edge (i, j) measures S_ji = S_j * S_i^{-1}:
residual r = log(S_meas^{-1} * S_j * S_i^{-1}) in R^7.
Update: S <- exp(dx) * S (left-multiplicative, matching g2o's Sim3 vertex).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie


class PoseGraphEdges(NamedTuple):
    i: jnp.ndarray        # [E] int32
    j: jnp.ndarray        # [E]
    s: jnp.ndarray        # [E] measured relative scale (S_ji)
    R: jnp.ndarray        # [E,3,3]
    t: jnp.ndarray        # [E,3]
    weight: jnp.ndarray   # [E] information scale
    valid: jnp.ndarray    # [E] bool


def _edge_residual(dx_i, dx_j, si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """r = log(Sm^{-1} * (exp(dx_j) Sj) * (exp(dx_i) Si)^{-1})."""
    s_i2, R_i2, t_i2 = lie.sim3_exp(dx_i)
    s_j2, R_j2, t_j2 = lie.sim3_exp(dx_j)
    si_n, Ri_n, ti_n = lie.sim3_compose(s_i2, R_i2, t_i2, si, Ri, ti)
    sj_n, Rj_n, tj_n = lie.sim3_compose(s_j2, R_j2, t_j2, sj, Rj, tj)
    s_inv, R_inv, t_inv = lie.sim3_inverse(si_n, Ri_n, ti_n)
    s_ji, R_ji, t_ji = lie.sim3_compose(sj_n, Rj_n, tj_n,
                                        s_inv, R_inv, t_inv)
    sm_i, Rm_i, tm_i = lie.sim3_inverse(sm, Rm, tm)
    se, Re, te = lie.sim3_compose(sm_i, Rm_i, tm_i, s_ji, R_ji, t_ji)
    return lie.sim3_log(se, Re, te)


_res_and_jac = jax.vmap(
    lambda si, Ri, ti, sj, Rj, tj, sm, Rm, tm: (
        _edge_residual(jnp.zeros(7), jnp.zeros(7),
                       si, Ri, ti, sj, Rj, tj, sm, Rm, tm),
        jax.jacfwd(_edge_residual, argnums=(0, 1))(
            jnp.zeros(7), jnp.zeros(7),
            si, Ri, ti, sj, Rj, tj, sm, Rm, tm)))


def optimize_pose_graph(s, R, t, edges: PoseGraphEdges,
                        fixed: jnp.ndarray, node_valid: jnp.ndarray,
                        iters: int = 12, lambda0: float = 1e-4):
    """Optimize keyframe Sim3 poses (world-to-keyframe).

    Args:
      s [K], R [K,3,3], t [K,3]: initial Sim3 per keyframe.
      fixed [K] bool: gauge anchors (the reference fixes the loop KF,
        Optimizer.cc essential-graph setup).
    Returns (s, R, t, final_chi2).
    """
    K = s.shape[0]
    D = 7

    def assemble(state):
        s_, R_, t_ = state
        si, Ri, ti = s_[edges.i], R_[edges.i], t_[edges.i]
        sj, Rj, tj = s_[edges.j], R_[edges.j], t_[edges.j]
        r, (Ji, Jj) = _res_and_jac(si, Ri, ti, sj, Rj, tj,
                                   edges.s, edges.R, edges.t)
        w = jnp.where(edges.valid, edges.weight, 0.0)
        chi = jnp.sum(w * jnp.sum(r * r, axis=-1))

        H = jnp.zeros((K, D, K, D), s_.dtype)
        g = jnp.zeros((K, D), s_.dtype)
        Hii = jnp.einsum("eai,e,eaj->eij", Ji, w, Ji)
        Hjj = jnp.einsum("eai,e,eaj->eij", Jj, w, Jj)
        Hij = jnp.einsum("eai,e,eaj->eij", Ji, w, Jj)
        gi = jnp.einsum("eai,e,ea->ei", Ji, w, r)
        gj = jnp.einsum("eai,e,ea->ei", Jj, w, r)
        H = H.at[edges.i, :, edges.i, :].add(Hii)
        H = H.at[edges.j, :, edges.j, :].add(Hjj)
        H = H.at[edges.i, :, edges.j, :].add(Hij)
        H = H.at[edges.j, :, edges.i, :].add(
            jnp.swapaxes(Hij, -1, -2))
        g = g.at[edges.i].add(gi)
        g = g.at[edges.j].add(gj)
        return H.reshape(K * D, K * D), g.reshape(K * D), chi

    def chi2_fn(state):
        s_, R_, t_ = state
        r, _ = _res_and_jac(s_[edges.i], R_[edges.i], t_[edges.i],
                            s_[edges.j], R_[edges.j], t_[edges.j],
                            edges.s, edges.R, edges.t)
        w = jnp.where(edges.valid, edges.weight, 0.0)
        return jnp.sum(w * jnp.sum(r * r, axis=-1))

    fixmask = jnp.repeat(fixed | ~node_valid, D)

    def body(carry):
        state, lam, chi, it = carry
        H, g, _ = assemble(state)
        H = jnp.where(fixmask[:, None] | fixmask[None, :], 0.0, H)
        H = H + jnp.diag(jnp.where(fixmask, 1.0, 0.0))
        g = jnp.where(fixmask, 0.0, g)
        d = jnp.diagonal(H)
        Hd = H + jnp.diag(lam * jnp.maximum(d, 1e-9) + 1e-9)
        L = jnp.linalg.cholesky(Hd)
        dx = jax.scipy.linalg.cho_solve((L, True), -g)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        dxn = dx.reshape(K, D)
        s_, R_, t_ = state
        ds, dR, dt = lie.sim3_exp(dxn)
        s_new = ds * s_
        R_new = lie.normalize_rotation(dR @ R_)
        t_new = ds[:, None] * jnp.einsum("kij,kj->ki", dR, t_) + dt
        new_state = (s_new, R_new, t_new)
        chi_new = chi2_fn(new_state)
        accept = chi_new < chi
        state = jax.tree.map(lambda a, b: jnp.where(accept, b, a),
                             state, new_state)
        chi = jnp.where(accept, chi_new, chi)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
        return state, lam, chi, it + 1

    state0 = (s, R, t)
    chi0 = chi2_fn(state0)
    state, _, chi, _ = jax.lax.while_loop(
        lambda c: c[3] < iters, body,
        (state0, jnp.asarray(lambda0, jnp.float32), chi0,
         jnp.asarray(0, jnp.int32)))
    return state[0], state[1], state[2], chi


# ---------------------------------------------------------------------------
# 4DoF variant (inertial): yaw + translation only, gravity direction held
# ---------------------------------------------------------------------------

def _edge_residual_4dof(dx_i, dx_j, Ri, ti, Rj, tj, Rm, tm):
    """SE3 residual with 4-dim node updates [tx, ty, tz, yaw].

    Update is left-multiplicative with the rotation constrained to the
    gravity (world z) axis: T <- exp([rho, yaw*e_z]) * T. This is the
    reference's VertexPose4DoF parametrization (G2oTypes.h:219-262 — roll/
    pitch frozen after IMU initialization fixes gravity).
    """
    def se3_of(dx):
        w = jnp.stack([jnp.zeros((), dx.dtype), jnp.zeros((), dx.dtype),
                       dx[3]])
        return lie.se3_exp(jnp.concatenate([dx[:3], w]))

    dRi, dti = se3_of(dx_i)
    dRj, dtj = se3_of(dx_j)
    Ri_n, ti_n = lie.se3_compose(dRi, dti, Ri, ti)
    Rj_n, tj_n = lie.se3_compose(dRj, dtj, Rj, tj)
    Rinv, tinv = lie.se3_inverse(Ri_n, ti_n)
    Rji, tji = lie.se3_compose(Rj_n, tj_n, Rinv, tinv)
    Rmi, tmi = lie.se3_inverse(Rm, tm)
    Re, te = lie.se3_compose(Rmi, tmi, Rji, tji)
    return lie.se3_log(Re, te)


_res_and_jac_4dof = jax.vmap(
    lambda Ri, ti, Rj, tj, Rm, tm: (
        _edge_residual_4dof(jnp.zeros(4), jnp.zeros(4),
                            Ri, ti, Rj, tj, Rm, tm),
        jax.jacfwd(_edge_residual_4dof, argnums=(0, 1))(
            jnp.zeros(4), jnp.zeros(4), Ri, ti, Rj, tj, Rm, tm)))


class PoseGraphEdgesSE3(NamedTuple):
    i: jnp.ndarray        # [E] int32
    j: jnp.ndarray        # [E]
    R: jnp.ndarray        # [E,3,3] measured T_ji rotation
    t: jnp.ndarray        # [E,3]
    weight: jnp.ndarray   # [E]
    valid: jnp.ndarray    # [E] bool


def optimize_pose_graph_4dof(R, t, edges: PoseGraphEdgesSE3,
                             fixed: jnp.ndarray, node_valid: jnp.ndarray,
                             iters: int = 12, lambda0: float = 1e-4):
    """4DoF essential-graph optimization for inertial maps.

    After IMU init the gravity direction (roll/pitch) is observable and
    must not be bent by a loop correction — only yaw and translation are
    optimized (reference: Optimizer::OptimizeEssentialGraph4DoF,
    src/Optimizer.cc:6171, called from CorrectLoop for inertial maps,
    src/LoopClosing.cc:1329).

    Args:
      R [K,3,3], t [K,3]: world->keyframe SE3 per node (like Scw, scale 1).
    Returns (R, t, final_chi2).
    """
    K = R.shape[0]
    D = 4

    def res_all(state):
        R_, t_ = state
        return _res_and_jac_4dof(R_[edges.i], t_[edges.i],
                                 R_[edges.j], t_[edges.j],
                                 edges.R, edges.t)

    def chi2_fn(state):
        r, _ = res_all(state)
        w = jnp.where(edges.valid, edges.weight, 0.0)
        return jnp.sum(w * jnp.sum(r * r, axis=-1))

    fixmask = jnp.repeat(fixed | ~node_valid, D)

    def body(carry):
        state, lam, chi, it = carry
        r, (Ji, Jj) = res_all(state)
        w = jnp.where(edges.valid, edges.weight, 0.0)
        H = jnp.zeros((K, D, K, D), t.dtype)
        g = jnp.zeros((K, D), t.dtype)
        Hii = jnp.einsum("eai,e,eaj->eij", Ji, w, Ji)
        Hjj = jnp.einsum("eai,e,eaj->eij", Jj, w, Jj)
        Hij = jnp.einsum("eai,e,eaj->eij", Ji, w, Jj)
        H = H.at[edges.i, :, edges.i, :].add(Hii)
        H = H.at[edges.j, :, edges.j, :].add(Hjj)
        H = H.at[edges.i, :, edges.j, :].add(Hij)
        H = H.at[edges.j, :, edges.i, :].add(jnp.swapaxes(Hij, -1, -2))
        g = g.at[edges.i].add(jnp.einsum("eai,e,ea->ei", Ji, w, r))
        g = g.at[edges.j].add(jnp.einsum("eai,e,ea->ei", Jj, w, r))
        H = H.reshape(K * D, K * D)
        g = g.reshape(K * D)
        H = jnp.where(fixmask[:, None] | fixmask[None, :], 0.0, H)
        H = H + jnp.diag(jnp.where(fixmask, 1.0, 0.0))
        g = jnp.where(fixmask, 0.0, g)
        d = jnp.diagonal(H)
        Hd = H + jnp.diag(lam * jnp.maximum(d, 1e-9) + 1e-9)
        L = jnp.linalg.cholesky(Hd)
        dx = jax.scipy.linalg.cho_solve((L, True), -g)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        dxn = dx.reshape(K, D)
        R_, t_ = state
        wz = jnp.concatenate([jnp.zeros((K, 2), t.dtype), dxn[:, 3:4]],
                             axis=-1)
        dR = lie.so3_exp(wz)
        dt = jnp.einsum("kij,kj->ki", lie.so3_left_jacobian(wz),
                        dxn[:, :3])
        R_new = lie.normalize_rotation(dR @ R_)
        t_new = jnp.einsum("kij,kj->ki", dR, t_) + dt
        new_state = (R_new, t_new)
        chi_new = chi2_fn(new_state)
        accept = chi_new < chi
        state = jax.tree.map(lambda a, b: jnp.where(accept, b, a),
                             state, new_state)
        chi = jnp.where(accept, chi_new, chi)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
        return state, lam, chi, it + 1

    state0 = (R, t)
    chi0 = chi2_fn(state0)
    state, _, chi, _ = jax.lax.while_loop(
        lambda c: c[3] < iters, body,
        (state0, jnp.asarray(lambda0, jnp.float32), chi0,
         jnp.asarray(0, jnp.int32)))
    return state[0], state[1], chi


def sequential_edges_se3(R, t, n_kf, max_k: int):
    """Odometry-chain SE3 edges from current world->kf poses."""
    K = max_k
    i = jnp.arange(K - 1)
    j = i + 1
    Ri_, ti_ = lie.se3_inverse(R[i], t[i])
    Re, te = lie.se3_compose(R[j], t[j], Ri_, ti_)
    return PoseGraphEdgesSE3(i=i, j=j, R=Re, t=te,
                             weight=jnp.ones((K - 1,)),
                             valid=(j < n_kf))


def sequential_edges(s, R, t, n_kf, max_k: int):
    """Build odometry-chain edges from current poses (the spanning-tree part
    of the essential graph): edge (k, k+1) with the current relative Sim3."""
    K = max_k
    i = jnp.arange(K - 1)
    j = i + 1
    si_, Ri_, ti_ = lie.sim3_inverse(s[i], R[i], t[i])
    se, Re, te = lie.sim3_compose(s[j], R[j], t[j], si_, Ri_, ti_)
    valid = (j < n_kf)
    return PoseGraphEdges(i=i, j=j, s=se, R=Re, t=te,
                          weight=jnp.ones((K - 1,)), valid=valid)
