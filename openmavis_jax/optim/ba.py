"""Batched Schur-complement bundle adjustment (visual and visual-inertial).

JAX replacement for the reference's window BA entry points
(reference: src/Optimizer.cc:1280 LocalBundleAdjustment, 2728
LocalInertialBA, 368 FullInertialBA small-window case): residuals/Jacobians
for ALL observations are computed in one batched kernel, landmark blocks are
Schur-eliminated with batched 3x3 inverses, and the reduced camera system is
a dense Cholesky solve — all inside one jit-compiled LM loop.

Shapes:
  K keyframes (pose state D = 6 visual / 15 inertial), M landmarks,
  O observations, E = K-1 potential temporal inertial edges.

The dense [K, M] landmark-coupling tensor is fine for window BA
(K <= ~30, M <= ~16k). Global BA at Atlas scale uses the PCG path in
`global_ba.py` instead.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie
from . import inertial as inertial_mod
from . import lm as lm_mod
from . import robust
from .reprojection import RigParams, mono_residual, mono_residual_jac


class BAState(NamedTuple):
    R: jnp.ndarray       # [K,3,3]
    t: jnp.ndarray       # [K,3]
    v: jnp.ndarray       # [K,3]  (zeros when not inertial)
    bg: jnp.ndarray      # [K,3]
    ba: jnp.ndarray      # [K,3]
    points: jnp.ndarray  # [M,3]


class BAObservations(NamedTuple):
    kf: jnp.ndarray      # [O] int32 keyframe index
    mp: jnp.ndarray      # [O] int32 landmark index
    cam: jnp.ndarray     # [O] int32 camera index in rig
    uv: jnp.ndarray      # [O,2]
    sigma2: jnp.ndarray  # [O]
    valid: jnp.ndarray   # [O] bool


class InertialEdges(NamedTuple):
    """Temporal chain: edge e connects keyframe e -> e+1 (fixed layout)."""
    pre: object          # batched Preintegrated [E = K-1]
    valid: jnp.ndarray   # [E] bool


def _visual_terms(state: BAState, obs: BAObservations, rig: RigParams,
                  active):
    Rg = state.R[obs.kf]
    tg = state.t[obs.kf]
    p = state.points[obs.mp]
    r, Jp, Jl, depth = mono_residual_jac(Rg, tg, p, obs.cam, obs.uv, rig)
    info = 1.0 / obs.sigma2
    chi2 = jnp.sum(r * r, axis=-1) * info
    w = robust.huber_weight(chi2, robust.CHI2_2D) * info
    w = jnp.where(active & (depth > 0.01), w, 0.0)
    return r, Jp, Jl, w, chi2


def _schur_solve(Hpp, Hpl, Hll, gp, gl, lam, fixed, D):
    """Solve the damped BA normal equations by landmark elimination.

    Hpp [K*D, K*D]; Hpl [K, D, M, 3]; Hll [M, 3, 3]; gp [K*D]; gl [M, 3];
    fixed [K] bool. Returns (dx_p [K*D], dx_l [M, 3]).
    """
    K = Hpl.shape[0]
    M = Hll.shape[0]

    # damp landmark blocks and invert (batched 3x3)
    dll = jnp.diagonal(Hll, axis1=-2, axis2=-1)
    Hll_d = Hll + jax.vmap(jnp.diag)(lam * jnp.maximum(dll, 1e-9) + 1e-9)
    Hll_inv = lm_mod.inv3x3(Hll_d)

    A = Hpl.transpose(0, 1, 2, 3).reshape(K * D, M, 3)
    Y = jnp.einsum("amj,mjk->amk", A, Hll_inv)           # [K*D, M, 3]
    S = Hpp - jnp.einsum("amk,bmk->ab", Y, A)
    b_s = gp - jnp.einsum("amk,mk->a", Y, gl)

    # damp pose diagonal (Marquardt)
    dpp = jnp.diagonal(S)
    S = S + jnp.diag(lam * jnp.maximum(dpp, 1e-9) + 1e-9)

    # clamp fixed poses: identity rows/cols, zero rhs
    fixmask = jnp.repeat(fixed, D)                        # [K*D]
    S = jnp.where(fixmask[:, None] | fixmask[None, :], 0.0, S)
    S = S + jnp.diag(jnp.where(fixmask, 1.0, 0.0))
    b_s = jnp.where(fixmask, 0.0, b_s)

    L = jnp.linalg.cholesky(S)
    dx_p = jax.scipy.linalg.cho_solve((L, True), -b_s)
    dx_p = jnp.where(jnp.all(jnp.isfinite(dx_p)), dx_p,
                     jnp.zeros_like(dx_p))

    # back-substitute landmarks: dl = Hll^-1 (-gl - Hlp dx_p)
    rhs = -gl - jnp.einsum("amj,a->mj", A, dx_p)
    dx_l = jnp.einsum("mij,mj->mi", Hll_inv, rhs)
    return dx_p, dx_l


def _retract(state: BAState, dx_p, dx_l, D):
    K = state.R.shape[0]
    d = dx_p.reshape(K, D)
    R = lie.normalize_rotation(state.R @ lie.so3_exp(d[:, 0:3]))
    t = state.t + jnp.einsum("kij,kj->ki", state.R, d[:, 3:6])
    if D == 15:
        v = state.v + d[:, 6:9]
        bg = state.bg + d[:, 9:12]
        ba = state.ba + d[:, 12:15]
    else:
        v, bg, ba = state.v, state.bg, state.ba
    return BAState(R=R, t=t, v=v, bg=bg, ba=ba,
                   points=state.points + dx_l)


def _inertial_blocks(state: BAState, edges: InertialEdges, prior,
                     prior_idx: int):
    """Dense [K*15, K*15] contributions of the temporal inertial chain."""
    K = state.R.shape[0]
    D = 15
    H = jnp.zeros((K * D, K * D), state.t.dtype)
    g = jnp.zeros((K * D,), state.t.dtype)
    chi = jnp.zeros((), state.t.dtype)

    pre = edges.pre
    info9 = inertial_mod.inertial_information(pre)        # [E,9,9]
    info_g, info_a = inertial_mod.bias_rw_information(pre)
    r, J1, J2 = inertial_mod.inertial_residual_jac(
        state.R[:-1], state.t[:-1], state.v[:-1],
        state.bg[:-1], state.ba[:-1],
        state.R[1:], state.t[1:], state.v[1:], pre)
    ev = edges.valid.astype(state.t.dtype)
    info9 = info9 * ev[:, None, None]

    # J2 is [E, 9, 9] over [w, rho, dv] of frame e+1; embed to 15
    J2e = jnp.zeros(J1.shape[:-1] + (15,), J1.dtype).at[..., :9].set(J2)

    H11 = jnp.einsum("eai,eab,ebj->eij", J1, info9, J1)   # [E,15,15]
    H12 = jnp.einsum("eai,eab,ebj->eij", J1, info9, J2e)
    H22 = jnp.einsum("eai,eab,ebj->eij", J2e, info9, J2e)
    g1 = jnp.einsum("eai,eab,eb->ei", J1, info9, r)
    g2 = jnp.einsum("eai,eab,eb->ei", J2e, info9, r)
    chi = chi + jnp.einsum("ea,eab,eb->", r, info9, r)

    # bias RW: r_b = b[e+1] - b[e]
    rg = state.bg[1:] - state.bg[:-1]
    ra = state.ba[1:] - state.ba[:-1]
    info_g = info_g * ev[:, None, None]
    info_a = info_a * ev[:, None, None]
    chi = chi + jnp.einsum("ea,eab,eb->", rg, info_g, rg)
    chi = chi + jnp.einsum("ea,eab,eb->", ra, info_a, ra)

    # scatter the chain blocks (static unroll over E = K-1 edges)
    for e in range(K - 1):
        i0, j0 = e * D, (e + 1) * D
        H = H.at[i0:i0 + D, i0:i0 + D].add(H11[e])
        H = H.at[i0:i0 + D, j0:j0 + D].add(H12[e])
        H = H.at[j0:j0 + D, i0:i0 + D].add(H12[e].T)
        H = H.at[j0:j0 + D, j0:j0 + D].add(H22[e])
        g = g.at[i0:i0 + D].add(g1[e])
        g = g.at[j0:j0 + D].add(g2[e])
        # bias RW blocks: d r / d b_e = -I, d r / d b_{e+1} = I
        H = H.at[i0 + 9:i0 + 12, i0 + 9:i0 + 12].add(info_g[e])
        H = H.at[j0 + 9:j0 + 12, j0 + 9:j0 + 12].add(info_g[e])
        H = H.at[i0 + 9:i0 + 12, j0 + 9:j0 + 12].add(-info_g[e])
        H = H.at[j0 + 9:j0 + 12, i0 + 9:i0 + 12].add(-info_g[e])
        g = g.at[i0 + 9:i0 + 12].add(-info_g[e] @ rg[e])
        g = g.at[j0 + 9:j0 + 12].add(info_g[e] @ rg[e])
        H = H.at[i0 + 12:i0 + 15, i0 + 12:i0 + 15].add(info_a[e])
        H = H.at[j0 + 12:j0 + 15, j0 + 12:j0 + 15].add(info_a[e])
        H = H.at[i0 + 12:i0 + 15, j0 + 12:j0 + 15].add(-info_a[e])
        H = H.at[j0 + 12:j0 + 15, i0 + 12:i0 + 15].add(-info_a[e])
        g = g.at[i0 + 12:i0 + 15].add(-info_a[e] @ ra[e])
        g = g.at[j0 + 12:j0 + 15].add(info_a[e] @ ra[e])

    if prior is not None:
        rp, Jp15 = inertial_mod.prior_residual_jac(
            state.R[prior_idx], state.t[prior_idx], state.v[prior_idx],
            state.bg[prior_idx], state.ba[prior_idx], prior)
        i0 = prior_idx * D
        H = H.at[i0:i0 + D, i0:i0 + D].add(Jp15.T @ prior.H @ Jp15)
        g = g.at[i0:i0 + D].add(Jp15.T @ (prior.H @ rp))
        chi = chi + rp @ (prior.H @ rp)
    return H, g, chi


def bundle_adjust(state: BAState, obs: BAObservations, rig: RigParams,
                  pose_fixed, point_fixed=None,
                  edges: InertialEdges | None = None,
                  prior=None, prior_idx: int = 0,
                  stages=(5, 10), lambda0: float = 1e-2,
                  chi2_th: float = robust.CHI2_2D,
                  psum_axis: str | None = None,
                  rows_per_kf: int | None = None):
    """Window bundle adjustment with landmark Schur elimination.

    Args:
      state: BAState (use zeros for v/bg/ba in the visual-only case).
      obs: padded observation table.
      pose_fixed: [K] bool — frontier keyframes kept constant.
      point_fixed: optional [M] bool.
      edges: temporal inertial chain (None -> visual-only BA, D=6).
      prior: optional PoseImuPrior applied to keyframe `prior_idx`.
      stages: LM iterations per stage; observations are chi2-re-gated
        between stages (reference: LocalBundleAdjustment's 5+10 schedule).
    Returns (state, obs_inlier [O] bool, final_chi2).

    `psum_axis`: when set, the function is being traced inside a
    `shard_map` whose named axis shards the *observation* arrays; all
    visual-term reductions are psum'd over it (the data-parallel
    distributed-BA path — observations sharded, state replicated).
    Inertial terms are replicated and not reduced.
    """
    D = 15 if edges is not None else 6
    K = state.R.shape[0]
    M = state.points.shape[0]
    O = obs.kf.shape[0]
    active = obs.valid
    # `rows_per_kf`: observation table laid out as K contiguous blocks of
    # rows_per_kf rows per keyframe (the window trackers' repeat layout)
    # — pose blocks then reduce with a reshape-sum instead of a
    # scatter-add (window BA is launch- and scatter-latency bound, not
    # FLOP bound)
    sorted_rows = (rows_per_kf is not None and rows_per_kf * K == O
                   and psum_axis is None)

    def _psum(x):
        if psum_axis is None:
            return x
        return jax.lax.psum(x, psum_axis)

    def assemble(st: BAState, active):
        r, Jp, Jl, w, _ = _visual_terms(st, obs, rig, active)
        # pose diagonal blocks
        vpp = jnp.einsum("oai,o,oaj->oij", Jp, w, Jp).reshape(O, 36)
        vgp = jnp.einsum("oai,o,oa->oi", Jp, w, r)
        if sorted_rows:
            HppB = vpp.reshape(K, rows_per_kf, 36).sum(1).reshape(
                K, 6, 6)
            gpB = vgp.reshape(K, rows_per_kf, 6).sum(1)
        else:
            HppB = jnp.zeros((K, 36), r.dtype).at[obs.kf].add(
                vpp).reshape(K, 6, 6)
            gpB = jnp.zeros((K, 6), r.dtype).at[obs.kf].add(vgp)
        # landmark + pose-landmark coupling blocks in ONE packed
        # scatter-add over the dense [K, M] table (three separate
        # scatters each pay the same launch latency)
        vll = jnp.einsum("oai,o,oaj->oij", Jl, w, Jl).reshape(O, 9)
        vgl = jnp.einsum("oai,o,oa->oi", Jl, w, r)
        vpl = jnp.einsum("oai,o,oaj->oij", Jp, w, Jl).reshape(O, 18)
        flat = obs.kf * M + obs.mp
        packed = jnp.zeros((K * M, 30), r.dtype).at[flat].add(
            jnp.concatenate([vll, vgl, vpl], axis=-1))
        pk = _psum(packed).reshape(K, M, 30)
        HppB = _psum(HppB)
        gpB = _psum(gpB)
        Hll = pk[..., :9].sum(0).reshape(M, 3, 3)
        gl = pk[..., 9:12].sum(0)
        Hpl6 = pk[..., 12:].reshape(K, M, 6, 3).transpose(0, 2, 1, 3)
        chi = _psum(jnp.sum(w * jnp.sum(r * r, axis=-1)))

        if D == 6:
            Hpp = jnp.zeros((K * 6, K * 6), r.dtype)
            idx = jnp.arange(K)
            Hpp = Hpp.reshape(K, 6, K, 6).at[idx, :, idx, :].add(
                HppB).reshape(K * 6, K * 6)
            gp = gpB.reshape(K * 6)
            Hpl = Hpl6
        else:
            Hpp = jnp.zeros((K, 15, K, 15), r.dtype)
            idx = jnp.arange(K)
            Hpp = Hpp.at[idx, :6, idx, :6].add(HppB)
            Hpp = Hpp.reshape(K * 15, K * 15)
            gp = jnp.zeros((K, 15), r.dtype).at[:, :6].set(
                gpB).reshape(K * 15)
            Hi, gi, chi_i = _inertial_blocks(st, edges, prior, prior_idx)
            Hpp = Hpp + Hi
            gp = gp + gi
            chi = chi + chi_i
            Hpl = jnp.zeros((K, 15, M, 3), r.dtype).at[:, :6].set(Hpl6)

        if point_fixed is not None:
            pf = point_fixed
            Hll = jnp.where(pf[:, None, None],
                            jnp.broadcast_to(jnp.eye(3, dtype=r.dtype),
                                             (M, 3, 3)), Hll)
            gl = jnp.where(pf[:, None], 0.0, gl)
            Hpl = jnp.where(pf[None, None, :, None], 0.0, Hpl)
        return Hpp, Hpl, Hll, gp, gl, chi

    def lm_stage(st, active, iters):
        # one-eval LM (same driver shape as lm.lm_optimize): each
        # iteration's assemble supplies BOTH the candidate's chi2
        # (accept test) and, on acceptance, the normal equations of the
        # next step — no separate residual-only accept pass, which costs
        # nearly as many kernel launches as the full assemble
        def body(carry):
            st, A, lam, it = carry
            Hpp, Hpl, Hll, gp, gl, chi = A
            dx_p, dx_l = _schur_solve(Hpp, Hpl, Hll, gp, gl, lam,
                                      pose_fixed, D)
            st_new = _retract(st, dx_p, dx_l, D)
            A_new = assemble(st_new, active)
            accept = A_new[5] < chi
            st = jax.tree.map(lambda a, b: jnp.where(accept, b, a),
                              st, st_new)
            A = jax.tree.map(lambda a, b: jnp.where(accept, b, a),
                             A, A_new)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0),
                           1e-9, 1e6)
            return st, A, lam, it + 1

        def cond(carry):
            return carry[3] < iters

        A0 = assemble(st, active)
        st, A, _, _ = jax.lax.while_loop(
            cond, body,
            (st, A0, jnp.asarray(lambda0, jnp.float32),
             jnp.asarray(0, jnp.int32)))
        return st, A[5]

    for si, iters in enumerate(stages):
        state, chi = lm_stage(state, active, iters)
        # re-gate visual outliers between stages (residual-only pass)
        r, depth = mono_residual(state.R[obs.kf], state.t[obs.kf],
                                 state.points[obs.mp], obs.cam, obs.uv,
                                 rig)
        chi2 = jnp.sum(r * r, axis=-1) / obs.sigma2
        active = obs.valid & (chi2 < chi2_th) & (depth > 0.01)

    return state, active, chi
