"""Global bundle adjustment: matrix-free Schur + PCG, Atlas scale.

JAX replacement for the reference's whole-map optimizations
(reference: src/Optimizer.cc:29 GlobalBundleAdjustemnt / 368 FullInertialBA,
launched as the background GBA thread, src/LoopClosing.cc:2351). The window
BA in `ba.py` materializes the dense reduced camera system — fine for
K <= ~32. At Atlas scale (hundreds of keyframes, 10^4..10^5 landmarks) the
[K*D, K*D] Schur matrix and the [K, D, M, 3] coupling tensor are too large;
this module never materializes them:

* landmark blocks Hll [M,3,3] are assembled by scatter-add and inverted
  batched (the Schur elimination);
* the reduced camera system S = Hpp - Hpl Hll^-1 Hlp is applied as an
  OPERATOR: two observation-indexed gather/scatter passes per
  matrix-vector product — exactly the sparsity of the BA graph, no dense
  fill-in;
* S dx = -b is solved with preconditioned conjugate gradients
  (block-Jacobi preconditioner from the pose diagonal blocks), wrapped in
  an LM damping/acceptance loop;
* the inertial chain (FullInertialBA) enters as block-tridiagonal per-edge
  [15,15] blocks applied edge-wise in the same operator.

Distribution: every reduction in the operator is a `psum` over an optional
`psum_axis`, so the SAME function body runs observation-sharded under
`shard_map` (see parallel/dist_ba.distributed_global_ba) — per CG step the
collective payload is one [K, D] vector plus scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import inertial as inertial_mod
from . import lm as lm_mod
from . import robust
from .ba import BAState, BAObservations, InertialEdges, _retract
from .reprojection import RigParams, mono_residual_jac


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


def _inertial_edge_blocks(state: BAState, edges: InertialEdges):
    """Per-edge block-tridiagonal contributions of the temporal chain,
    bias random-walk folded in. Returns (H11, H12, H22 [E,15,15],
    g1, g2 [E,15], chi)."""
    pre = edges.pre
    info9 = inertial_mod.inertial_information(pre)
    info_g, info_a = inertial_mod.bias_rw_information(pre)
    r, J1, J2 = inertial_mod.inertial_residual_jac(
        state.R[:-1], state.t[:-1], state.v[:-1],
        state.bg[:-1], state.ba[:-1],
        state.R[1:], state.t[1:], state.v[1:], pre)
    ev = edges.valid.astype(state.t.dtype)
    info9 = info9 * ev[:, None, None]
    info_g = info_g * ev[:, None, None]
    info_a = info_a * ev[:, None, None]

    J2e = jnp.zeros(J1.shape[:-1] + (15,), J1.dtype).at[..., :9].set(J2)
    H11 = jnp.einsum("eai,eab,ebj->eij", J1, info9, J1)
    H12 = jnp.einsum("eai,eab,ebj->eij", J1, info9, J2e)
    H22 = jnp.einsum("eai,eab,ebj->eij", J2e, info9, J2e)
    g1 = jnp.einsum("eai,eab,eb->ei", J1, info9, r)
    g2 = jnp.einsum("eai,eab,eb->ei", J2e, info9, r)
    chi = jnp.einsum("ea,eab,eb->", r, info9, r)

    rg = state.bg[1:] - state.bg[:-1]
    ra = state.ba[1:] - state.ba[:-1]
    chi = chi + jnp.einsum("ea,eab,eb->", rg, info_g, rg)
    chi = chi + jnp.einsum("ea,eab,eb->", ra, info_a, ra)
    # bias RW: residual b_{e+1} - b_e; J wrt e is -I, wrt e+1 is +I
    H11 = H11.at[:, 9:12, 9:12].add(info_g).at[:, 12:15, 12:15].add(info_a)
    H22 = H22.at[:, 9:12, 9:12].add(info_g).at[:, 12:15, 12:15].add(info_a)
    H12 = H12.at[:, 9:12, 9:12].add(-info_g).at[:, 12:15, 12:15].add(
        -info_a)
    g1 = g1.at[:, 9:12].add(-jnp.einsum("eij,ej->ei", info_g, rg))
    g1 = g1.at[:, 12:15].add(-jnp.einsum("eij,ej->ei", info_a, ra))
    g2 = g2.at[:, 9:12].add(jnp.einsum("eij,ej->ei", info_g, rg))
    g2 = g2.at[:, 12:15].add(jnp.einsum("eij,ej->ei", info_a, ra))
    return H11, H12, H22, g1, g2, chi


def global_bundle_adjust(state: BAState, obs: BAObservations,
                         rig: RigParams, pose_fixed, point_fixed=None,
                         edges: InertialEdges | None = None,
                         prior=None, prior_idx: int = 0,
                         stages=(5, 10), cg_iters: int = 24,
                         lambda0: float = 1e-2,
                         chi2_th: float = robust.CHI2_2D,
                         psum_axis: str | None = None,
                         points_local: bool = False):
    """Matrix-free global BA. Same contract as ba.bundle_adjust but scales
    to hundreds of keyframes / 10^5 landmarks and shards over a mesh.

    `points_local=True` declares that the landmark axis is SHARDED across
    `psum_axis` and every observation of a landmark lives on its owner
    device (parallel/dist_ba.distributed_global_ba_lsharded arranges
    this). The per-landmark reductions (Hll, gl, lx) are then shard-local
    and skip their collectives — only [K, D]-sized pose reductions ride
    the interconnect, and landmark state/Hessian memory scales 1/n_dev.

    Returns (state, obs_inlier [O] bool, final_chi2).
    """
    D = 15 if edges is not None else 6
    K = state.R.shape[0]
    M = state.points.shape[0]
    active0 = obs.valid
    fixmask = pose_fixed[:, None] & jnp.ones((K, D), bool)

    # K-axis scatter/gather as one-hot matmuls: the K axis is tiny, so a
    # precomputed [O, K] one-hot turns each scatter/gather of every CG
    # matvec into one dense matmul, computed ONCE and reused by every CG
    # iteration of every LM step (whether a gather/segment-sum now beats
    # it on the GPU is open, ROADMAP 1.5). precision="highest" keeps the
    # normal equations in true f32 (TF32 would keep ~3 digits).
    oh_kf = (obs.kf[:, None] == jnp.arange(K)[None, :]).astype(
        state.t.dtype)                                     # [O, K]

    def scat_kf(vals):
        """[O, d] -> [K, d] sum-by-keyframe."""
        return jnp.einsum("ok,od->kd", oh_kf, vals,
                          precision="highest")

    def gath_kf(xk):
        """[K, d] -> [O, d] broadcast-by-keyframe."""
        return jnp.einsum("ok,kd->od", oh_kf, xk,
                          precision="highest")

    def _psum(x):
        if psum_axis is None:
            return x
        return jax.lax.psum(x, psum_axis)

    def _psum_l(x):
        # landmark-axis reduction: identity when landmarks are sharded
        if psum_axis is None or points_local:
            return x
        return jax.lax.psum(x, psum_axis)

    def prepare(st, active, lam):
        """Per-LM-iteration fixed quantities: weights, Hll^-1, rhs."""
        r, Jp, Jl, w, _ = _visual_terms(st, obs, rig, active)
        Hll = jnp.zeros((M, 3, 3), r.dtype).at[obs.mp].add(
            jnp.einsum("oai,o,oaj->oij", Jl, w, Jl))
        gl = jnp.zeros((M, 3), r.dtype).at[obs.mp].add(
            jnp.einsum("oai,o,oa->oi", Jl, w, r))
        Hll = _psum_l(Hll)
        gl = _psum_l(gl)
        dll = jnp.diagonal(Hll, axis1=-2, axis2=-1)
        Hll_d = Hll + jax.vmap(jnp.diag)(
            lam * jnp.maximum(dll, 1e-9) + 1e-9)
        if point_fixed is not None:
            eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), (M, 3, 3))
            Hll_d = jnp.where(point_fixed[:, None, None], eye, Hll_d)
            gl = jnp.where(point_fixed[:, None], 0.0, gl)
        Hll_inv = lm_mod.inv3x3(Hll_d)

        # pose diagonal blocks (visual part) for the preconditioner
        Hpp_blk = scat_kf(jnp.einsum("oai,o,oaj->oij", Jp, w,
                                     Jp).reshape(-1, 36)).reshape(
                                         K, 6, 6)
        gp6 = scat_kf(jnp.einsum("oai,o,oa->oi", Jp, w, r))
        Hpp_blk = _psum(Hpp_blk)
        gp6 = _psum(gp6)
        chi = _psum(jnp.sum(w * jnp.sum(r * r, axis=-1)))

        gp = jnp.zeros((K, D), r.dtype).at[:, :6].set(gp6)
        HppD = jnp.zeros((K, D, D), r.dtype).at[:, :6, :6].set(Hpp_blk)
        iblocks = None
        Hp_prior = None
        if D == 15:
            H11, H12, H22, g1, g2, chi_i = _inertial_edge_blocks(st, edges)
            gp = gp.at[:-1].add(g1).at[1:].add(g2)
            HppD = HppD.at[:-1].add(H11).at[1:].add(H22)
            chi = chi + chi_i
            iblocks = (H11, H12, H22)
            if prior is not None:
                rp, Jp15 = inertial_mod.prior_residual_jac(
                    st.R[prior_idx], st.t[prior_idx], st.v[prior_idx],
                    st.bg[prior_idx], st.ba[prior_idx], prior)
                Hp_prior = Jp15.T @ prior.H @ Jp15
                HppD = HppD.at[prior_idx].add(Hp_prior)
                gp = gp.at[prior_idx].add(Jp15.T @ (prior.H @ rp))
                chi = chi + rp @ (prior.H @ rp)

        # rhs of the reduced system: b = gp - Hpl Hll^-1 gl (per pose)
        u = jnp.einsum("mij,mj->mi", Hll_inv, gl)          # [M,3]
        uo = jnp.einsum("oai,oi->oa", Jl, u[obs.mp])       # [O,2]
        corr = _psum(scat_kf(jnp.einsum("oai,o,oa->oi", Jp, w, uo)))
        b = gp.at[:, :6].add(-corr)
        return (Jp, Jl, w), Hll_inv, HppD, iblocks, Hp_prior, b, gl, chi

    def matvec(x, terms, Hll_inv, HppD, iblocks, Hp_prior, lam):
        """y = (S + lam*diag) x with fixed poses projected out.

        S = [visual pose blocks] - Hpl Hll^-1 Hlp
            + [inertial block-tridiagonal chain] + [prior block]."""
        Jp, Jl, w = terms
        x = jnp.where(fixmask, 0.0, x)
        x6 = x[:, :6]
        yo = jnp.einsum("oai,oi->oa", Jp, gath_kf(x6))     # [O,2]
        # visual Hpp x (diagonal pose blocks)
        hx = _psum(scat_kf(jnp.einsum("oai,o,oa->oi", Jp, w, yo)))
        # Schur correction: Hpl Hll^-1 Hlp x
        lx = jnp.zeros((M, 3), x.dtype).at[obs.mp].add(
            jnp.einsum("oai,o,oa->oi", Jl, w, yo))
        lx = _psum_l(lx)
        v = jnp.einsum("mij,mj->mi", Hll_inv, lx)
        vo = jnp.einsum("oai,oi->oa", Jl, v[obs.mp])
        sx = _psum(scat_kf(jnp.einsum("oai,o,oa->oi", Jp, w, vo)))
        y = jnp.zeros((K, D), x.dtype).at[:, :6].set(hx - sx)
        if D == 15:
            H11, H12, H22 = iblocks
            y = y.at[:-1].add(jnp.einsum("eij,ej->ei", H11, x[:-1]))
            y = y.at[:-1].add(jnp.einsum("eij,ej->ei", H12, x[1:]))
            y = y.at[1:].add(jnp.einsum("eji,ej->ei", H12, x[:-1]))
            y = y.at[1:].add(jnp.einsum("eij,ej->ei", H22, x[1:]))
            if Hp_prior is not None:
                y = y.at[prior_idx].add(Hp_prior @ x[prior_idx])
        d = jnp.maximum(jnp.einsum("kii->ki", HppD), 1e-9)
        y = y + lam * d * x
        return jnp.where(fixmask, x, y)

    def pcg(terms, Hll_inv, HppD, iblocks, Hp_prior, b, lam):
        """Solve (S + lam diag) dx = -b by PCG, block-Jacobi precond."""
        d = jnp.einsum("kii->ki", HppD)
        Mb = HppD + lam * jax.vmap(jnp.diag)(jnp.maximum(d, 1e-9)) \
            + 1e-6 * jnp.eye(D, dtype=b.dtype)
        Minv = jnp.linalg.inv(Mb)

        def prec(r_):
            r_ = jnp.where(fixmask, 0.0, r_)
            return jnp.where(fixmask, 0.0,
                             jnp.einsum("kij,kj->ki", Minv, r_))

        b_ = jnp.where(fixmask, 0.0, -b)
        x = jnp.zeros_like(b_)
        r_ = b_
        z = prec(r_)
        p = z
        rz = jnp.sum(r_ * z)

        def body(carry, _):
            x, r_, p, rz = carry
            Ap = matvec(p, terms, Hll_inv, HppD, iblocks, Hp_prior,
                        lam)
            Ap = jnp.where(fixmask, 0.0, Ap)
            pAp = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(pAp) < 1e-20, 1e-20, pAp)
            x = x + alpha * p
            r_n = r_ - alpha * Ap
            z_n = prec(r_n)
            rz_n = jnp.sum(r_n * z_n)
            beta = rz_n / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
            p = z_n + beta * p
            return (x, r_n, p, rz_n), None

        (x, _, _, _), _ = jax.lax.scan(body, (x, r_, p, rz), None,
                                       length=cg_iters)
        return jnp.where(fixmask, 0.0, x)

    def chi2_fn(st, active):
        r, _, _, w, _ = _visual_terms(st, obs, rig, active)
        chi = _psum(jnp.sum(w * jnp.sum(r * r, axis=-1)))
        if D == 15:
            *_, chi_i = _inertial_edge_blocks(st, edges)
            chi = chi + chi_i
            if prior is not None:
                rp, _ = inertial_mod.prior_residual_jac(
                    st.R[prior_idx], st.t[prior_idx], st.v[prior_idx],
                    st.bg[prior_idx], st.ba[prior_idx], prior)
                chi = chi + rp @ (prior.H @ rp)
        return chi

    def backsub(st, terms, Hll_inv, gl, dx_p):
        """dl = Hll^-1 (-gl - Hlp dx_p)."""
        Jp, Jl, w = terms
        yo = jnp.einsum("oai,oi->oa", Jp, gath_kf(dx_p[:, :6]))
        lx = jnp.zeros((M, 3), dx_p.dtype).at[obs.mp].add(
            jnp.einsum("oai,o,oa->oi", Jl, w, yo))
        lx = _psum_l(lx)
        dl = jnp.einsum("mij,mj->mi", Hll_inv, -gl - lx)
        if point_fixed is not None:
            dl = jnp.where(point_fixed[:, None], 0.0, dl)
        return dl

    def lm_stage(st, active, iters):
        def body(carry):
            st, lam, chi, it = carry
            terms, Hll_inv, HppD, iblocks, Hp_prior, b, gl, _ = \
                prepare(st, active, lam)
            dx_p = pcg(terms, Hll_inv, HppD, iblocks, Hp_prior, b,
                       lam)
            dx_l = backsub(st, terms, Hll_inv, gl, dx_p)
            st_new = _retract(st, dx_p.reshape(-1), dx_l, D)
            chi_new = chi2_fn(st_new, active)
            accept = chi_new < chi
            st = jax.tree.map(lambda a, b_: jnp.where(accept, b_, a),
                              st, st_new)
            chi = jnp.where(accept, chi_new, chi)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0),
                           1e-9, 1e6)
            return st, lam, chi, it + 1

        chi0 = chi2_fn(st, active)
        st, _, chi, _ = jax.lax.while_loop(
            lambda c: c[3] < iters, body,
            (st, jnp.asarray(lambda0, jnp.float32), chi0,
             jnp.asarray(0, jnp.int32)))
        return st, chi

    active = active0
    chi = jnp.zeros((), state.t.dtype)
    for iters in stages:
        state, chi = lm_stage(state, active, iters)
        _, _, _, _, chi2 = _visual_terms(state, obs, rig, obs.valid)
        active = obs.valid & (chi2 < chi2_th)
    return state, active, chi
