"""Batched two-view reconstruction for monocular initialization.

JAX replacement for the reference's TwoViewReconstruction
(reference: src/TwoViewReconstruction.cc — 200-hypothesis RANSAC of a
homography and a fundamental matrix in two std::threads, model selection by
score ratio, motion recovery + triangulation + cheirality checks).

Idiom shift (SURVEY.md §7.0): RANSAC hypotheses are a batch axis. All
hypotheses are solved with one batched eigendecomposition, scored against
all correspondences with one [S, N] kernel, and the winner is selected with
an argmax — seeded, deterministic, no threads.

Correspondences are given as *normalized camera coordinates* (z=1 plane),
i.e. already undistorted/unprojected; `focal` converts normalized residuals
to pixel units so the chi2 thresholds match the reference's pixel-domain
gating.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie


def _smallest_eigvec(AtA: jnp.ndarray) -> jnp.ndarray:
    """[..., 9, 9] symmetric -> [..., 9] eigenvector of smallest eigenvalue."""
    _, V = jnp.linalg.eigh(AtA)
    return V[..., :, 0]


def essential_from_8pt(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """8-point algorithm, batched over hypothesis sets.

    x1, x2: [..., 8, 2] normalized coords. Returns E [..., 3, 3] with
    enforced (1, 1, 0) singular values.
    """
    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], axis=-1)
    p2 = jnp.concatenate([x2, ones], axis=-1)
    # row = kron(p2, p1): x2^T E x1 = 0
    A = (p2[..., :, None] * p1[..., None, :]).reshape(*x1.shape[:-2], 8, 9)
    e = _smallest_eigvec(jnp.swapaxes(A, -1, -2) @ A)
    E = e.reshape(*e.shape[:-1], 3, 3)
    U, s, Vt = jnp.linalg.svd(E)
    s_fix = jnp.stack([jnp.ones_like(s[..., 0]), jnp.ones_like(s[..., 0]),
                       jnp.zeros_like(s[..., 0])], axis=-1)
    return U @ (s_fix[..., None] * Vt)


def epipolar_score(E: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray,
                   focal: float, sigma: float = 1.0):
    """Symmetric epipolar-distance score (reference: CheckFundamental).

    E: [S, 3, 3]; x1, x2: [N, 2]. Returns (score [S], inlier [S, N]).
    Per-point contribution = (th - d^2/sigma^2) when d^2/sigma^2 < th
    with th = 3.84 (1 dof), matching the reference's scoring."""
    ones = jnp.ones((x1.shape[0], 1), x1.dtype)
    p1 = jnp.concatenate([x1, ones], axis=-1)   # [N, 3]
    p2 = jnp.concatenate([x2, ones], axis=-1)
    l2 = jnp.einsum("sij,nj->sni", E, p1)        # epiline in image 2
    l1 = jnp.einsum("sji,nj->sni", E, p2)        # epiline in image 1
    num = jnp.einsum("ni,sni->sn", p2, l2)       # [S, N]
    f2 = focal * focal
    d2_2 = num ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12) * f2
    d2_1 = num ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12) * f2
    s2 = sigma * sigma
    th, th_score = 3.841, 5.991
    c1 = jnp.where(d2_1 / s2 < th, th_score - d2_1 / s2, 0.0)
    c2 = jnp.where(d2_2 / s2 < th, th_score - d2_2 / s2, 0.0)
    inlier = (d2_1 / s2 < th) & (d2_2 / s2 < th)
    return jnp.sum(c1 + c2, axis=-1), inlier


def homography_from_4pt(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """4-point DLT homography, batched over hypothesis sets.

    x1, x2: [..., 4, 2] normalized coords. Returns H [..., 3, 3] with
    x2 ~ H x1 (reference: TwoViewReconstruction::ComputeH21).
    """
    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], axis=-1)           # [..., 4, 3]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = jnp.zeros_like(p1)
    # rows: [-p1, 0, u2*p1] and [0, -p1, v2*p1]
    r1 = jnp.concatenate([-p1, z, u2[..., None] * p1], axis=-1)
    r2 = jnp.concatenate([z, -p1, v2[..., None] * p1], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)              # [..., 8, 9]
    h = _smallest_eigvec(jnp.swapaxes(A, -1, -2) @ A)
    return h.reshape(*h.shape[:-1], 3, 3)


def homography_score(H: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray,
                     focal: float, sigma: float = 1.0):
    """Symmetric transfer-error score (reference: CheckHomography).

    H: [S, 3, 3]; x1, x2: [N, 2]. th = 5.991 (2 dof) both directions.
    """
    ones = jnp.ones((x1.shape[0], 1), x1.dtype)
    p1 = jnp.concatenate([x1, ones], axis=-1)
    p2 = jnp.concatenate([x2, ones], axis=-1)
    Hinv = jnp.linalg.inv(H + 1e-12 * jnp.eye(3, dtype=H.dtype))
    q2 = jnp.einsum("sij,nj->sni", H, p1)               # x1 -> image 2
    q1 = jnp.einsum("sij,nj->sni", Hinv, p2)            # x2 -> image 1
    f2 = focal * focal
    d2_2 = jnp.sum((q2[..., :2] / jnp.maximum(jnp.abs(q2[..., 2:]), 1e-9)
                    * jnp.sign(q2[..., 2:]) - x2[None]) ** 2, -1) * f2
    d2_1 = jnp.sum((q1[..., :2] / jnp.maximum(jnp.abs(q1[..., 2:]), 1e-9)
                    * jnp.sign(q1[..., 2:]) - x1[None]) ** 2, -1) * f2
    s2 = sigma * sigma
    th = 5.991
    c1 = jnp.where(d2_1 / s2 < th, th - d2_1 / s2, 0.0)
    c2 = jnp.where(d2_2 / s2 < th, th - d2_2 / s2, 0.0)
    inlier = (d2_1 / s2 < th) & (d2_2 / s2 < th)
    return jnp.sum(c1 + c2, axis=-1), inlier


def decompose_H(H: jnp.ndarray):
    """Faugeras decomposition: H [3,3] -> 8 candidate (R [8,3,3], t [8,3]).

    (reference: TwoViewReconstruction::ReconstructH — SVD-based Faugeras
    SVD 8-motion enumeration; t is returned unit-norm like the E path.)
    """
    U, d, Vt = jnp.linalg.svd(H)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) / denom, 0.0, None))
    aux3 = jnp.sqrt(jnp.clip((d2 * d2 - d3 * d3) / denom, 0.0, None))
    x1v = jnp.asarray([aux1, aux1, -aux1, -aux1])
    x3v = jnp.asarray([aux3, -aux3, aux3, -aux3])

    Rs, ts = [], []
    # case d' = +d2
    aux_st = jnp.sqrt(jnp.clip(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0, None)) \
        / jnp.maximum((d1 + d3) * d2, 1e-12)
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    st_signs = jnp.asarray([1.0, -1.0, -1.0, 1.0])
    for i in range(4):
        st = st_signs[i] * aux_st
        Rp = jnp.asarray([[1.0, 0.0, 0.0],
                          [0.0, 1.0, 0.0],
                          [0.0, 0.0, 1.0]], H.dtype)
        Rp = Rp.at[0, 0].set(ct).at[0, 2].set(-st) \
            .at[2, 0].set(st).at[2, 2].set(ct)
        tp = jnp.asarray([x1v[i], 0.0, -x3v[i]]) * (d1 - d3)
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    # case d' = -d2
    aux_sp = jnp.sqrt(jnp.clip(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0, None)) \
        / jnp.maximum((d1 - d3) * d2, 1e-12)
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    for i in range(4):
        sp = st_signs[i] * aux_sp
        Rp = jnp.asarray([[1.0, 0.0, 0.0],
                          [0.0, -1.0, 0.0],
                          [0.0, 0.0, -1.0]], H.dtype)
        Rp = Rp.at[0, 0].set(cp).at[0, 2].set(sp) \
            .at[2, 0].set(sp).at[2, 2].set(-cp)
        tp = jnp.asarray([x1v[i], 0.0, x3v[i]]) * (d1 + d3)
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    Rs = jnp.stack(Rs)
    ts = jnp.stack(ts)
    tn = jnp.linalg.norm(ts, axis=-1, keepdims=True)
    return Rs, ts / jnp.maximum(tn, 1e-12)


def decompose_E(E: jnp.ndarray):
    """E [3,3] -> 4 candidate (R [4,3,3], t [4,3]) with unit-norm t."""
    U, _, Vt = jnp.linalg.svd(E)
    # ensure proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))[..., None]
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                    dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _triangulate_and_check(R, t, x1, x2, focal, sigma: float,
                           min_parallax_cos: float = 0.99998):
    """Triangulate all N correspondences under relative pose (R, t) of
    camera2-from-camera1 (x2 = R x1 + t convention: p_c2 = R p_c1 + t).

    Returns (points_c1 [N,3], good [N], n_good, median_parallax_ok).
    (reference: TwoViewReconstruction::CheckRT)
    """
    ones = jnp.ones((x1.shape[0], 1), x1.dtype)
    d1 = jnp.concatenate([x1, ones], axis=-1)
    d1 = d1 / jnp.linalg.norm(d1, axis=-1, keepdims=True)
    d2c2 = jnp.concatenate([x2, ones], axis=-1)
    d2c2 = d2c2 / jnp.linalg.norm(d2c2, axis=-1, keepdims=True)
    # camera-2 center in camera-1 frame: c2 = -R^T t; ray2 dir in c1: R^T d2
    o2 = -jnp.einsum("ji,j->i", R, t)
    d2 = jnp.einsum("ji,nj->ni", R, d2c2)

    b = jnp.sum(d1 * d2, axis=-1)
    denom = jnp.maximum(1.0 - b * b, 1e-9)
    # closest-point depths: midpoint formulas with o1 = 0
    a1 = jnp.einsum("ni,i->n", d1, o2)
    a2 = jnp.einsum("ni,i->n", d2, o2)
    s1 = (a1 - b * a2) / denom
    s2 = (b * a1 - a2) / denom
    p1c = 0.5 * (s1[:, None] * d1 + o2 + s2[:, None] * d2)

    z1 = p1c[:, 2]
    p2c = jnp.einsum("ij,nj->ni", R, p1c) + t
    z2 = p2c[:, 2]
    # reprojection errors in pixels
    e1 = (p1c[:, :2] / jnp.maximum(z1[:, None], 1e-9) - x1) * focal
    e2 = (p2c[:, :2] / jnp.maximum(z2[:, None], 1e-9) - x2) * focal
    err_ok = ((jnp.sum(e1 ** 2, axis=-1) < 4 * sigma * sigma)
              & (jnp.sum(e2 ** 2, axis=-1) < 4 * sigma * sigma))
    cos_par = b
    good = (z1 > 0) & (z2 > 0) & err_ok & (s1 > 0) & (s2 > 0)
    good_par = good & (cos_par < min_parallax_cos)
    return p1c, good_par, jnp.sum(good_par.astype(jnp.int32)), cos_par


class TwoViewResult(NamedTuple):
    success: jnp.ndarray    # [] bool
    R: jnp.ndarray          # [3,3] camera2-from-camera1
    t: jnp.ndarray          # [3] unit baseline
    points: jnp.ndarray     # [N,3] in camera-1 frame
    is_good: jnp.ndarray    # [N] triangulated + checked


def reconstruct(key, x1: jnp.ndarray, x2: jnp.ndarray, valid: jnp.ndarray,
                focal: float, sigma: float = 1.0, n_hyp: int = 256,
                min_inliers: int = 50,
                min_triangulated_frac: float = 0.5,
                use_homography: bool = True) -> TwoViewResult:
    """Full monocular two-view initialization: parallel E + H RANSAC with
    model selection by score ratio.

    Args:
      key: PRNG key (determinism: same key -> same result).
      x1, x2: [N, 2] matched normalized coordinates; valid [N].
    (reference: TwoViewReconstruction::Reconstruct — FindHomography and
    FindFundamental in two threads, RH = SH/(SH+SF) > 0.5 selects the
    homography, then ReconstructH/ReconstructF,
    src/TwoViewReconstruction.cc:48-120. The two thread bodies become two
    batched RANSACs on one device; selection is a where().)
    """
    n = x1.shape[0]
    key_e, key_h = jax.random.split(key)
    # sample 8-point subsets among valid correspondences: draw from a
    # weighted categorical (invalid get ~zero probability)
    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.random.categorical(key_e, logits[None, None, :],
                                 shape=(n_hyp, 8))
    E = essential_from_8pt(x1[idx], x2[idx])
    score, inl = epipolar_score(E, x1, x2, focal, sigma)
    score = score - jnp.where(jnp.any(~valid[idx], axis=-1), 1e9, 0.0)
    # only count valid correspondences
    inl = inl & valid[None, :]
    best = jnp.argmax(score)
    inlier = inl[best]

    # refine: weighted 8-point over the full consensus set (rows of the
    # DLT system scaled by the inlier mask), then re-gate
    w = inlier.astype(x1.dtype)
    ones = jnp.ones_like(x1[..., :1])
    p1h = jnp.concatenate([x1, ones], axis=-1)
    p2h = jnp.concatenate([x2, ones], axis=-1)
    A = (p2h[:, :, None] * p1h[:, None, :]).reshape(n, 9) * w[:, None]
    e = _smallest_eigvec(A.T @ A)
    E_ref = e.reshape(3, 3)
    U, s, Vt = jnp.linalg.svd(E_ref)
    s_fix = jnp.asarray([1.0, 1.0, 0.0], dtype=E_ref.dtype)
    E_ref = U @ (s_fix[:, None] * Vt)
    sc_ref, inl_ref = epipolar_score(E_ref[None], x1, x2, focal, sigma)
    use_ref = sc_ref[0] >= score[best]
    E_best = jnp.where(use_ref, E_ref, E[best])
    inlier_e = jnp.where(use_ref, inl_ref[0] & valid, inlier)
    score_e = jnp.maximum(sc_ref[0], score[best])

    Rs_e, ts_e = decompose_E(E_best)

    if use_homography:
        # --- homography branch ---
        idx4 = jax.random.categorical(key_h, logits[None, None, :],
                                      shape=(n_hyp, 4))
        H = homography_from_4pt(x1[idx4], x2[idx4])
        score_h_all, inl_h = homography_score(H, x1, x2, focal, sigma)
        score_h_all = score_h_all - jnp.where(
            jnp.any(~valid[idx4], axis=-1), 1e9, 0.0)
        inl_h = inl_h & valid[None, :]
        best_h = jnp.argmax(score_h_all)
        inlier_h = inl_h[best_h]
        score_h = score_h_all[best_h]
        Rs_h, ts_h = decompose_H(H[best_h])

        # model selection (reference: RH = SH/(SH+SF), H if RH > 0.50)
        ratio = score_h / jnp.maximum(score_h + score_e, 1e-9)
        use_h = ratio > 0.50

        inlier = jnp.where(use_h, inlier_h, inlier_e)
        Rs = jnp.concatenate([Rs_e, Rs_h])
        ts = jnp.concatenate([ts_e, ts_h])
        model_mask = jnp.concatenate([
            jnp.full((4,), ~use_h), jnp.full((8,), use_h)])
        # H's 8 motions contain near-duplicates; reference requires a
        # clearer winner there (0.75 vs 0.9 second-best gate)
        second_gate = jnp.where(use_h, 0.75, 0.9)
    else:
        inlier = inlier_e
        Rs, ts = Rs_e, ts_e
        model_mask = jnp.ones((4,), bool)
        second_gate = jnp.asarray(0.9)

    outs = jax.vmap(lambda R, t: _triangulate_and_check(
        R, t, x1, x2, focal, sigma))(Rs, ts)
    pts_all, good_all, _, _ = outs
    n_good = jnp.sum((good_all & inlier[None, :]).astype(jnp.int32), axis=1)
    n_good = jnp.where(model_mask, n_good, -1)
    k = jnp.argmax(n_good)
    n_best = n_good[k]
    n_second = jnp.sort(n_good)[-2]
    n_inl = jnp.sum(inlier.astype(jnp.int32))

    success = ((n_best >= min_inliers)
               & (n_best.astype(jnp.float32)
                  > min_triangulated_frac * n_inl.astype(jnp.float32))
               & (n_second.astype(jnp.float32)
                  < second_gate * n_best.astype(jnp.float32)))
    return TwoViewResult(success=success, R=Rs[k], t=ts[k],
                         points=pts_all[k],
                         is_good=good_all[k] & inlier)
