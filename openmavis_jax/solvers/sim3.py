"""Batched Horn closed-form Sim(3)/SE(3) RANSAC between two keyframes.

JAX replacement for the reference's Sim3Solver (reference:
src/Sim3Solver.cc — 3-point Horn absolute orientation inside RANSAC,
camera-aware reprojection gating; used by loop/merge detection,
src/LoopClosing.cc:812-832).

Hypotheses are a batch axis; the Horn solve (centroids + quaternion from the
cross-covariance) is fully batched; inliers are counted by mutual
reprojection through the two rigs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie


def horn_sim3(p1: jnp.ndarray, p2: jnp.ndarray, fix_scale: bool = False):
    """Closed-form similarity p2 ~ s R p1 + t from paired points.

    p1, p2: [..., P, 3] (P >= 3). Returns (s [...], R [...,3,3], t [...,3]).
    Horn's quaternion method, batched (reference: Sim3Solver::ComputeSim3).
    """
    c1 = jnp.mean(p1, axis=-2, keepdims=True)
    c2 = jnp.mean(p2, axis=-2, keepdims=True)
    q1 = p1 - c1
    q2 = p2 - c2
    M = jnp.einsum("...pi,...pj->...ij", q1, q2)      # cross-covariance
    # build the 4x4 N matrix of Horn's method
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack([
        jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
                  axis=-1),
        jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
                  axis=-1),
        jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
                  axis=-1),
        jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
                  axis=-1),
    ], axis=-2)
    _, V = jnp.linalg.eigh(N)
    q = V[..., :, -1]                                  # largest eigenvalue
    R = lie.quat_to_rotmat(q)                          # wxyz order matches

    rot_q1 = jnp.einsum("...ij,...pj->...pi", R, q1)
    if fix_scale:
        s = jnp.ones(p1.shape[:-2], p1.dtype)
    else:
        num = jnp.sum(q2 * rot_q1, axis=(-1, -2))
        den = jnp.sum(rot_q1 * rot_q1, axis=(-1, -2))
        s = num / jnp.maximum(den, 1e-12)
    t = c2[..., 0, :] - s[..., None] * jnp.einsum(
        "...ij,...j->...i", R, c1[..., 0, :])
    return s, R, t


class Sim3Result(NamedTuple):
    success: jnp.ndarray
    s: jnp.ndarray
    R: jnp.ndarray        # frame2-from-frame1
    t: jnp.ndarray
    inlier: jnp.ndarray   # [N]
    n_inliers: jnp.ndarray


def ransac_sim3(key, p1: jnp.ndarray, p2: jnp.ndarray, valid: jnp.ndarray,
                fix_scale: bool = False, n_hyp: int = 128,
                inlier_th: float = 0.05, min_inliers: int = 20,
                relative_th: bool = True) -> Sim3Result:
    """RANSAC Sim3 from matched 3D points (camera/body frames of two KFs).

    Args:
      p1, p2: [N, 3] matched map points expressed in the two keyframes.
      inlier_th: inlier gate; if `relative_th`, it multiplies each point's
        distance (scale-aware: 5% of range), else metres.
    The reference gates by *reprojection* through each camera
    (Sim3Solver::CheckInliers); the 3D-range-relative gate here is its
    geometry-space analog and keeps the solver camera-agnostic — projection
    verification happens in the caller (loop-closing), as in the reference's
    subsequent SearchByProjection step.
    """
    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.random.categorical(key, logits[None, None, :],
                                 shape=(n_hyp, 3))
    s, R, t = horn_sim3(p1[idx], p2[idx], fix_scale=fix_scale)

    pred = s[:, None, None] * jnp.einsum("sij,nj->sni", R, p1) + t[:, None, :]
    err = jnp.linalg.norm(pred - p2[None], axis=-1)    # [S, N]
    if relative_th:
        gate = inlier_th * jnp.maximum(
            jnp.linalg.norm(p2, axis=-1), 1.0)[None, :]
    else:
        gate = inlier_th
    inl = (err < gate) & valid[None, :]
    # reject degenerate scales and bad samples
    bad = (jnp.any(~valid[idx], axis=-1) | (s < 0.1) | (s > 10.0))
    n_inl = jnp.where(bad, 0, jnp.sum(inl.astype(jnp.int32), axis=1))
    best = jnp.argmax(n_inl)

    # refine on the best hypothesis' inliers (weighted full-set Horn)
    w = inl[best].astype(p1.dtype)[:, None]
    cnt = jnp.maximum(jnp.sum(w), 3.0)
    # weighted Horn: subtract weighted centroids
    c1 = jnp.sum(p1 * w, axis=0) / cnt
    c2 = jnp.sum(p2 * w, axis=0) / cnt
    s_r, R_r, t_r = horn_sim3((p1 - c1) * w + c1, (p2 - c2) * w + c2,
                              fix_scale=fix_scale)
    refined_ok = jnp.isfinite(s_r) & (s_r > 0.1) & (s_r < 10.0)
    s_f = jnp.where(refined_ok, s_r, s[best])
    R_f = jnp.where(refined_ok, R_r, R[best])
    t_f = jnp.where(refined_ok, t_r, t[best])
    return Sim3Result(success=n_inl[best] >= min_inliers,
                      s=s_f, R=R_f, t=t_f, inlier=inl[best],
                      n_inliers=n_inl[best])


def ransac_sim3_reproj(key, pairs, rig_kind: int, rig,
                       fix_scale: bool = False, n_hyp: int = 128,
                       chi2_th: float = 9.21,
                       min_inliers: int = 20) -> Sim3Result:
    """Sim3 RANSAC with the reference's REPROJECTION inlier test.

    The 3D-distance gate of `ransac_sim3` collapses once the two keyframes'
    local maps carry real drift (internally distorted geometry): measured
    2-3 inliers of 20+ true correspondences on drifted loops. The
    reference gates by mutual reprojection instead (Sim3Solver::
    CheckInliers, src/Sim3Solver.cc: project the mapped points through
    BOTH cameras and chi2-test the pixel errors), which only requires the
    hypothesis to explain the IMAGES, not two noisy 3D clouds.

    pairs: loop_closing.MatchedPairs (body-frame points, image
    observations, per-point sigma2, camera bands of both keyframes).
    Returns Sim3Result with the Sim3 body(a) -> body(b).
    """
    from ..geometry import cameras

    p1, p2, valid = pairs.p_a, pairs.p_b, pairs.valid
    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.random.categorical(key, logits[None, None, :],
                                 shape=(n_hyp, 3))
    s, R, t = horn_sim3(p1[idx], p2[idx], fix_scale=fix_scale)

    C = rig.params.shape[0]
    cam_a = jnp.clip(pairs.cam_a, 0, C - 1)
    cam_b = jnp.clip(pairs.cam_b, 0, C - 1)

    def reproj_chi2(s, R, t):
        """[S] hypotheses -> [S, N] mutual reprojection chi2."""
        # a -> b: project s R p1 + t into b's camera band
        pb = (s[:, None, None]
              * jnp.einsum("sij,nj->sni", R, p1) + t[:, None, :])
        pcb = (jnp.einsum("nij,snj->sni", rig.R_cb[cam_b], pb)
               + rig.t_cb[cam_b][None])
        uvb = cameras.project(rig_kind, rig.params[cam_b][None], pcb)
        e_b = jnp.sum((uvb - pairs.uv_b[None]) ** 2, axis=-1) \
            / pairs.sigma2_b[None]
        ok_b = pcb[..., 2] > 0.05
        # b -> a: inverse hypothesis into a's camera band
        pa = jnp.einsum("sji,snj->sni", R,
                        p2[None] - t[:, None, :]) / s[:, None, None]
        pca = (jnp.einsum("nij,snj->sni", rig.R_cb[cam_a], pa)
               + rig.t_cb[cam_a][None])
        uva = cameras.project(rig_kind, rig.params[cam_a][None], pca)
        e_a = jnp.sum((uva - pairs.uv_a[None]) ** 2, axis=-1) \
            / pairs.sigma2_a[None]
        ok_a = pca[..., 2] > 0.05
        chi = jnp.maximum(e_a, e_b)
        return jnp.where(ok_a & ok_b, chi, jnp.inf)

    chi = reproj_chi2(s, R, t)
    inl = (chi < chi2_th) & valid[None, :]
    bad = (jnp.any(~valid[idx], axis=-1) | (s < 0.1) | (s > 10.0)
           | ~jnp.isfinite(s))
    n_inl = jnp.where(bad, 0, jnp.sum(inl.astype(jnp.int32), axis=1))
    best = jnp.argmax(n_inl)

    # weighted full-set Horn refit on the winner's inliers
    w = inl[best].astype(p1.dtype)[:, None]
    cnt = jnp.maximum(jnp.sum(w), 3.0)
    c1 = jnp.sum(p1 * w, axis=0) / cnt
    c2 = jnp.sum(p2 * w, axis=0) / cnt
    s_r, R_r, t_r = horn_sim3((p1 - c1) * w + c1, (p2 - c2) * w + c2,
                              fix_scale=fix_scale)
    chi_r = reproj_chi2(s_r[None], R_r[None], t_r[None])[0]
    inl_r = (chi_r < chi2_th) & valid
    n_r = jnp.sum(inl_r.astype(jnp.int32))
    take = (n_r >= n_inl[best]) & jnp.isfinite(s_r) \
        & (s_r > 0.1) & (s_r < 10.0)
    s_f = jnp.where(take, s_r, s[best])
    R_f = jnp.where(take, R_r, R[best])
    t_f = jnp.where(take, t_r, t[best])
    inl_f = jnp.where(take, inl_r, inl[best])
    n_f = jnp.where(take, n_r, n_inl[best])
    return Sim3Result(success=n_f >= min_inliers, s=s_f, R=R_f, t=t_f,
                      inlier=inl_f, n_inliers=n_f)
