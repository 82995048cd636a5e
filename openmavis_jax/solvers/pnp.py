"""Batched RANSAC PnP for relocalization — MLPnP nullspace formulation.

JAX equivalent of the reference's MLPnPsolver (reference:
src/MLPnPsolver.cpp:15, Urban et al. "MLPnP", used only by
Tracking::Relocalization, src/Tracking.cc:3564-3593): hypotheses are a
batch axis; each hypothesis is a 6+ point linear resection built from the
**nullspace constraints of each bearing** (r_i^T (R p_i + t) = 0 and
s_i^T (R p_i + t) = 0, where [r_i, s_i] is an orthonormal basis of the
bearing's tangent plane — the defining construction of MLPnP), scored by
bearing-space reprojection against all correspondences, with
maximum-likelihood per-point covariance weighting in the LO refit. The
winner is refined by the motion-only LM pose optimizer downstream.

Why nullspace rows and not cross-product rows: the classical DLT
constraint `bearing x (R p + t) = 0` has row magnitudes proportional to
the bearing's axis components, so strongly off-axis bearings (fisheye
edges, exactly where relocalization must work on the flagship KB8 rig)
contribute ill-scaled, near-rank-1 rows. The tangent-basis rows are
orthonormal for EVERY bearing direction — uniformly conditioned over the
full sphere.

Works on bearing vectors, so it covers pinhole and fisheye alike (the
same property MLPnP is chosen for in the reference).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie


def bearing_nullspace(bearing: jnp.ndarray):
    """Orthonormal tangent basis (r, s) of each unit bearing [..., 3]
    (MLPnP's per-observation nullspace J = null(v^T),
    src/MLPnPsolver.cpp:15). Branchless seed-axis selection keeps the
    basis well-defined for every direction."""
    v = bearing
    near_z = jnp.abs(v[..., 2]) > 0.9
    seed = jnp.where(near_z[..., None],
                     jnp.asarray([1.0, 0.0, 0.0], v.dtype),
                     jnp.asarray([0.0, 0.0, 1.0], v.dtype))
    r = jnp.cross(v, seed)
    r = r / jnp.maximum(jnp.linalg.norm(r, axis=-1, keepdims=True), 1e-9)
    s = jnp.cross(v, r)
    return r, s


def _dlt_pose(p_w: jnp.ndarray, bearing: jnp.ndarray, w=None,
              formulation: str = "nullspace"):
    """Linear 6+ point resection, batched over hypotheses.

    p_w: [..., P, 3] world points; bearing: [..., P, 3] unit bearings in the
    camera frame. Solves for P = [R|t] (camera-from-world) up to scale.
    `formulation`: "nullspace" (MLPnP tangent-basis rows, uniformly
    conditioned over the sphere — the default) or "cross" (classical
    cross-product DLT rows; kept for comparison/tests).
    `w` ([..., P], optional) weights each point's constraint rows — used by
    the LO-RANSAC refit to solve over an inlier subset without gathers.
    Returns (R [...,3,3], t [...,3]).
    """
    pw_h = jnp.concatenate([p_w, jnp.ones_like(p_w[..., :1])], axis=-1)
    if formulation == "nullspace":
        rb, sb = bearing_nullspace(bearing)
        r1 = jnp.concatenate([rb[..., 0:1] * pw_h, rb[..., 1:2] * pw_h,
                              rb[..., 2:3] * pw_h], axis=-1)  # [...,P,12]
        r2 = jnp.concatenate([sb[..., 0:1] * pw_h, sb[..., 1:2] * pw_h,
                              sb[..., 2:3] * pw_h], axis=-1)
    else:
        x, y, z = bearing[..., 0], bearing[..., 1], bearing[..., 2]
        zero = jnp.zeros_like(pw_h)
        r1 = jnp.concatenate(
            [zero, -z[..., None] * pw_h, y[..., None] * pw_h], axis=-1)
        r2 = jnp.concatenate(
            [z[..., None] * pw_h, zero, -x[..., None] * pw_h], axis=-1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    A = jnp.concatenate([r1, r2], axis=-2)            # [..., 2P, 12]
    AtA = jnp.swapaxes(A, -1, -2) @ A
    _, V = jnp.linalg.eigh(AtA)
    sol = V[..., :, 0]
    P = sol.reshape(*sol.shape[:-1], 3, 4)

    def polar(P):
        """Project [R|t] (up to positive scale) onto SE(3)."""
        Rraw = P[..., :3]
        t = P[..., 3]
        U, s, Vt = jnp.linalg.svd(Rraw)
        det = jnp.linalg.det(U @ Vt)
        D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det],
                      axis=-1)
        R = U @ (D[..., None] * Vt)
        # scale s.t. Rraw ~ scale * R: scale = trace(R^T Rraw)/3
        scale = jnp.sum(s * D, axis=-1) / 3.0
        t = t / jnp.where(jnp.abs(scale) < 1e-9, 1e-9, scale)[..., None]
        return R, t

    # the DLT solution has an arbitrary global sign; pick the one putting
    # the sample points in front of the camera (by majority depth vote)
    Rp, tp = polar(P)
    Rn, tn = polar(-P)
    zp = (jnp.einsum("...ij,...pj->...pi", Rp, p_w) + tp[..., None, :])[..., 2]
    cnt = (jnp.ones_like(zp) if w is None
           else (w > 0).astype(zp.dtype))
    pos = jnp.sum((zp > 0).astype(zp.dtype) * cnt, axis=-1)
    use_p = (pos * 2 >= jnp.sum(cnt, axis=-1))[..., None, None]
    R = jnp.where(use_p, Rp, Rn)
    t = jnp.where(use_p[..., 0], tp, tn)
    return R, t


class PnPResult(NamedTuple):
    success: jnp.ndarray
    R_cw: jnp.ndarray     # [3,3] camera-from-world
    t_cw: jnp.ndarray     # [3]
    inlier: jnp.ndarray   # [N]
    n_inliers: jnp.ndarray


def _gate(R, t, p_w, bearing, valid, cos_th):
    """Inlier mask + count for a single pose (or leading batch of poses)."""
    pred = jnp.einsum("...ij,nj->...ni", R, p_w) + t[..., None, :]
    pred = pred / jnp.maximum(
        jnp.linalg.norm(pred, axis=-1, keepdims=True), 1e-9)
    cosang = jnp.einsum("...ni,ni->...n", pred, bearing)
    inl = (cosang > cos_th) & valid
    return inl, jnp.sum(inl.astype(jnp.int32), axis=-1)


def ransac_pnp(key, p_w: jnp.ndarray, bearing: jnp.ndarray,
               valid: jnp.ndarray, n_hyp: int = 512,
               sample_size: int = 6, cos_th: float = 0.9998,
               min_inliers: int = 12, lo_rounds: int = 2,
               sigma2=None, formulation: str = "nullspace") -> PnPResult:
    """LO-RANSAC resection from 3D-point <-> bearing matches.

    Args:
      p_w: [N, 3]; bearing: [N, 3] unit camera-frame bearings; valid: [N].
      cos_th: inlier gate on the angle between observed and predicted
        bearings (0.9998 ~ 1.15 deg ~ a few pixels at f=400).
      lo_rounds: local-optimization rounds — the best hypothesis is refit
        by a weighted DLT over ALL its inliers and re-gated, which rescues
        minimal samples that are near-degenerate (clustered scenes) and
        makes success nearly key-independent.
      sigma2: optional [N] per-observation variance (keypoint pyramid-
        level sigma^2). Enables the MAXIMUM-LIKELIHOOD weighting of the
        reference's MLPnPsolver (src/MLPnPsolver.cpp: bearing residuals
        whitened by per-point covariance): the LO refit weights each
        point's constraint rows by 1/sigma, and the inlier gate widens
        with sigma (coarse-level keypoints carry proportionally larger
        angular noise).
    """
    if sigma2 is not None:
        sig = jnp.sqrt(jnp.maximum(sigma2, 1e-9))
        # per-point angular gate: theta_i = theta_0 * sigma_i (capped —
        # coarse levels are noisier, not unbounded)
        import numpy as _np
        th0 = float(_np.arccos(min(cos_th, 1.0)))
        cos_th = jnp.cos(th0 * jnp.clip(sig, 1.0, 4.0))
        ml_w = 1.0 / sig
    else:
        ml_w = None

    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.random.categorical(key, logits[None, None, :],
                                 shape=(n_hyp, sample_size))
    R, t = _dlt_pose(p_w[idx], bearing[idx], formulation=formulation)

    inl, n_inl = _gate(R, t, p_w, bearing, valid[None, :], cos_th)
    # invalidate hypotheses drawn from invalid samples
    bad = jnp.any(~valid[idx], axis=-1)
    n_inl = jnp.where(bad, 0, n_inl)
    best = jnp.argmax(n_inl)
    R_b, t_b = R[best], t[best]
    inl_b, n_b = inl[best], n_inl[best]

    for _ in range(lo_rounds):
        w = inl_b.astype(p_w.dtype)
        if ml_w is not None:
            w = w * ml_w
        R_r, t_r = _dlt_pose(p_w, bearing, w=w, formulation=formulation)
        inl_r, n_r = _gate(R_r, t_r, p_w, bearing, valid, cos_th)
        # >=: at equal support the all-inlier (whitened) refit dominates
        # a 6-point minimal sample
        take = n_r >= n_b
        R_b = jnp.where(take, R_r, R_b)
        t_b = jnp.where(take, t_r, t_b)
        inl_b = jnp.where(take, inl_r, inl_b)
        n_b = jnp.where(take, n_r, n_b)

    return PnPResult(success=n_b >= min_inliers,
                     R_cw=R_b, t_cw=t_b, inlier=inl_b, n_inliers=n_b)
