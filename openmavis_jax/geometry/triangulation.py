"""Batched triangulation: DLT and checked two-ray midpoint triangulation.

JAX replacement for the reference's GeometricTools::Triangulate
(src/GeometricTools.cc) and KannalaBrandt8::TriangulateMatches
(src/CameraModels/KannalaBrandt8.cpp — parallax + reprojection-checked
triangulation used for stereo-fisheye match validation, see
Frame::ComputeMultiFishEyeMatches src/Frame.cc:1461-1527).

Everything is batched over a leading match axis and returns validity masks
instead of early-exits.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import cameras
from .lie import se3_apply


def triangulate_dlt(P1: jnp.ndarray, P2: jnp.ndarray,
                    x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """DLT triangulation from two 3x4 projection matrices.

    Args:
      P1, P2: [..., 3, 4] projection matrices mapping homogeneous world
        points to normalized image coordinates (z=1 plane).
      x1, x2: [..., 2] normalized image coordinates.

    Returns [..., 3] world points (reference: GeometricTools.cc DLT).
    """
    A = jnp.stack(
        [
            x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        axis=-2,
    )  # [..., 4, 4]
    # Smallest right singular vector of A. Use A^T A eigendecomposition:
    # symmetric 4x4 — eigh is batched and differentiable.
    AtA = jnp.swapaxes(A, -1, -2) @ A
    _, V = jnp.linalg.eigh(AtA)
    X = V[..., :, 0]  # eigenvector of smallest eigenvalue
    w = X[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]


def triangulate_rays_midpoint(o1, d1, o2, d2):
    """Closed-form midpoint of the common perpendicular of two rays.

    Args:
      o1, o2: [..., 3] ray origins; d1, d2: [..., 3] unit directions.
    Returns:
      (point [..., 3], s1 [...], s2 [...]) where s_i are the depths along
      each ray of the closest points.
    """
    b = jnp.sum(d1 * d2, axis=-1)
    denom = 1.0 - b * b
    denom = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
    do = o2 - o1
    a1 = jnp.sum(do * d1, axis=-1)
    a2 = jnp.sum(do * d2, axis=-1)
    s1 = (a1 - b * a2) / denom
    s2 = (b * a1 - a2) / denom
    p1 = o1 + s1[..., None] * d1
    p2 = o2 + s2[..., None] * d2
    return 0.5 * (p1 + p2), s1, s2


def triangulate_matches(kind: int, params1, params2, R12, t12, uv1, uv2,
                        sigma_level1=None, sigma_level2=None,
                        min_cos_parallax: float = 0.9998,
                        reproj_chi2: float = 5.991):
    """Checked triangulation of matched pixels between two cameras of a rig.

    Equivalent of KannalaBrandt8::TriangulateMatches: unproject both pixels,
    triangulate in camera-1 frame, then gate on parallax, cheirality and
    reprojection error in both images.

    Args:
      kind: camera model kind (static).
      params1, params2: [..., 8] intrinsics of the two cameras.
      R12, t12: pose of camera 2 in camera 1 frame ([...,3,3], [...,3]):
        p_c1 = R12 @ p_c2 + t12.
      uv1, uv2: [..., 2] matched pixels.
      sigma_level1/2: [...] per-keypoint sigma^2 scale (pyramid level
        variance); defaults to 1.
    Returns:
      (points_c1 [..., 3], depth1 [...], valid [...] bool)
    """
    r1 = cameras.unproject(kind, params1, uv1)          # bearing in c1
    r2c2 = cameras.unproject(kind, params2, uv2)        # bearing in c2
    r2 = jnp.einsum("...ij,...j->...i", R12, r2c2)      # in c1 frame
    o1 = jnp.zeros_like(t12)
    o2 = t12

    cos_par = jnp.sum(r1 * r2, axis=-1)
    p, s1, s2 = triangulate_rays_midpoint(o1, r1, o2, r2)

    # reprojection checks
    uv1_hat = cameras.project(kind, params1, p)
    # express p in camera-2 frame: p_c2 = R12^T (p - t12)
    p_c2 = jnp.einsum("...ji,...j->...i", R12, p - t12)
    uv2_hat = cameras.project(kind, params2, p_c2)
    e1 = jnp.sum((uv1_hat - uv1) ** 2, axis=-1)
    e2 = jnp.sum((uv2_hat - uv2) ** 2, axis=-1)
    s1v = jnp.ones_like(e1) if sigma_level1 is None else sigma_level1
    s2v = jnp.ones_like(e2) if sigma_level2 is None else sigma_level2

    valid = ((cos_par < min_cos_parallax)
             & (s1 > 0) & (s2 > 0)
             & (p[..., 2] > 0) & (p_c2[..., 2] > 0)
             & (e1 < reproj_chi2 * s1v)
             & (e2 < reproj_chi2 * s2v))
    return p, s1, valid


def stereo_depth_from_point(p_c1, baseline_dir=None):
    """Depth along the optical axis of camera 1."""
    return p_c1[..., 2]
