"""Stereo undistort-rectify maps for distorted-pinhole rigs.

JAX replacement for the reference's rectification-map precompute
(reference: src/Settings.cc:683-725 `precomputeRectificationMaps` —
cv::stereoRectify + cv::initUndistortRectifyMap, applied per frame with
cv::remap in Tracking::GrabImageStereo). Raw EuRoC-style stereo pairs
(radtan-distorted, converging optical axes) become ideal-pinhole,
row-aligned images, which is what the repo's stereo spawn/matching path
assumes.

Idiom shift: the maps are computed ONCE host-side (numpy, at settings
load), and the per-frame remap is one bilinear gather per camera inside
the jitted extraction step — the same `map_coordinates`-style sampling
the pyramid already uses, batched over cameras.

Geometry (Fusiello-style rectification, equivalent to cv::stereoRectify's
row-alignment): the new common orientation has x along the baseline,
y ⟂ (z1, baseline), z completing; both cameras share one ideal pinhole
K_new, so epipolar lines are horizontal and disparity is pure-x.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def stereo_rectify(R12: np.ndarray, t12: np.ndarray):
    """New-frame rotations for a stereo pair.

    Args:
      R12, t12: cam1-from-cam2 transform (p_c1 = R12 p_c2 + t12), i.e.
        `Stereo.T_c1_c2` of the reference yamls (Settings.cc:611).
    Returns:
      (R_rect1, R_rect2): rotations old-camera-frame -> rectified frame
      (p_rect = R_rect_i @ p_ci), and the baseline length.
    """
    t12 = np.asarray(t12, np.float64)
    v1 = t12 / np.linalg.norm(t12)                 # new x: along baseline
    z1 = np.array([0.0, 0.0, 1.0])
    v2 = np.cross(z1, v1)
    v2 = v2 / np.linalg.norm(v2)                   # new y
    v3 = np.cross(v1, v2)                          # new z
    R_rect1 = np.stack([v1, v2, v3])               # rows = new axes in c1
    R_rect2 = R_rect1 @ np.asarray(R12, np.float64)
    return R_rect1, R_rect2, float(np.linalg.norm(t12))


def _radtan_distort(x, y, d):
    """Normalized coords -> distorted normalized coords (k1,k2,p1,p2)."""
    k1, k2, p1, p2 = d
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def rectify_map(params: np.ndarray, dist, R_rect: np.ndarray,
                new_params: np.ndarray, w: int, h: int) -> np.ndarray:
    """[H, W, 2] source-pixel coords (x, y) for each rectified pixel.

    For each rectified pixel: unproject through the ideal K_new, rotate
    back into the original camera frame (R_rect^T), apply radtan
    distortion, project through the original K — exactly
    cv::initUndistortRectifyMap's composition (Settings.cc:713-718).
    """
    fx, fy, cx, cy = [float(v) for v in new_params[:4]]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    x = (u - cx) / fx
    y = (v - cy) / fy
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)       # [H, W, 3]
    rays = rays @ R_rect                                    # R_rect^T @ r
    z = np.maximum(rays[..., 2], 1e-9)
    xn, yn = rays[..., 0] / z, rays[..., 1] / z
    if dist is not None and np.any(np.asarray(dist)):
        xn, yn = _radtan_distort(xn, yn, np.asarray(dist, np.float64))
    fx0, fy0, cx0, cy0 = [float(vv) for vv in params[:4]]
    us = fx0 * xn + cx0
    vs = fy0 * yn + cy0
    return np.stack([us, vs], axis=-1).astype(np.float32)


def stereo_rectify_maps(params: np.ndarray, dist, R12, t12,
                        w: int, h: int):
    """Full precompute for a 2-camera pinhole rig.

    Args:
      params: [2, >=4] original (fx, fy, cx, cy, ...) per camera;
      dist: [2, 4] radtan (k1, k2, p1, p2) or None;
      R12, t12: cam1-from-cam2 (`Stereo.T_c1_c2`).
    Returns dict with:
      maps     [2, H, W, 2] per-camera source-coordinate grids;
      new_params [>=4]      shared ideal pinhole of the rectified pair;
      R_rect   [2, 3, 3]    old-cam -> rectified-frame rotations;
      baseline float        (bf analog: baseline * fx_new).
    """
    R_rect1, R_rect2, baseline = stereo_rectify(R12, t12)
    f_base = float(np.mean([params[0][0], params[0][1],
                            params[1][0], params[1][1]]))
    d1 = None if dist is None else dist[0]
    d2 = None if dist is None else dist[1]

    def build(f_new):
        new_params = np.array([f_new, f_new, w / 2.0, h / 2.0,
                               0, 0, 0, 0], np.float32)
        maps = np.stack([
            rectify_map(params[0], d1, R_rect1, new_params, w, h),
            rectify_map(params[1], d2, R_rect2, new_params, w, h)])
        return new_params, maps

    def valid_frac(maps):
        ok = ((maps[..., 0] >= 0) & (maps[..., 0] <= w - 1)
              & (maps[..., 1] >= 0) & (maps[..., 1] <= h - 1))
        return float(ok.mean())

    # alpha=0 crop (cv::stereoRectify semantics): zoom the ideal focal
    # length until (nearly) every rectified pixel samples INSIDE the raw
    # images — border smear from clamped out-of-range samples otherwise
    # feeds garbage features to the extractor
    f_new = f_base
    new_params, maps = build(f_new)
    for _ in range(8):
        if valid_frac(maps) >= 0.995:
            break
        f_new *= 1.08
        new_params, maps = build(f_new)
    return {"maps": maps, "new_params": new_params,
            "R_rect": np.stack([R_rect1, R_rect2]).astype(np.float32),
            "baseline": baseline}


def remap_bilinear(img: jnp.ndarray, grid: jnp.ndarray) -> jnp.ndarray:
    """Bilinear remap of [H, W] image at grid [H, W, 2] (x, y) coords.

    Out-of-bounds samples clamp to the border (cv::remap's
    BORDER_REPLICATE behavior in the reference's usage); jit-able, runs
    inside the extraction step.
    """
    h, w = img.shape
    x = jnp.clip(grid[..., 0], 0.0, w - 1.0)
    y = jnp.clip(grid[..., 1], 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    idx = y0 * w + x0
    v00 = jnp.take(flat, idx)
    v01 = jnp.take(flat, idx + 1)
    v10 = jnp.take(flat, idx + w)
    v11 = jnp.take(flat, idx + w + 1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def remap_multicam(images: jnp.ndarray, maps: jnp.ndarray) -> jnp.ndarray:
    """[C, H, W] images + [C, H, W, 2] grids -> rectified [C, H, W]."""
    return jax.vmap(remap_bilinear)(images, maps)


def rectified_rig(rig, rect: dict):
    """Rig parameters of the RECTIFIED pair: both cameras share the ideal
    K_new; orientations rotate by R_rect (optical centers are unchanged —
    rectification is a pure rotation about each center, so
    t_cb_rect = R_rect @ t_cb)."""
    from ..optim.reprojection import RigParams
    from ..geometry import cameras

    R_rect = jnp.asarray(rect["R_rect"])
    params = jnp.broadcast_to(jnp.asarray(rect["new_params"]),
                              rig.params.shape)
    R_cb = jnp.einsum("cij,cjk->cik", R_rect, rig.R_cb)
    t_cb = jnp.einsum("cij,cj->ci", R_rect, rig.t_cb)
    return RigParams(kind=cameras.PINHOLE, params=params,
                     R_cb=R_cb, t_cb=t_cb)
