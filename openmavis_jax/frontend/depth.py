"""Depth-map measurements: RGB-D pseudo-stereo and depth priors.

JAX rebuild of the reference's depth pathways:
  - `Frame::ComputeStereoFromRGBD` (reference: src/Frame.cc — depth sampled
    at keypoints becomes a virtual right-image coordinate mvuRight),
  - `Frame::GetDepthFromUndistortedPoints` (reference: src/Frame.cc:1659-1765
    — fisheye keypoints are undistorted through a virtual pinhole to sample
    externally-produced depth maps in the multi-camera pipeline),
  - depth-based landmark creation in `Tracking::StereoInitialization` /
    `CreateNewKeyFrame` (reference: src/Tracking.cc:2232-2337, 3159 — close
    points are spawned directly from depth instead of waiting for parallax).

All functions are batched over keypoints and jit-friendly (fixed shapes,
masks for validity).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import cameras
from ..slam_map import map_state as ms


def sample_depth(depth: jnp.ndarray, xy: jnp.ndarray,
                 min_d: float = 0.05, max_d: float = 40.0):
    """Bilinearly sample a depth map at pixel coords.

    Zero / out-of-range depths are treated as holes: the sample is valid
    only if all four bilinear neighbors are in range (mirrors the
    reference's conservative nearest-pixel lookup).

    Args:
      depth: [H, W] float32, 0 = no measurement.
      xy: [K, 2] pixel coords (x, y).
    Returns (d [K] float32, valid [K] bool).
    """
    H, W = depth.shape
    x = xy[:, 0]
    y = xy[:, 1]
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    inb = (x0 >= 0) & (x0 + 1 <= W - 1) & (y0 >= 0) & (y0 + 1 <= H - 1)
    x0c = jnp.clip(x0, 0, W - 2)
    y0c = jnp.clip(y0, 0, H - 2)
    fx = x - x0c
    fy = y - y0c
    d00 = depth[y0c, x0c]
    d01 = depth[y0c, x0c + 1]
    d10 = depth[y0c + 1, x0c]
    d11 = depth[y0c + 1, x0c + 1]
    ok = ((d00 > min_d) & (d01 > min_d) & (d10 > min_d) & (d11 > min_d)
          & (d00 < max_d) & (d01 < max_d) & (d10 < max_d) & (d11 < max_d))
    d = (d00 * (1 - fx) * (1 - fy) + d01 * fx * (1 - fy)
         + d10 * (1 - fx) * fy + d11 * fx * fy)
    return d, inb & ok


def sample_depth_undistorted(depth: jnp.ndarray, xy: jnp.ndarray,
                             cam_kind: int, cam_params: jnp.ndarray,
                             pin_params: jnp.ndarray,
                             min_d: float = 0.05, max_d: float = 40.0):
    """Sample a depth map that lives in a *virtual undistorted pinhole*
    frame at keypoints detected on the raw (e.g. fisheye) image.

    (reference: Frame::GetDepthFromUndistortedPoints, src/Frame.cc:1659-1765
    — the Hilti depth priors are rendered for per-camera virtual pinholes;
    the reference hard-codes those intrinsics per cam_id, here they are the
    `pin_params` argument.)

    The returned depth is the z-coordinate along the keypoint's ray in the
    REAL camera frame, so `ray * d / ray_z` backprojects correctly.
    Returns (d [K], valid [K]).
    """
    ray = cameras.unproject(cam_kind, cam_params, xy)        # [K, 3]
    z = ray[:, 2]
    front = z > 1e-6
    uv_pin = cameras.pinhole_project(
        pin_params, ray / jnp.maximum(z, 1e-6)[:, None])
    d, ok = sample_depth(depth, uv_pin, min_d, max_d)
    return d, ok & front


def backproject(cam_kind: int, cam_params: jnp.ndarray, xy: jnp.ndarray,
                d: jnp.ndarray) -> jnp.ndarray:
    """Lift keypoints to 3D camera-frame points at depth d (z-depth).

    Works for any camera model: unproject to a ray, scale so z == d.
    Returns [K, 3].
    """
    ray = cameras.unproject(cam_kind, cam_params, xy)
    z = jnp.maximum(ray[:, 2:3], 1e-6)
    return ray / z * d[:, None]


def depth_to_uright(xy: jnp.ndarray, d: jnp.ndarray, bf: float):
    """Virtual right-image u-coordinate from depth (mvuRight convention).

    (reference: Frame::ComputeStereoFromRGBD — u_r = u - bf / d with
    bf = fx * baseline.)
    """
    return xy[:, 0] - bf / jnp.maximum(d, 1e-6)


def _spawn_world_points(m: ms.MapState, slot, p_w: jnp.ndarray,
                        good: jnp.ndarray, cap_new: int):
    """Write up to `cap_new` new landmarks at world points `p_w` for
    keyframe `slot`'s features flagged `good` (shared tail of the
    depth-spawn entry points)."""
    M = m.mp_pos.shape[0]
    order = jnp.cumsum(good.astype(jnp.int32)) - 1
    slot_mp = m.n_mp + order
    write = good & (order < cap_new) & (slot_mp < M)
    tgt = jnp.where(write, slot_mp, M)

    mp_pos = jnp.zeros((M + 1, 3), m.mp_pos.dtype).at[tgt].set(p_w)[:M]
    mp_desc = jnp.zeros((M + 1, 256), jnp.int8).at[tgt].set(
        m.kf_desc[slot])[:M]
    newly = jnp.zeros((M + 1,), bool).at[tgt].set(write)[:M]

    m = m._replace(
        mp_pos=jnp.where(newly[:, None], mp_pos, m.mp_pos),
        mp_desc=jnp.where(newly[:, None], mp_desc, m.mp_desc),
        mp_valid=m.mp_valid | newly,
        mp_first_kf=jnp.where(newly, slot, m.mp_first_kf),
        mp_last_kf=jnp.where(newly, slot, m.mp_last_kf),
        n_mp=m.n_mp + jnp.sum(write.astype(jnp.int32)),
        kf_obs=m.kf_obs.at[slot].set(
            jnp.where(write, slot_mp, m.kf_obs[slot])))
    return ms.update_mp_geometry(m, None), jnp.sum(write.astype(jnp.int32))


@partial(jax.jit, static_argnames=("cam_kind", "cap_new"))
def spawn_from_depth(m: ms.MapState, slot, cam_kind: int, cam_params,
                     R_cb, t_cb, d: jnp.ndarray, d_valid: jnp.ndarray,
                     cap_new: int, max_spawn_depth: float = 25.0):
    """Create landmarks for a keyframe's unbound features from measured
    depth (no parallax needed).

    (reference: Tracking::CreateNewKeyFrame's depth-sorted point creation
    and StereoInitialization, src/Tracking.cc:2232-2337 — stereo/RGBD
    points with depth below a threshold are inserted immediately.)

    Args:
      m: map; keyframe `slot` must already be inserted (kf_xy/kf_desc set).
      cam_params / R_cb / t_cb: intrinsics + extrinsic of the camera the
        features belong to (camera-from-body).
      d: [F] z-depth per feature (camera frame); d_valid: [F] bool.
    Returns (m, n_spawned).
    """
    xy = m.kf_xy[slot]
    unbound = (m.kf_obs[slot] < 0) & m.kf_feat_valid[slot]
    good = unbound & d_valid & (d > 0.05) & (d < max_spawn_depth)

    p_c = backproject(cam_kind, cam_params, xy, d)
    # world point: p_w = R_wb (R_cb^T (p_c - t_cb)) + t_wb
    p_b = jnp.einsum("ji,fj->fi", R_cb, p_c - t_cb)
    p_w = jnp.einsum("ij,fj->fi", m.kf_R[slot], p_b) + m.kf_t[slot]
    return _spawn_world_points(m, slot, p_w, good, cap_new)


def spawn_from_depth_multi(m: ms.MapState, slot, rig_kind: int,
                           n_cams: int, rig, depth: jnp.ndarray,
                           pin_params=None, cap_new: int = 256,
                           max_spawn_depth: float = 25.0):
    """Depth-prior landmark spawning for the multi-camera pipeline: every
    camera band's unbound features sample their camera's depth map and
    spawn landmarks at measured metric depth.

    (reference: the multi-camera depth-prior path,
    Frame::GetDepthFromUndistortedPoints src/Frame.cc:1659-1765 sampled
    into pseudo-stereo for all bands at Frame.cc:1916-1922.)

    Args:
      depth: [C, H, W] per-camera z-depth maps, 0 = hole.
      pin_params: optional [C, >=4] virtual-pinhole intrinsics the depth
        maps live in (required for fisheye rigs; None = the depth maps
        are in the raw camera frame, valid for undistorted pinholes).
    Returns (m, n_spawned).
    """
    F = m.kf_xy.shape[1]
    xy = m.kf_xy[slot]
    cam = m.kf_cam[slot]
    d = jnp.zeros((F,))
    ok = jnp.zeros((F,), bool)
    p_b = jnp.zeros((F, 3))
    for c in range(n_cams):
        sel = cam == c
        if pin_params is None:
            dc, okc = sample_depth(depth[c], xy)
        else:
            dc, okc = sample_depth_undistorted(
                depth[c], xy, rig_kind, rig.params[c],
                jnp.asarray(pin_params[c]))
        pc = backproject(rig_kind, rig.params[c], xy, dc)
        pb = jnp.einsum("ji,fj->fi", rig.R_cb[c], pc - rig.t_cb[c])
        d = jnp.where(sel, dc, d)
        ok = jnp.where(sel, okc, ok)
        p_b = jnp.where(sel[:, None], pb, p_b)

    unbound = (m.kf_obs[slot] < 0) & m.kf_feat_valid[slot]
    good = unbound & ok & (d > 0.05) & (d < max_spawn_depth)
    p_w = jnp.einsum("ij,fj->fi", m.kf_R[slot], p_b) + m.kf_t[slot]
    return _spawn_world_points(m, slot, p_w, good, cap_new)
