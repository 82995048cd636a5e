"""ORB feature extraction over an image pyramid — fixed-capacity, batched.

JAX replacement for `ORBextractor::operator()` (reference:
src/ORBextractor.h:33-38, src/ORBextractor.cc): 8-level pyramid FAST with
high->low threshold fallback, per-cell top-K spatial redistribution (the
batch-friendly analog of `DistributeOctTree`, src/ORBextractor.cc:496),
intensity-centroid orientation, Gaussian blur + rotated BRIEF.

Everything returns fixed-capacity arrays with validity masks so downstream
code stays static-shaped; invalid slots carry zeros. The multi-camera path
of the reference (4 extraction std::threads, src/Frame.cc:1841-1862) becomes
a `vmap` over the camera axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import fast, orb, pyramid


class Features(NamedTuple):
    """Per-image extracted features (fixed capacity K)."""
    xy: jnp.ndarray        # [K, 2] float32 — level-0 pixel coords (x, y)
    response: jnp.ndarray  # [K] float32
    angle: jnp.ndarray     # [K] float32 radians
    level: jnp.ndarray     # [K] int32 pyramid level
    sigma2: jnp.ndarray    # [K] float32 = scale^(2*level) (per-kp variance)
    desc: jnp.ndarray      # [K, 256] int8 {0,1}
    valid: jnp.ndarray     # [K] bool

    @property
    def capacity(self):
        return self.xy.shape[-2]


@dataclass(frozen=True)
class OrbConfig:
    n_features: int = 512       # per image (reference flagship: 500/camera)
    n_levels: int = 8
    scale: float = 1.2
    th_high: float = 15.0       # iniThFAST (Hilti yaml: 15)
    th_low: float = 7.0         # minThFAST
    cell: int = 32
    topk_per_cell: int = 8
    border: int = 16
    # descriptor sampling path: "patch" = block-row patch gather + dense
    # moment/bilinear contractions; "stacked" = per-tap row gathers.
    # Same math (IC angles + bilinear rBRIEF); kept switchable for
    # accuracy A/B.
    sampling: str = "patch"

    def per_level_budget(self):
        """Geometric feature split across levels (reference:
        ORBextractor ctor mnFeaturesPerLevel)."""
        inv = 1.0 / self.scale
        raw = np.array([inv ** l for l in range(self.n_levels)])
        raw = raw / raw.sum() * self.n_features
        budget = np.floor(raw).astype(int)
        budget[0] += self.n_features - budget.sum()
        return [int(b) for b in budget]


def _detect_level(img, budget, cfg: OrbConfig):
    """One pyramid level -> fixed-capacity keypoints (level-local coords)."""
    xy, score, valid = fast.detect(
        img, cfg.th_high, cfg.th_low, cell=cfg.cell,
        topk_per_cell=cfg.topk_per_cell, border=cfg.border)
    # global top-`budget` among the per-cell survivors; small levels can have
    # fewer candidates than the budget — pad with invalid slots
    masked = jnp.where(valid, score, -1.0)
    k_eff = min(budget, masked.shape[0])
    top_scores, top_idx = jax.lax.top_k(masked, k_eff)
    if k_eff < budget:
        pad = budget - k_eff
        top_scores = jnp.concatenate(
            [top_scores, jnp.full((pad,), -1.0, top_scores.dtype)])
        top_idx = jnp.concatenate(
            [top_idx, jnp.zeros((pad,), top_idx.dtype)])
    kp = xy[top_idx]                      # [budget, 2]
    kp_valid = top_scores > 0
    return kp, top_scores, kp_valid


def extract(img: jnp.ndarray, cfg: OrbConfig = OrbConfig()) -> Features:
    """[H, W] float32 image -> Features with capacity cfg.n_features.

    Detection/selection runs per level (shapes differ), but orientation
    and description run ONCE over a padded pyramid stack: the per-level
    formulation issued 2 small gathers per (camera, level) — 64
    latency-bound dispatches at the flagship 4-cam x 8-level budget.
    """
    levels = pyramid.build_pyramid(img, cfg.n_levels, cfg.scale)
    budgets = cfg.per_level_budget()
    h0, w0 = img.shape

    kp_l, resp_l, lv_l, s2_l, valid_l, used_levels = [], [], [], [], [], []
    for lv, (img_l, budget) in enumerate(zip(levels, budgets)):
        if budget == 0:
            continue
        kp, score, val = _detect_level(img_l, budget, cfg)
        s = cfg.scale ** lv
        kp_l.append(kp)                   # LEVEL-local coords
        resp_l.append(score)
        lv_l.append(jnp.full((budget,), len(used_levels),
                             dtype=jnp.int32))
        s2_l.append(jnp.full((budget,), s * s, dtype=jnp.float32))
        valid_l.append(val)
        used_levels.append((lv, img_l))

    kp = jnp.concatenate(kp_l, axis=0)
    lvid = jnp.concatenate(lv_l, axis=0)
    valid = jnp.concatenate(valid_l, axis=0)

    # padded stack (edge replicate: pattern samples within `border` of a
    # small level's true edge must not read zeros)
    stack = jnp.stack([
        jnp.pad(im, ((0, h0 - im.shape[0]), (0, w0 - im.shape[1])),
                mode="edge") for _, im in used_levels])
    if cfg.sampling == "patch":
        # patch-extraction formulation: one block-row gather per keypoint,
        # then dense moment/bilinear math (see orb.extract_patches —
        # replaces the per-tap gathers that dominated extraction time,
        # PERF.md r3)
        patches, _, _ = orb.extract_patches(stack, lvid, kp)
        angles = orb.patch_angles(patches)
        patches_b, oxb, oyb = orb.extract_patches(pyramid.blur(stack),
                                                  lvid, kp)
        desc = orb.patch_describe(patches_b, kp, oxb, oyb, angles)
    else:
        # round-3 stacked-gather path (per-tap row gathers)
        angles = orb.keypoint_angles_stacked(stack, lvid, kp)
        desc = orb.describe_stacked(pyramid.blur(stack), lvid, kp,
                                    angles)
    desc = jnp.where(valid[:, None], desc, 0)

    scale_of = jnp.asarray([cfg.scale ** lv for lv, _ in used_levels],
                           jnp.float32)
    lv_of = jnp.asarray([lv for lv, _ in used_levels], jnp.int32)
    return Features(
        xy=kp * scale_of[lvid][:, None],   # rescale to level-0 coords
        response=jnp.concatenate(resp_l, axis=0),
        angle=angles,
        level=lv_of[lvid],
        sigma2=jnp.concatenate(s2_l, axis=0),
        desc=desc,
        valid=valid,
    )


def extract_multicam(images: jnp.ndarray,
                     cfg: OrbConfig = OrbConfig()) -> Features:
    """[C, H, W] -> Features batched over the camera axis.

    The reference extracts the 4 cameras in 4 std::threads
    (src/Frame.cc:1841-1862); here the camera axis is a vmap batch dimension
    of one fused program.
    """
    return jax.vmap(partial(extract, cfg=cfg))(images)


def undistort_features(feats: Features, params: jnp.ndarray,
                       dist) -> Features:
    """Replace keypoint pixels with ideal-pinhole pixels.

    For distorted-pinhole rigs (e.g. raw EuRoC images, radtan k1 ~= -0.28)
    the detector runs on the raw image and the keypoints are lifted to the
    ideal pinhole model here, so all downstream projection/matching uses
    undistorted coordinates (reference: Frame::UndistortKeyPoints via
    cv::undistortPoints, src/Frame.cc).

    params/dist broadcast over feats.xy's batch dims: single-camera
    feats [K, 2] take params [4+]/dist [4]; camera-batched feats [C, K, 2]
    take params [C, 4+]/dist [C, 4]. `dist` None is a no-op.
    """
    if dist is None:
        return feats
    from ..geometry import cameras
    p = jnp.asarray(params)
    d = jnp.asarray(dist)
    if feats.xy.ndim == 3:      # [C, K, 2]
        p, d = p[:, None, :], d[:, None, :]
    xy = cameras.undistort_pixels(p, d, feats.xy)
    return feats._replace(xy=xy)
