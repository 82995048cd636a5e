"""FAST-16 corner detection, fully vectorized over whole images.

JAX replacement for the per-cell OpenCV FAST calls of the reference
(reference: src/ORBextractor.cc:745-779 — 35x35-cell FAST with iniThFAST ->
minThFAST fallback). Instead of cell loops, the detector computes dense
bright/dark arc masks with 16 shifted image copies, finds contiguous runs of
>= 9 with a bit-trick on a packed 16-bit word (branch-free, pure elementwise work),
applies 3x3 non-max suppression with `reduce_window`, and lets the extractor
do the per-cell threshold fallback by combining the two dense score maps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 (the FAST-16 test set), clockwise from 12
# o'clock — same geometry OpenCV uses (public constant of the FAST paper).
CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)  # (dx, dy)

ARC_LEN = 9  # contiguous samples required (FAST-9/16)


def _ring(img: jnp.ndarray) -> jnp.ndarray:
    """[H, W] -> [16, H, W] 16 circle-shifted copies (roll keeps shapes)."""
    outs = []
    for dx, dy in CIRCLE:
        outs.append(jnp.roll(img, shift=(-int(dy), -int(dx)), axis=(0, 1)))
    return jnp.stack(outs, axis=0)


def _arc_word(mask16: jnp.ndarray) -> jnp.ndarray:
    """[16, H, W] bool -> [H, W] uint32 packed ring word (bit i = sample i).

    Packing over the MAJOR axis keeps every intermediate in the [H, W]
    image layout — a [..., 16] minor axis would make every elementwise
    pass strided.
    """
    weights = jnp.asarray((1 << np.arange(16)).astype(np.uint32))
    return jnp.sum(mask16.astype(jnp.uint32) * weights[:, None, None],
                   axis=0, dtype=jnp.uint32)


def _word_has_arc(x: jnp.ndarray) -> jnp.ndarray:
    """[H, W] uint32 packed ring -> bool: any circular run of >= ARC_LEN.

    Doubles the word (circular wrap) and and-shift-folds to test runs of
    9: r = x & (x>>1); r &= r>>2; r &= r>>4; r &= x>>8 leaves a bit set
    iff 9 consecutive bits were set.
    """
    # uint32 throughout: >> must be a LOGICAL shift (int32 would arithmetic-
    # shift the sign bit of the doubled word back in and fake runs).
    x = x | (x << jnp.uint32(16))  # circular
    r = x & (x >> jnp.uint32(1))     # runs >= 2
    r = r & (r >> jnp.uint32(2))     # runs >= 4
    r = r & (r >> jnp.uint32(4))     # runs >= 8
    r = r & (x >> jnp.uint32(8))     # runs >= 9
    return r != 0


def _has_arc(mask16: jnp.ndarray) -> jnp.ndarray:
    """[..., 16] bool -> [...] bool (compat wrapper; prefer the
    [16, H, W]-major _arc_word/_word_has_arc pair in hot paths)."""
    weights = jnp.asarray((1 << np.arange(16)).astype(np.uint32))
    x = jnp.sum(mask16.astype(jnp.uint32) * weights, axis=-1,
                dtype=jnp.uint32)
    return _word_has_arc(x)


def _score_from_diff(diff: jnp.ndarray, threshold: float,
                     inside: jnp.ndarray) -> jnp.ndarray:
    """[16, H, W] ring differences -> [H, W] FAST-9/16 score map."""
    bright = diff > threshold
    dark = diff < -threshold
    is_corner = (_word_has_arc(_arc_word(bright))
                 | _word_has_arc(_arc_word(dark)))
    excess_b = jnp.sum(jnp.where(bright, diff - threshold, 0.0), axis=0)
    excess_d = jnp.sum(jnp.where(dark, -diff - threshold, 0.0), axis=0)
    score = jnp.maximum(excess_b, excess_d)
    return jnp.where(is_corner & inside, score, 0.0)


def _inside_mask(h: int, w: int, border: int) -> jnp.ndarray:
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return ((ys >= border) & (ys < h - border)
            & (xs >= border) & (xs < w - border))


def fast_score_map(img: jnp.ndarray, threshold: float,
                   border: int = 16) -> jnp.ndarray:
    """Dense FAST-9/16 corner response of a [H, W] float image.

    Returns [H, W] scores; 0 where not a corner. Score = max over
    (sum of bright excesses, sum of dark excesses) over the ring — the
    standard GPU-FAST response, monotone in the threshold.
    """
    ring = _ring(img)                       # [16, H, W]
    diff = ring - img[None]                 # [16, H, W]
    h, w = img.shape
    return _score_from_diff(diff, threshold, _inside_mask(h, w, border))


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep only 3x3-local maxima (ties broken toward keeping)."""
    m = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
    return jnp.where(score >= m, score, 0.0)


def detect(img: jnp.ndarray, th_high: float, th_low: float,
           cell: int = 32, topk_per_cell: int = 8, border: int = 16):
    """FAST with per-cell high->low threshold fallback + per-cell top-K.

    The reference re-runs FAST per 35x35 cell with minThFAST when a cell
    yields nothing at iniThFAST (src/ORBextractor.cc:745-779) and then
    redistributes with a quad-tree. Here: two dense score maps; per cell, use
    high-threshold responses if the cell has any, else low-threshold ones;
    take top-K per cell (the batch-friendly equivalent of quad-tree
    redistribution — caps density per cell for spatial spread).

    Returns (xy [N,2] float32 (x, y), score [N], valid [N]) with
    N = n_cells * topk_per_cell, sorted by cell order.
    """
    h, w = img.shape
    # one ring/diff evaluation shared by both thresholds (the 16 shifted
    # copies dominate the memory traffic of the detector)
    ring = _ring(img)
    diff = ring - img[None]
    inside = _inside_mask(h, w, border)
    s_low = nms3x3(_score_from_diff(diff, th_low, inside))
    s_high = nms3x3(_score_from_diff(diff, th_high, inside))

    ch = cw = cell
    ny, nx = h // ch, w // cw
    # crop to a multiple of the cell size (border strip already masked)
    s_low_c = s_low[:ny * ch, :nx * cw].reshape(ny, ch, nx, cw)
    s_high_c = s_high[:ny * ch, :nx * cw].reshape(ny, ch, nx, cw)
    s_low_c = jnp.moveaxis(s_low_c, 2, 1).reshape(ny * nx, ch * cw)
    s_high_c = jnp.moveaxis(s_high_c, 2, 1).reshape(ny * nx, ch * cw)

    has_high = jnp.any(s_high_c > 0, axis=1, keepdims=True)
    s_cell = jnp.where(has_high, s_high_c, s_low_c)

    k = topk_per_cell
    vals, idx = jax.lax.top_k(s_cell, k)            # [nC, k]
    cell_ids = jax.lax.broadcasted_iota(jnp.int32, (ny * nx, k), 0)
    cy = cell_ids // nx
    cx = cell_ids % nx
    py = idx // cw
    px = idx % cw
    xs = (cx * cw + px).astype(jnp.float32)
    ys = (cy * ch + py).astype(jnp.float32)
    valid = vals > 0
    xy = jnp.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)
    return xy, vals.reshape(-1), valid.reshape(-1)
