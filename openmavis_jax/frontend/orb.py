"""Oriented BRIEF: intensity-centroid orientation + rotated binary descriptor.

JAX replacement for the reference's IC_Angle + computeOrbDescriptor
(reference: src/ORBextractor.cc:19-100 and the static 512-point pattern).

Design notes:
* Orientation is computed as two dense depthwise convolutions (x- and
  y-moment kernels over the circular patch) — one conv pair per level, then a
  single gather per keypoint. This replaces the per-keypoint `umax` loop of
  the reference with dense convs.
* The descriptor pattern is NOT the OpenCV learned pattern: it is a seeded
  Gaussian pattern (BRIEF-paper sampling, sigma = patch/5, norm-clipped) —
  descriptors only need internal consistency since the vocabulary is trained
  on them (SURVEY.md §6: the reference ships no vocabulary either).
* Descriptors are produced both bit-packed ([K, 8] uint32) for storage and
  as {0,1} int8 planes ([K, 256]) feeding the matmul Hamming matcher.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

PATCH_RADIUS = 15          # orientation patch (31x31), like the reference
PATTERN_RADIUS = 13.0      # descriptor points stay within this norm
N_BITS = 256


def _circular_mask(radius: int) -> np.ndarray:
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


def moment_kernels(radius: int = PATCH_RADIUS) -> np.ndarray:
    """[2, 1, 2r+1, 2r+1] conv kernels computing (m10, m01) of the patch."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = _circular_mask(radius)
    kx = (x * mask).astype(np.float32)
    ky = (y * mask).astype(np.float32)
    return np.stack([kx[None], ky[None]], axis=0)


def orientation_maps(img: jnp.ndarray, radius: int = PATCH_RADIUS):
    """[H, W] -> (m10 [H, W], m01 [H, W]) dense patch moments."""
    k = jnp.asarray(moment_kernels(radius))
    # NOTE: conv correlates with the flipped kernel; moment kernels are
    # antisymmetric, so flip = negation — use conv dimension numbers that
    # correlate directly instead.
    out = jax.lax.conv_general_dilated(
        img[None, None], k, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return out[0, 0], out[0, 1]


def _moment_weights(radius: int):
    """Flattened (wx [P], wy [P], offsets dy,dx [P, 2]) of the circular
    patch — precomputed host-side once per radius."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = _circular_mask(radius)
    wx = (x * mask).reshape(-1).astype(np.float32)
    wy = (y * mask).reshape(-1).astype(np.float32)
    off = np.stack([y.reshape(-1), x.reshape(-1)], axis=-1).astype(np.int32)
    return wx, wy, off


def keypoint_angles(img: jnp.ndarray, xy: jnp.ndarray,
                    radius: int = PATCH_RADIUS) -> jnp.ndarray:
    """Intensity-centroid angle (radians) for keypoints [K, 2] (x, y).

    Gathers each keypoint's 31x31 patch and reduces against the moment
    weights — work scales with K, not H*W. (A dense conv formulation
    computes 31x31 moment maps over every pixel of every level, and they
    are only ever read at K<=512 positions.)
    """
    h, w = img.shape
    wx, wy, off = _moment_weights(radius)
    wx, wy = jnp.asarray(wx), jnp.asarray(wy)
    xi = jnp.clip(xy[:, 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(xy[:, 1].astype(jnp.int32), 0, h - 1)
    py = jnp.clip(yi[:, None] + off[None, :, 0], 0, h - 1)   # [K, P]
    px = jnp.clip(xi[:, None] + off[None, :, 1], 0, w - 1)
    patch = jnp.take(img.reshape(-1), py * w + px)           # [K, P]
    m10 = patch @ wx
    m01 = patch @ wy
    return jnp.arctan2(m01, m10)


def make_pattern(seed: int = 1234, n_bits: int = N_BITS,
                 sigma: float = 31.0 / 5.0,
                 max_norm: float = PATTERN_RADIUS) -> np.ndarray:
    """[n_bits, 2, 2] float32 (pairs of (x, y) points), deterministic."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2)).astype(np.float32)
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(norm, max_norm) / np.maximum(norm, 1e-9)
    return pts * scale


_PATTERN = make_pattern()


def _bilinear(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample [H, W] image at float coords (clamped)."""
    h, w = img.shape
    x = jnp.clip(x, 0.0, w - 1.001)
    y = jnp.clip(y, 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
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


def describe(img_blur: jnp.ndarray, xy: jnp.ndarray,
             angles: jnp.ndarray) -> jnp.ndarray:
    """Rotated-BRIEF bits for keypoints.

    Args:
      img_blur: [H, W] Gaussian-blurred level image.
      xy: [K, 2] keypoint coords (x, y) in this level's pixels.
      angles: [K] orientation in radians.
    Returns:
      bits [K, 256] int8 in {0, 1}.
    """
    pat = jnp.asarray(_PATTERN)                     # [256, 2, 2]
    c, s = jnp.cos(angles), jnp.sin(angles)         # [K]
    # rotation applied to pattern points: p' = R(theta) p
    px, py = pat[..., 0], pat[..., 1]               # [256, 2]
    rx = c[:, None, None] * px[None] - s[:, None, None] * py[None]
    ry = s[:, None, None] * px[None] + c[:, None, None] * py[None]
    sx = xy[:, None, None, 0] + rx                  # [K, 256, 2]
    sy = xy[:, None, None, 1] + ry
    vals = _bilinear(img_blur, sx.reshape(-1), sy.reshape(-1))
    vals = vals.reshape(sx.shape)                   # [K, 256, 2]
    return (vals[..., 0] < vals[..., 1]).astype(jnp.int8)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """[K, 256] {0,1} -> [K, 8] uint32 (for compact storage/checkpoint)."""
    k = bits.shape[0]
    b = bits.reshape(k, 8, 32).astype(jnp.uint32)
    weights = jnp.asarray((1 << np.arange(32)).astype(np.uint32))
    return jnp.sum(b * weights, axis=-1, dtype=jnp.uint32)


def unpack_bits(packed: jnp.ndarray) -> jnp.ndarray:
    """[K, 8] uint32 -> [K, 256] int8 in {0, 1}."""
    k = packed.shape[0]
    shifts = jnp.asarray(np.arange(32, dtype=np.uint32))
    bits = (packed[:, :, None] >> shifts[None, None]) & jnp.uint32(1)
    return bits.reshape(k, 256).astype(jnp.int8)


# ---------------------------------------------------------------------------
# Patch-extraction formulation (round-4 rewrite of the gather-bound path)
#
# The stacked-gather implementations below (`keypoint_angles_stacked`,
# `describe_stacked`) issue one random access per moment tap / rBRIEF
# bilinear tap. This formulation gathers each keypoint's 31x32 patch ONCE
# (block-row fetches: one gather per row, not per element) and turns all
# remaining sampling into dense elementwise/matmul math:
#
# * IC-angle moments: a static [31, 32] weight contraction per keypoint;
# * rotated-BRIEF bilinear taps: separable 1-D triangle-kernel weights
#   (relu(1 - |x - i|)) contracted against the patch by a matmul — exact
#   bilinear interpolation, zero gathers.
#
# (reference: src/ORBextractor.cc:19-100 IC_Angle + computeOrbDescriptor —
# the per-keypoint patch walk, re-shaped for a vector machine.)
# ---------------------------------------------------------------------------

_PW = 32                     # patch lane width (31 used + 1 pad)
_HP = jax.lax.Precision.HIGHEST


def extract_patches(stack: jnp.ndarray, lv: jnp.ndarray,
                    xy: jnp.ndarray,
                    radius: int = PATCH_RADIUS):
    """Gather [K, P, 32] patches from a padded pyramid stack.

    stack: [L, h, w]; lv: [K] level ids; xy: [K, 2] level-local coords.
    Returns (patches [K, P, _PW], ox [K], oy [K]) where (ox, oy) is the
    patch origin in the level image; for keypoints >= `radius` from the
    border (guaranteed by the detector's border margin) the keypoint
    sits at local (radius + frac, radius + frac).

    Fetch strategy: the stack is viewed as 32-wide blocks; each patch row
    needs at most 2 consecutive blocks (2 row fetches of a [rows, 32]
    table — row-granular gathers are ~100x cheaper than per-element), and
    the lane shift inside the 64-wide strip is a tiny one-hot contraction.
    """
    L, h, w = stack.shape
    P = 2 * radius + 1
    nb = -(-w // _PW)
    wp = nb * _PW
    if wp != w:
        stack = jnp.pad(stack, ((0, 0), (0, 0), (0, wp - w)),
                        mode="edge")
    xi = jnp.floor(xy[:, 0]).astype(jnp.int32)
    yi = jnp.floor(xy[:, 1]).astype(jnp.int32)
    ox = jnp.clip(xi - radius, 0, w - _PW)
    oy = jnp.clip(yi - radius, 0, h - P)
    b0 = ox // _PW
    off = ox - b0 * _PW                                  # [K] in [0, 32)
    blocks = stack.reshape(L * h * nb, _PW)
    row = (lv[:, None] * h + oy[:, None]
           + jnp.arange(P, dtype=jnp.int32)[None])       # [K, P]
    base = row * nb + b0[:, None]                        # [K, P]
    two = jnp.stack([base, jnp.minimum(base + 1, L * h * nb - 1)],
                    axis=-1)                             # [K, P, 2]
    strip = blocks[two].reshape(-1, P, 2 * _PW)          # [K, P, 64]
    # lane shift by `off`: one-hot [K, 64, 32] contraction (exact select)
    jj = jax.lax.broadcasted_iota(jnp.int32, (2 * _PW, _PW), 0)
    cc = jax.lax.broadcasted_iota(jnp.int32, (2 * _PW, _PW), 1)
    sel = (jj[None] == off[:, None, None] + cc[None]).astype(stack.dtype)
    patches = jnp.einsum("kpj,kjc->kpc", strip, sel, precision=_HP)
    return patches, ox, oy


def _patch_moment_weights(radius: int):
    """Static [P, _PW] (wx, wy) circular-patch moment weights, origin at
    (radius, radius)."""
    P = 2 * radius + 1
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = _circular_mask(radius)
    wx = np.zeros((P, _PW), np.float32)
    wy = np.zeros((P, _PW), np.float32)
    wx[:, :P] = x * mask
    wy[:, :P] = y * mask
    return wx, wy


def patch_angles(patches: jnp.ndarray,
                 radius: int = PATCH_RADIUS) -> jnp.ndarray:
    """IC angles from extracted patches [K, P, _PW] (keypoint at the
    patch center): two dense weight contractions, no gathers."""
    wx, wy = _patch_moment_weights(radius)
    m10 = jnp.einsum("kpc,pc->k", patches, jnp.asarray(wx),
                     precision=_HP)
    m01 = jnp.einsum("kpc,pc->k", patches, jnp.asarray(wy),
                     precision=_HP)
    return jnp.arctan2(m01, m10)


def patch_describe(patches_blur: jnp.ndarray, xy: jnp.ndarray,
                   ox: jnp.ndarray, oy: jnp.ndarray,
                   angles: jnp.ndarray,
                   radius: int = PATCH_RADIUS) -> jnp.ndarray:
    """Rotated-BRIEF from blurred patches — bilinear taps as separable
    triangle-kernel weight contractions (exact bilinear, no gathers).

    patches_blur: [K, P, _PW]; xy: [K, 2] level-local keypoint coords;
    (ox, oy): patch origins from `extract_patches`.
    Returns bits [K, 256] int8 {0, 1}.
    """
    K = patches_blur.shape[0]
    P = patches_blur.shape[1]
    pat = jnp.asarray(_PATTERN)                     # [256, 2, 2]
    c, s = jnp.cos(angles), jnp.sin(angles)
    px_, py_ = pat[..., 0], pat[..., 1]             # [256, 2]
    rx = (c[:, None, None] * px_[None]
          - s[:, None, None] * py_[None]).reshape(K, -1)   # [K, 512]
    ry = (s[:, None, None] * px_[None]
          + c[:, None, None] * py_[None]).reshape(K, -1)
    sx = jnp.clip(xy[:, 0:1] - ox[:, None].astype(xy.dtype) + rx,
                  0.0, _PW - 1.001)                 # [K, 512] patch-local
    sy = jnp.clip(xy[:, 1:2] - oy[:, None].astype(xy.dtype) + ry,
                  0.0, P - 1.001)
    lanes = jnp.arange(_PW, dtype=sx.dtype)
    rows_ = jnp.arange(P, dtype=sy.dtype)
    # triangle kernel == exact 1-D linear interpolation weights
    wxw = jnp.maximum(0.0, 1.0 - jnp.abs(sx[..., None] - lanes))
    wyw = jnp.maximum(0.0, 1.0 - jnp.abs(sy[..., None] - rows_))
    a = jnp.einsum("kpc,ktc->ktp", patches_blur, wxw, precision=_HP)
    vals = jnp.sum(a * wyw, axis=-1).reshape(K, -1, 2)   # [K, 256, 2]
    return (vals[..., 0] < vals[..., 1]).astype(jnp.int8)


def _moment_weights_rows(radius: int):
    """[2r+1, 4*ceil((2r+1)/4)] (x, y) moment weights of the circular
    patch, zero-padded in the column dim to a multiple of 4 (the run-4
    row-gather granularity of keypoint_angles_stacked)."""
    n = 2 * radius + 1
    cols = -(-n // 4) * 4
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = _circular_mask(radius)
    wx = np.zeros((n, cols), np.float32)
    wy = np.zeros((n, cols), np.float32)
    wx[:, :n] = x * mask
    wy[:, :n] = y * mask
    return wx, wy


def keypoint_angles_stacked(stack: jnp.ndarray, lv: jnp.ndarray,
                            xy: jnp.ndarray,
                            radius: int = PATCH_RADIUS) -> jnp.ndarray:
    """IC angles for keypoints spread across a PADDED pyramid stack.

    stack: [L, H0, W0] (each level edge-padded to the level-0 shape);
    lv: [K] level index per keypoint; xy: [K, 2] LEVEL-local coords.

    One gather for all levels (the per-level variant launched a separate
    small gather per camera-level), and the patch is fetched as run-4
    rows of a [L*h*w, 4] consecutive-pixel table, so this reads the 31x31
    patch in 8 fetches per row instead of 31.
    """
    L, h, w = stack.shape
    n = 2 * radius + 1
    n4 = -(-n // 4)
    wx, wy = _moment_weights_rows(radius)
    wx, wy = jnp.asarray(wx), jnp.asarray(wy)
    xi = jnp.clip(xy[:, 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(xy[:, 1].astype(jnp.int32), 0, h - 1)
    dy = jnp.arange(-radius, radius + 1)
    dx0 = -radius + 4 * jnp.arange(n4)
    base = (lv * (h * w))[:, None, None]
    rows = jnp.clip(yi[:, None] + dy[None, :], 0, h - 1)     # [K, n]
    cols = jnp.clip(xi[:, None] + dx0[None, :], 0, w - 4)    # [K, n4]
    idx = base + rows[:, :, None] * w + cols[:, None, :]     # [K, n, n4]
    flat = stack.reshape(-1)
    run4 = jnp.stack([flat, jnp.roll(flat, -1), jnp.roll(flat, -2),
                      jnp.roll(flat, -3)], axis=-1)
    patch = run4[idx].reshape(xy.shape[0], n, n4 * 4)        # [K, n, 4*n4]
    m10 = jnp.einsum("knc,nc->k", patch, wx)
    m01 = jnp.einsum("knc,nc->k", patch, wy)
    return jnp.arctan2(m01, m10)


def describe_stacked(stack_blur: jnp.ndarray, lv: jnp.ndarray,
                     xy: jnp.ndarray, angles: jnp.ndarray) -> jnp.ndarray:
    """Rotated-BRIEF over a padded blurred pyramid stack (see
    keypoint_angles_stacked). Bilinear sampling, matching `describe`.

    The four bilinear taps come from ONE row-gather of a precomputed
    [L*h*w, 4] 2x2-neighborhood table: one 4-wide row gather instead of
    four scalar gathers."""
    L, h, w = stack_blur.shape
    pat = jnp.asarray(_PATTERN)
    c, s = jnp.cos(angles), jnp.sin(angles)
    px_, py_ = pat[..., 0], pat[..., 1]
    rx = c[:, None, None] * px_[None] - s[:, None, None] * py_[None]
    ry = s[:, None, None] * px_[None] + c[:, None, None] * py_[None]
    sx = jnp.clip(xy[:, None, None, 0] + rx, 0.0, w - 1.001)
    sy = jnp.clip(xy[:, None, None, 1] + ry, 0.0, h - 1.001)
    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    fx = sx - x0
    fy = sy - y0
    base = (lv * (h * w))[:, None, None]
    idx = base + y0 * w + x0
    flat = stack_blur.reshape(-1)
    # quad[i] = (flat[i], flat[i+1], flat[i+w], flat[i+w+1]); the wrapped
    # entries of roll land at indices never produced by the clips above
    quad = jnp.stack([flat, jnp.roll(flat, -1), jnp.roll(flat, -w),
                      jnp.roll(flat, -(w + 1))], axis=-1)
    v = quad[idx]                                   # [K, 256, 2, 4]
    vals = ((1 - fy) * ((1 - fx) * v[..., 0] + fx * v[..., 1])
            + fy * ((1 - fx) * v[..., 2] + fx * v[..., 3]))
    return (vals[..., 0] < vals[..., 1]).astype(jnp.int8)
