"""Descriptor matching as masked dense Hamming matmuls.

JAX replacement for ORBmatcher (reference: src/ORBmatcher.cc — grid
-cell projection search, BoW-node brute force, knn with Lowe ratio, rotation
-histogram filtering; popcount Hamming in ORBmatcher.h:20).

The key idiom shift (SURVEY.md §7.0): descriptors are stored as {0,1} int8
planes of length 256, and Hamming distance becomes
``popcount(a ^ b) = |a| + |b| - 2 a.b`` — one matmul on the tensor cores —
with *all* search structure (spatial windows, per-camera bands, scale gates,
BoW nodes) expressed as additive masks on the distance matrix instead of
pointer-chasing grid cells.

Thresholds follow the reference: TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30
(src/ORBmatcher.cc top constants).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30

BIG = jnp.int32(1 << 20)


def hamming_matrix(d1: jnp.ndarray, d2: jnp.ndarray) -> jnp.ndarray:
    """[N, 256] x [M, 256] {0,1} int8 -> [N, M] int32 Hamming distances.

    Runs as a bf16 x bf16 -> f32 matmul: {0,1} entries are exact in bf16
    and row sums <= 256 are exact in f32, so the result is exact integer
    Hamming distance. XLA hands the product to cuBLAS and fuses the masked
    best-2 reduce behind it. Timed alone on an H100 at the per-frame
    program's shapes, this path, an int8 product and a fused Pallas kernel
    all sat at the per-call dispatch floor and could not be told apart;
    their share inside the per-frame program was not measured (PERF.md).
    """
    a = d1.astype(jnp.bfloat16)
    b = d2.astype(jnp.bfloat16)
    dot = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT)
    s1 = jnp.sum(d1.astype(jnp.int32), axis=-1)
    s2 = jnp.sum(d2.astype(jnp.int32), axis=-1)
    return s1[:, None] + s2[None, :] - 2 * dot.astype(jnp.int32)


_INVALID = 300  # > max possible Hamming distance (256); packs safely


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def masked_argmin(dist: jnp.ndarray, mask: jnp.ndarray):
    """Fast masked argmin per row via packed (value, index) min-reduce.

    Packing distance and column into one int32 and min-reducing gets the
    argmin in one reduce, with deterministic smallest-index tie-breaking. Distances are clamped to < _INVALID (valid
    Hamming is <= 256).
    Returns (best_idx [N], best [N]) with best == _INVALID where no valid col.
    """
    m = dist.shape[1]
    mp = _next_pow2(m)
    d = jnp.where(mask, jnp.minimum(dist, _INVALID - 1), _INVALID)
    cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    comb = d * mp + cols
    best_comb = jnp.min(comb, axis=1)
    return best_comb % mp, best_comb // mp


def masked_best2(dist: jnp.ndarray, mask: jnp.ndarray):
    """Best and second-best per row of a masked distance matrix.

    Returns (best_idx [N], best [N], second [N]); rows with no valid column
    give best == second == _INVALID. second is over *different columns*.
    """
    m = dist.shape[1]
    mp = _next_pow2(m)
    d = jnp.where(mask, jnp.minimum(dist, _INVALID - 1), _INVALID)
    cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    comb = d * mp + cols
    best_comb = jnp.min(comb, axis=1)
    best_idx = best_comb % mp
    best = best_comb // mp
    comb2 = jnp.where(cols == best_idx[:, None], _INVALID * mp + cols, comb)
    second = jnp.min(comb2, axis=1) // mp
    return best_idx, best, second


def mutual_filter(best_idx_12: jnp.ndarray, valid_12: jnp.ndarray,
                  best_idx_21: jnp.ndarray):
    """Keep matches where argmin(1->2) and argmin(2->1) agree."""
    back = jnp.take(best_idx_21, best_idx_12)
    return valid_12 & (back == jnp.arange(best_idx_12.shape[0]))


def rotation_histogram_filter(angle1: jnp.ndarray, angle2_matched: jnp.ndarray,
                              valid: jnp.ndarray,
                              n_bins: int = HISTO_LENGTH,
                              keep_bins: int = 3):
    """Keep only matches whose angle difference falls in the `keep_bins` most
    populated bins (reference: ORBmatcher::ComputeThreeMaxima,
    src/ORBmatcher.h:129)."""
    rot = (angle1 - angle2_matched) * (180.0 / jnp.pi)
    rot = jnp.mod(rot, 360.0)
    bins = jnp.clip((rot * n_bins / 360.0).astype(jnp.int32), 0, n_bins - 1)
    counts = jnp.zeros((n_bins,), jnp.int32).at[bins].add(
        valid.astype(jnp.int32))
    _, top_bins = jax.lax.top_k(counts, keep_bins)
    # the reference drops bins 2 and 3 if much smaller than bin 1 (<0.1x);
    # replicate that gate
    top_counts = counts[top_bins]
    bin_ok = top_counts.astype(jnp.float32) > 0.1 * top_counts[0]
    in_top = jnp.any(
        (bins[:, None] == top_bins[None, :]) & bin_ok[None, :], axis=1)
    return valid & in_top




def match_nn(d1, valid1, d2, valid2, max_dist: int = TH_LOW,
             ratio: float = 0.9, mutual: bool = True,
             extra_mask: jnp.ndarray | None = None):
    """Nearest-neighbour matching with Lowe ratio + optional mutual check.

    Args:
      d1, d2: [N,256]/[M,256] {0,1} int8 descriptors.
      valid1, valid2: validity masks.
      extra_mask: optional [N, M] bool of admissible pairs (spatial window,
        BoW node, band selection ...).
    Returns:
      (idx2 [N] int32 — match in d2 or -1, dist [N] int32)
    """
    mask = valid1[:, None] & valid2[None, :]
    if extra_mask is not None:
        mask = mask & extra_mask

    dist = hamming_matrix(d1, d2)
    bi, b, s = masked_best2(dist, mask)
    if mutual:
        bi21, _ = masked_argmin(dist.T, mask.T)

    ok = (b <= max_dist) & (b.astype(jnp.float32)
                            <= ratio * s.astype(jnp.float32))
    if mutual:
        ok = mutual_filter(bi, ok, bi21)
    return jnp.where(ok, bi, -1), jnp.where(ok, b, BIG)


def window_mask(xy1: jnp.ndarray, xy2: jnp.ndarray,
                radius) -> jnp.ndarray:
    """[N,2] x [M,2] -> [N,M] bool: chebyshev window |dx|,|dy| < r.

    `radius` may be scalar or per-row [N] (radius-by-viewing-angle /
    per-level radius, reference: ORBmatcher::SearchByProjection).
    """
    dx = jnp.abs(xy1[:, None, 0] - xy2[None, :, 0])
    dy = jnp.abs(xy1[:, None, 1] - xy2[None, :, 1])
    r = jnp.asarray(radius)
    if r.ndim == 1:
        r = r[:, None]
    return (dx < r) & (dy < r)


def level_mask(level1: jnp.ndarray, level2: jnp.ndarray,
               lo_off: int = -1, hi_off: int = 1) -> jnp.ndarray:
    """Scale-consistency gate: level2 in [level1+lo_off, level1+hi_off]."""
    l1 = level1[:, None]
    l2 = level2[None, :]
    return (l2 >= l1 + lo_off) & (l2 <= l1 + hi_off)


def match_projection(proj_xy, pred_level, radius, d_query, valid_query,
                     feat_xy, feat_level, feat_desc, feat_valid,
                     max_dist: int = TH_HIGH, ratio: float = 1.0):
    """Projection-guided search (map-points -> frame features).

    Equivalent of ORBmatcher::SearchByProjection (frame from map points):
    each query (projected map point) searches frame features within a
    spatial window, within +-1 pyramid level of the predicted level.

    Args:
      proj_xy: [N, 2] projected pixel positions of the queries.
      pred_level: [N] predicted pyramid level per query.
      radius: scalar or [N] search radius in level-0 pixels.
      d_query: [N, 256] query descriptors; valid_query [N].
      feat_*: frame feature arrays ([M, ...]).
    Returns (idx [N], dist [N]).
    """
    m = (window_mask(proj_xy, feat_xy, radius)
         & level_mask(pred_level, feat_level))
    return match_nn(d_query, valid_query, feat_desc, feat_valid,
                    max_dist=max_dist, ratio=ratio, mutual=False,
                    extra_mask=m)


def dedup_targets(idx: jnp.ndarray, dist: jnp.ndarray,
                  n_targets: int) -> jnp.ndarray:
    """Keep, per target column, only the query with minimal distance.

    idx: [N] target index or -1; dist: [N]. Returns idx with losers set -1.
    """
    safe_t = jnp.where(idx >= 0, idx, n_targets)  # overflow bin for -1
    best = jnp.full((n_targets + 1,), BIG, dtype=dist.dtype)
    best = best.at[safe_t].min(jnp.where(idx >= 0, dist, BIG))
    keep = (idx >= 0) & (dist <= best[safe_t])
    # break exact ties deterministically: first query index wins
    first = jnp.full((n_targets + 1,), idx.shape[0], dtype=jnp.int32)
    qi = jnp.arange(idx.shape[0], dtype=jnp.int32)
    first = first.at[safe_t].min(jnp.where(keep, qi, idx.shape[0]))
    keep = keep & (first[safe_t] == qi)
    return jnp.where(keep, idx, -1)
