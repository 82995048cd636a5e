"""Sharded place recognition: keyframe descriptor banks partitioned over a
device mesh.

The north-star scale-out of the reference's KeyFrameDatabase (SURVEY.md §2.3
/ BASELINE.json: "DBoW2 place-recognition scoring becomes a sharded matrix
lookup"): each device holds a shard of the keyframe descriptor bank, scores
the query against its shard with one matmul, and the per-keyframe scores are
gathered — one collective per query.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..frontend import matcher


def sharded_place_scores(mesh: Mesh, kf_desc, kf_feat_valid, kf_valid,
                         q_desc, q_valid, axis: str = "kf"):
    """Scores [K]: per keyframe, #query features with best Hamming < TH_LOW.

    kf_desc [K, F, 256] is sharded over the mesh axis; the query is
    replicated. K must be divisible by the mesh size (use padded slabs).
    """
    def local(kf_desc_s, kf_fv_s, kf_v_s, q_desc_r, q_valid_r):
        Ks, F = kf_fv_s.shape
        dist = matcher.hamming_matrix(
            q_desc_r, kf_desc_s.reshape(Ks * F, 256)).reshape(-1, Ks, F)
        t_valid = kf_fv_s & kf_v_s[:, None]
        dist = jnp.where(t_valid[None], dist, 1 << 20)
        best = jnp.min(dist, axis=2)
        good = (best < matcher.TH_LOW) & q_valid_r[:, None]
        return jnp.sum(good.astype(jnp.int32), axis=0)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(axis))
    return fn(kf_desc, kf_feat_valid, kf_valid, q_desc, q_valid)
