"""LSH bag-of-words place-recognition signatures for device-side retrieval.

JAX replacement for the reference's DBoW2 vocabulary scoring at
map scale (reference: KeyFrameDatabase::DetectLoopCandidates /
DetectNBestCandidates, src/KeyFrameDatabase.cc:581; the DBoW2 vocabulary
tree quantizes each ORB descriptor to one of ~1M leaf words and scores
keyframes by L1 overlap of their word histograms).

A k-means vocabulary tree is a poor fit for a device program (pointer-chasing
descent, trained offline); the equivalent quantizer here is multi-table
LSH bucketing: each descriptor is hashed by `BITS` fixed pseudo-random
bit positions per table into one of 2**BITS buckets, and a keyframe's
signature is the concatenated bucket-count histogram over `N_TABLES`
tables ([W] = N_TABLES * 2**BITS). Retrieval score is histogram
min-intersection — the number of co-quantized feature occurrences, the
integer analog of DBoW2's L1 score on normalized vectors.

Why this scales where dense pairwise scoring does not: scoring one query
against every keyframe is O(K * W) elementwise (a few MB of elementwise traffic
at K=256) instead of O(K * F^2 / sub) Hamming matmuls, and the signature
is computed ONCE per keyframe at insertion (a single F-sized scatter-add)
rather than re-deriving pairwise evidence per retrieval. Precision is
recovered downstream: retrieval only nominates a candidate; the Sim3
RANSAC + group-projection + temporal chain (pipeline/streaming_lc.py)
does the verification, exactly as in the reference.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# 2 tables x 15 bits: at the flagship budget (2048 features/KF into
# 32768 buckets/table, ~6% occupancy) the expected random min-overlap is
# ~2 counts/kHz-bucket pair — two independent tables keep recall when a
# revisited descriptor flips a hashed bit (P[bucket stable | d bits
# changed] = (1 - d/256)^BITS per table).
N_TABLES = 2
BITS = 15
TABLE_W = 1 << BITS
W = N_TABLES * TABLE_W

# fixed pseudo-random bit positions (deterministic across processes AND
# library versions — signatures are part of serialized map state, so the
# derivation must not depend on any RNG's bit stream; SHA-256 of a fixed
# seed string is stable everywhere)
def _stable_positions(n_tables: int, bits: int) -> np.ndarray:
    import hashlib

    tables = []
    for t in range(n_tables):
        chosen: list[int] = []
        seen: set[int] = set()
        ctr = 0
        while len(chosen) < bits:
            digest = hashlib.sha256(
                f"openmavis-bow-{t}-{ctr}".encode()).digest()
            ctr += 1
            for byte in digest:
                if byte not in seen:
                    seen.add(byte)
                    chosen.append(byte)
                    if len(chosen) == bits:
                        break
        tables.append(sorted(chosen))
    return np.asarray(tables, np.int64)


_POS = _stable_positions(N_TABLES, BITS)  # [N_TABLES, BITS]
_POW2 = (1 << np.arange(BITS)).astype(np.int32)


def word_ids(desc: jnp.ndarray) -> jnp.ndarray:
    """[..., 256] {0,1} descriptors -> [..., N_TABLES] flat word ids in
    [0, W)."""
    bits = desc[..., jnp.asarray(_POS)].astype(jnp.int32)  # [...,T,B]
    idx = jnp.einsum("...tb,b->...t", bits, jnp.asarray(_POW2))
    return idx + jnp.arange(N_TABLES, dtype=jnp.int32) * TABLE_W


def histogram(desc: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """BoW signature of one keyframe.

    desc [F, 256] int8 {0,1}, valid [F] bool -> [W] int8 bucket counts
    (clipped at 127; counts above that carry no extra evidence).
    """
    ids = word_ids(desc)                                   # [F, T]
    ids = jnp.where(valid[:, None], ids, W)                # overflow bin
    h = jnp.zeros((W + 1,), jnp.int32).at[ids.reshape(-1)].add(1)[:W]
    return jnp.clip(h, 0, 127).astype(jnp.int8)


def scores(kf_bow: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Min-intersection retrieval scores.

    kf_bow [K, W] int8, q [W] int8 -> [K] int32 shared-word-occurrence
    counts (the DBoW2 L1-overlap analog on raw counts).
    """
    return jnp.sum(jnp.minimum(kf_bow, q[None, :]).astype(jnp.int32),
                   axis=1)
