"""Keyframe database: place recognition as a dense BoW score matmul.

JAX replacement for the reference's KeyFrameDatabase (reference:
src/KeyFrameDatabase.cc — BoW inverted file with shared-word counting,
covisibility-group score accumulation, DetectNBestCandidates at .cc:581,
DetectRelocalizationCandidates at .cc:715). The inverted file becomes a
dense [K, n_words] tf-idf matrix; a query is one matvec; the
covisibility-consistency gating uses the on-demand covisibility matrix.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import map_state as ms
from . import vocabulary as voc


class KeyframeDB(NamedTuple):
    bow: jnp.ndarray      # [K, n_words] L1-normalized tf-idf per keyframe
    valid: jnp.ndarray    # [K]


def allocate(max_kf: int, n_words: int) -> KeyframeDB:
    return KeyframeDB(bow=jnp.zeros((max_kf, n_words), jnp.float32),
                      valid=jnp.zeros((max_kf,), bool))


def add(db: KeyframeDB, slot, bow_vec) -> KeyframeDB:
    return KeyframeDB(bow=db.bow.at[slot].set(bow_vec),
                      valid=db.valid.at[slot].set(True))


@jax.jit
def query(db: KeyframeDB, bow_vec: jnp.ndarray,
          exclude: jnp.ndarray, min_score: jnp.ndarray):
    """Loop/relocalization candidates by BoW similarity.

    Args:
      bow_vec: [n_words] query.
      exclude: [K] bool — connected/recent keyframes to skip
        (the reference excludes the covisibility group of the query,
        KeyFrameDatabase.cc:589-607).
      min_score: score floor (the reference uses the minimum score to the
        query's covisible keyframes).
    Returns (scores [K], top3 idx [3], top3 ok [3]).
    """
    scores = voc.l1_score(db.bow, bow_vec[None, :])
    scores = jnp.where(db.valid & ~exclude, scores, -1.0)
    top_scores, top_idx = jax.lax.top_k(scores, 3)
    ok = top_scores > jnp.maximum(min_score, 0.0)
    return scores, top_idx, ok


def min_covisible_score(db: KeyframeDB, bow_vec, cov_row,
                        cov_threshold: int = 15):
    """Reference semantics (LoopClosing.cc / KeyFrameDatabase.cc:589): the
    candidate score floor is the min BoW score between the query and its
    covisible keyframes (>= cov_threshold shared points)."""
    neigh = cov_row >= cov_threshold
    scores = voc.l1_score(db.bow, bow_vec[None, :])
    neigh_scores = jnp.where(neigh & db.valid, scores, jnp.inf)
    mn = jnp.min(neigh_scores)
    return jnp.where(jnp.isfinite(mn), mn, 0.0)


# -- word-sparse database (inverted-file semantics, bounded memory) --------
#
# The dense [K, n_words] matrix above cannot grow to DBoW2's k=10 L>=4
# vocabularies (10^4..10^6 words). The sparse layout stores, per keyframe,
# its top-W (word id, tf-idf weight) pairs — at most F nonzeros exist — and
# scores a query by scattering the QUERY into a dense [n_words] vector once
# (transient, inside jit), then gathering it at every stored word id:
# score[k] = sum_j min(db_wt[k, j], q_dense[db_word[k, j]]). That is the
# reference's inverted-file accumulation (src/KeyFrameDatabase.cc:581)
# with the roles transposed: O(K * W) work, O(K * W) memory, one gather.


class SparseKeyframeDB(NamedTuple):
    word: jnp.ndarray     # [K, W] int32 word ids (pad slots: wt == 0)
    wt: jnp.ndarray       # [K, W] f32 L1-normalized tf-idf weights
    valid: jnp.ndarray    # [K]


def allocate_sparse(max_kf: int, top_w: int) -> SparseKeyframeDB:
    return SparseKeyframeDB(
        word=jnp.zeros((max_kf, top_w), jnp.int32),
        wt=jnp.zeros((max_kf, top_w), jnp.float32),
        valid=jnp.zeros((max_kf,), bool))


def add_sparse(db: SparseKeyframeDB, slot, word, wt) -> SparseKeyframeDB:
    return db._replace(word=db.word.at[slot].set(word),
                       wt=db.wt.at[slot].set(wt),
                       valid=db.valid.at[slot].set(True))


@partial(jax.jit, static_argnames=("n_words",))
def scores_sparse(db: SparseKeyframeDB, q_word, q_wt, n_words: int):
    """L1 similarity of the query against every stored keyframe.

    min-intersection form of the DBoW2 L1 score (see
    vocabulary.l1_score_sparse): the query scatters into a transient
    dense [n_words] vector, which is gathered at each stored word id —
    one gather + segment-sum, O(K*W), independent of vocabulary size in
    memory held per keyframe."""
    # .max, not .set: pad slots alias word id 0 with weight 0 and
    # must not clobber a real word-0 weight
    q_dense = jnp.zeros((n_words,), jnp.float32).at[q_word].max(q_wt)
    return jnp.sum(jnp.minimum(db.wt, q_dense[db.word]), axis=-1)


@partial(jax.jit, static_argnames=("n_words",))
def query_sparse(db: SparseKeyframeDB, q_word, q_wt,
                 exclude: jnp.ndarray, min_score: jnp.ndarray,
                 n_words: int):
    """Loop/relocalization candidates by sparse BoW similarity.
    Same contract as `query`; q_word/q_wt from voc.transform_sparse."""
    scores = scores_sparse(db, q_word, q_wt, n_words)
    scores = jnp.where(db.valid & ~exclude, scores, -1.0)
    top_scores, top_idx = jax.lax.top_k(scores, 3)
    ok = top_scores > jnp.maximum(min_score, 0.0)
    return scores, top_idx, ok


@partial(jax.jit, static_argnames=("n_words", "cov_threshold"))
def min_covisible_score_sparse(db: SparseKeyframeDB, q_word, q_wt,
                               cov_row, n_words: int,
                               cov_threshold: int = 15):
    """Sparse analog of min_covisible_score (KeyFrameDatabase.cc:589)."""
    neigh = cov_row >= cov_threshold
    scores = scores_sparse(db, q_word, q_wt, n_words)
    neigh_scores = jnp.where(neigh & db.valid, scores, jnp.inf)
    mn = jnp.min(neigh_scores)
    return jnp.where(jnp.isfinite(mn), mn, 0.0)
