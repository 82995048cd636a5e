"""BoW LSH place-recognition signatures (slam_map/bow.py) and their
wiring into MapState + device retrieval (streaming_lc._retrieval_scores).

Reference parity target: KeyFrameDatabase BoW scoring,
/root/reference/src/KeyFrameDatabase.cc:581."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.slam_map import bow, map_state as ms


def _rand_desc(rng, n=256):
    return rng.integers(0, 2, (n, 256)).astype(np.int8)


def _flip(rng, d, nbits):
    out = d.copy()
    for i in range(out.shape[0]):
        idx = rng.choice(256, nbits, replace=False)
        out[i, idx] ^= 1
    return out


def test_histogram_counts():
    rng = np.random.default_rng(0)
    d = _rand_desc(rng, 300)
    v = np.zeros(300, bool)
    v[:200] = True
    h = bow.histogram(jnp.asarray(d), jnp.asarray(v))
    assert h.shape == (bow.W,)
    assert int(h.astype(jnp.int32).sum()) == 200 * bow.N_TABLES


def test_scores_discriminate():
    """A revisited keyframe (same scene, few descriptor bits flipped)
    must out-score an unrelated one by a wide margin."""
    rng = np.random.default_rng(1)
    d = _rand_desc(rng, 512)
    v = np.ones(512, bool)
    h_q = bow.histogram(jnp.asarray(d), jnp.asarray(v))
    h_re = bow.histogram(jnp.asarray(_flip(rng, d, 12)), jnp.asarray(v))
    h_un = bow.histogram(jnp.asarray(_rand_desc(rng, 512)),
                         jnp.asarray(v))
    s = np.asarray(bow.scores(jnp.stack([h_re, h_un]), h_q))
    assert s[0] > 5 * max(s[1], 1)
    assert s[0] > 100


def test_mapstate_bow_insert_and_compact():
    rng = np.random.default_rng(2)
    m = ms.allocate(6, 128, 512)
    descs = [_rand_desc(rng, 128) for _ in range(4)]
    for k in range(4):
        m = ms.insert_keyframe(
            m, k, jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.zeros(3),
            jnp.zeros(3), float(k), jnp.zeros((128, 2)),
            jnp.asarray(descs[k]), jnp.zeros(128, jnp.int32),
            jnp.ones(128), jnp.zeros(128, jnp.int32),
            jnp.ones(128, bool), jnp.full(128, -1, jnp.int32))
    for k in range(4):
        expect = bow.histogram(jnp.asarray(descs[k]),
                               jnp.ones(128, bool))
        np.testing.assert_array_equal(np.asarray(m.kf_bow[k]),
                                      np.asarray(expect))
    # cull keyframe 1 and compact: rows shift, signatures follow
    m = m._replace(kf_valid=m.kf_valid.at[1].set(False))
    m2, _, _ = jax.jit(ms.compact_keyframes)(m)
    assert int(m2.n_kf) == 3
    for new, old in [(0, 0), (1, 2), (2, 3)]:
        np.testing.assert_array_equal(np.asarray(m2.kf_bow[new]),
                                      np.asarray(m.kf_bow[old]))
    assert int(m2.kf_bow[3].astype(jnp.int32).sum()) == 0


def test_device_retrieval_prefers_revisit():
    """streaming_lc retrieval must rank the revisited keyframe first at a
    map size where the old dense pairwise path would be prohibitive."""
    from openmavis_jax.pipeline import streaming_lc

    rng = np.random.default_rng(3)
    K, F = 96, 128
    m = ms.allocate(K, F, 512)
    base = _rand_desc(rng, F)
    for k in range(K):
        d = _flip(rng, base, 16) if k == 5 else _rand_desc(rng, F)
        if k == K - 1:
            d = _flip(rng, base, 10)      # query: revisit of slot 5
        m = ms.insert_keyframe(
            m, k, jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.zeros(3),
            jnp.zeros(3), float(k), jnp.zeros((F, 2)), jnp.asarray(d),
            jnp.zeros(F, jnp.int32), jnp.ones(F), jnp.zeros(F, jnp.int32),
            jnp.ones(F, bool), jnp.full(F, -1, jnp.int32))
    sc = np.asarray(streaming_lc._retrieval_scores(m, K - 1))
    order = np.argsort(sc[:K - 1])[::-1]
    assert order[0] == 5
    assert sc[5] > 5 * max(sc[order[1]], 1)
