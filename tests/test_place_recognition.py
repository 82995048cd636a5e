"""Vocabulary, keyframe DB, and pose-graph tests."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.geometry import lie
from openmavis_jax.optim import pose_graph
from openmavis_jax.slam_map import keyframe_db, vocabulary


def random_desc(key, n):
    return jax.random.bernoulli(key, 0.5, (n, 256)).astype(jnp.int8)


def perturb(desc, key, flips=10):
    noise = jax.random.bernoulli(key, flips / 256.0, desc.shape)
    return jnp.abs(desc - noise.astype(jnp.int8))


class TestVocabulary:
    def test_train_and_transform(self):
        key = jax.random.PRNGKey(0)
        desc = random_desc(key, 2000)
        vocab = vocabulary.train(np.asarray(desc), k=6, levels=3, iters=4)
        assert vocab.n_words == 6 ** 3
        v = vocabulary.transform(vocab, desc[:300],
                                 jnp.ones(300, bool))
        assert abs(float(jnp.sum(jnp.abs(v))) - 1.0) < 1e-4

    def test_similar_images_score_higher(self):
        key = jax.random.PRNGKey(1)
        desc_a = random_desc(key, 1500)
        vocab = vocabulary.train(np.asarray(desc_a), k=6, levels=3)
        img1 = desc_a[:300]
        img1_again = perturb(img1, jax.random.PRNGKey(2), flips=8)
        img_other = random_desc(jax.random.PRNGKey(3), 300)
        ones = jnp.ones(300, bool)
        v1 = vocabulary.transform(vocab, img1, ones)
        v2 = vocabulary.transform(vocab, img1_again, ones)
        v3 = vocabulary.transform(vocab, img_other, ones)
        s_same = float(vocabulary.l1_score(v1, v2))
        s_diff = float(vocabulary.l1_score(v1, v3))
        # uniform random descriptors give a high similarity floor at this
        # vocab size; the discriminative signal is the separation
        assert s_same > s_diff + 0.15, (s_same, s_diff)

    def test_word_ids_stable_under_noise(self):
        key = jax.random.PRNGKey(4)
        desc = random_desc(key, 1000)
        vocab = vocabulary.train(np.asarray(desc), k=6, levels=2)
        w1 = vocabulary.word_ids(vocab, desc[:200])
        w2 = vocabulary.word_ids(
            vocab, perturb(desc[:200], jax.random.PRNGKey(5), flips=4))
        assert float((w1 == w2).mean()) > 0.6


class TestKeyframeDB:
    def test_query_finds_revisit(self):
        key = jax.random.PRNGKey(6)
        base = random_desc(key, 3000)
        vocab = vocabulary.train(np.asarray(base), k=6, levels=3)
        ones = jnp.ones(300, bool)
        db = keyframe_db.allocate(16, vocab.n_words)
        views = []
        for i in range(8):
            view = base[i * 300:(i + 1) * 300]
            views.append(view)
            db = keyframe_db.add(
                db, i, vocabulary.transform(vocab, view, ones))
        # query = noisy revisit of keyframe 2
        q = vocabulary.transform(
            vocab, perturb(views[2], jax.random.PRNGKey(7), 8), ones)
        exclude = jnp.zeros(16, bool).at[7].set(True)  # "current" KF
        scores, top, ok = keyframe_db.query(db, q, exclude,
                                            jnp.asarray(0.0))
        assert int(top[0]) == 2
        assert bool(ok[0])


class TestPoseGraph:
    def test_loop_closure_corrects_drift(self):
        """Odometry chain with accumulated drift + one loop edge: after
        optimization the loop must close (first ~= last pose)."""
        K = 20
        rng = np.random.default_rng(0)
        # ground truth: circle
        s_gt = np.ones(K, np.float32)
        R_gt, t_gt = [], []
        for k in range(K):
            ang = 2 * np.pi * k / K
            R_gt.append(np.asarray(lie.so3_exp(
                jnp.asarray([0, 0, ang], dtype=jnp.float32))))
            t_gt.append(np.asarray([np.cos(ang), np.sin(ang), 0.0],
                                   dtype=np.float32))
        R_gt = np.stack(R_gt)
        t_gt = np.stack(t_gt)

        # drifted estimate: integrate noisy relative motions
        s_est = [1.0]
        R_est = [R_gt[0]]
        t_est = [t_gt[0]]
        for k in range(1, K):
            dR = R_gt[k] @ R_gt[k - 1].T
            dt_ = t_gt[k] - dR @ t_gt[k - 1]
            # noise + slight scale drift
            dR = dR @ np.asarray(lie.so3_exp(jnp.asarray(
                0.02 * rng.standard_normal(3), dtype=jnp.float32)))
            dt_ = dt_ + 0.02 * rng.standard_normal(3).astype(np.float32)
            ds = 1.01
            s_est.append(s_est[-1] * ds)
            R_est.append(dR @ R_est[-1])
            t_est.append(ds * (dR @ t_est[-1]) + dt_)
        s_est = jnp.asarray(np.asarray(s_est, np.float32))
        R_est = jnp.asarray(np.stack(R_est))
        t_est = jnp.asarray(np.stack(t_est))

        # edges: sequential (from drifted odometry, i.e. consistent with the
        # estimate) + loop edge K-1 -> 0 with the TRUE relative transform
        seq = pose_graph.sequential_edges(s_est, R_est, t_est,
                                          jnp.asarray(K), K)
        dR_loop = R_gt[0] @ R_gt[K - 1].T
        dt_loop = t_gt[0] - dR_loop @ t_gt[K - 1]
        loop = pose_graph.PoseGraphEdges(
            i=jnp.asarray([K - 1]), j=jnp.asarray([0]),
            s=jnp.asarray([1.0]),
            R=jnp.asarray(dR_loop)[None],
            t=jnp.asarray(dt_loop)[None],
            weight=jnp.asarray([5.0]), valid=jnp.asarray([True]))
        edges = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b]), seq, loop)

        fixed = jnp.zeros(K, bool).at[0].set(True)
        s_o, R_o, t_o, chi = pose_graph.optimize_pose_graph(
            s_est, R_est, t_est, edges, fixed, jnp.ones(K, bool),
            iters=15)

        # loop closed: residual of the loop edge should be small
        r_before = float(jnp.linalg.norm(lie.sim3_log(
            *lie.sim3_compose(*lie.sim3_inverse(
                jnp.asarray([1.0])[0], jnp.asarray(dR_loop),
                jnp.asarray(dt_loop)),
                *lie.sim3_compose(s_est[0], R_est[0], t_est[0],
                                  *lie.sim3_inverse(s_est[K-1],
                                                    R_est[K-1],
                                                    t_est[K-1]))))))
        r_after = float(jnp.linalg.norm(lie.sim3_log(
            *lie.sim3_compose(*lie.sim3_inverse(
                jnp.asarray([1.0])[0], jnp.asarray(dR_loop),
                jnp.asarray(dt_loop)),
                *lie.sim3_compose(s_o[0], R_o[0], t_o[0],
                                  *lie.sim3_inverse(s_o[K-1], R_o[K-1],
                                                    t_o[K-1]))))))
        assert r_after < 0.1 * r_before, (r_before, r_after)
        # scale drift removed
        assert abs(float(s_o[K - 1]) - 1.0) < 0.05


class TestSparseKeyframeDB:
    """Word-sparse inverted-file scoring (reference:
    src/KeyFrameDatabase.cc:581 — memory bounded by top-W
    pairs per keyframe, independent of vocabulary size)."""

    def test_sparse_matches_dense_scores(self):
        key = jax.random.PRNGKey(0)
        pool = random_desc(key, 1500)
        vocab = vocabulary.train(np.asarray(pool), k=6, levels=2)
        F, K = 128, 12
        dense_db = keyframe_db.allocate(K, vocab.n_words)
        sparse_db = keyframe_db.allocate_sparse(K, top_w=F)
        ones = jnp.ones(F, bool)
        banks = [perturb(pool[40 * i:40 * i + F], jax.random.PRNGKey(i),
                         flips=6) for i in range(K)]
        for i, d in enumerate(banks):
            dense_db = keyframe_db.add(
                dense_db, i, vocabulary.transform(vocab, d, ones))
            w, wt = vocabulary.transform_sparse(vocab, d, ones, F)
            sparse_db = keyframe_db.add_sparse(sparse_db, i, w, wt)
        q = banks[3]
        vq = vocabulary.transform(vocab, q, ones)
        s_dense = vocabulary.l1_score(dense_db.bow, vq[None])
        wq, wtq = vocabulary.transform_sparse(vocab, q, ones, F)
        s_sparse = keyframe_db.scores_sparse(sparse_db, wq, wtq,
                                             vocab.n_words)
        # with top_w = F every nonzero survives -> scores are identical
        np.testing.assert_allclose(np.asarray(s_sparse),
                                   np.asarray(s_dense), atol=1e-5)

    def test_pairwise_sparse_score_is_l1(self):
        key = jax.random.PRNGKey(5)
        pool = random_desc(key, 1200)
        vocab = vocabulary.train(np.asarray(pool), k=6, levels=2)
        ones = jnp.ones(100, bool)
        a, b = pool[:100], perturb(pool[:100], jax.random.PRNGKey(6), 8)
        va = vocabulary.transform(vocab, a, ones)
        vb = vocabulary.transform(vocab, b, ones)
        wa, wta = vocabulary.transform_sparse(vocab, a, ones, 100)
        wb, wtb = vocabulary.transform_sparse(vocab, b, ones, 100)
        s_ref = float(vocabulary.l1_score(va, vb))
        s_sp = float(vocabulary.l1_score_sparse(wa, wta, wb, wtb,
                                                vocab.n_words))
        assert abs(s_ref - s_sp) < 1e-5

    @__import__('pytest').mark.slow
    def test_retrieval_at_scale_revisit(self):
        """K=256 keyframes x 2048-feature banks, 10k-word (k=10, L=4)
        vocabulary: the second pass over 32 places must retrieve its
        first-pass counterpart, with precision >= the dense-matrix
        path."""
        import pytest
        pytest.importorskip("jax")
        rng = np.random.RandomState(0)
        n_places, F, K = 32, 2048, 64
        pools = (rng.rand(n_places, 4096, 256) > 0.5).astype(np.int8)

        def bank(place, seed):
            r = np.random.RandomState(seed)
            sel = r.permutation(4096)[:F]
            d = pools[place][sel]
            flip = r.rand(F, 256) < 0.02
            return np.abs(d - flip.astype(np.int8))

        # train on first-pass data only
        train_desc = np.concatenate(
            [bank(p, p)[:400] for p in range(n_places)])
        vocab = vocabulary.train(train_desc, k=10, levels=4, iters=4)
        assert vocab.n_words == 10_000

        W = 512
        db = keyframe_db.allocate_sparse(K, top_w=W)
        ones = jnp.ones(F, bool)
        tr = jax.jit(lambda d: vocabulary.transform_sparse(
            vocab, d, ones, W))
        for p in range(n_places):           # first pass: fill the DB
            w, wt = tr(jnp.asarray(bank(p, p)))
            db = keyframe_db.add_sparse(db, p, w, wt)
        # memory bound: the database holds 2 * K * W values, NOT
        # K * n_words
        assert db.wt.size == K * W < K * vocab.n_words

        hits = 0
        for p in range(n_places):           # second pass: revisit
            w, wt = tr(jnp.asarray(bank(p, 1000 + p)))
            scores, top, ok = keyframe_db.query_sparse(
                db, w, wt, jnp.zeros(K, bool), jnp.zeros(()),
                vocab.n_words)
            hits += int(np.asarray(top)[0] == p)
        assert hits >= int(0.9 * n_places), hits


def test_vocabulary_save_load_roundtrip(tmp_path):
    """Persistent vocabulary with content-hash binding (reference: the
    shipped ORBvoc + MD5 binding, System.cc:1520-1556)."""
    import numpy as np
    from openmavis_jax.slam_map import vocabulary as voc

    rng = np.random.default_rng(0)
    desc = rng.integers(0, 2, (4000, 256)).astype(np.int8)
    v = voc.train(desc, k=4, levels=3)
    path = str(tmp_path / "voc.npz")
    digest = voc.save(path, v)
    v2, digest2 = voc.load(path)
    assert digest == digest2 and len(digest) == 32
    assert v2.n_words == v.n_words and v2.k == v.k
    # identical quantization after the roundtrip
    q = rng.integers(0, 2, (64, 256)).astype(np.int8)
    import jax.numpy as jnp
    np.testing.assert_array_equal(
        np.asarray(voc.word_ids(v, jnp.asarray(q))),
        np.asarray(voc.word_ids(v2, jnp.asarray(q))))
    # corruption is refused
    import numpy as _np
    data = dict(_np.load(path))
    data["idf"] = data["idf"] + 1.0
    _np.savez_compressed(path, **data)
    try:
        voc.load(path)
        assert False, "corrupt vocabulary accepted"
    except ValueError:
        pass
