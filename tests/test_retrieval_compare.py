"""LSH-signature vs trained-vocabulary retrieval, measured head-to-head
on a sequence with PERCEPTUAL ALIASING.

The device loop closer retrieves with LSH min-intersection signatures
(slam_map/bow.py); the host path scores through the trained hierarchical
vocabulary + word-sparse inverted file (slam_map/vocabulary.py /
keyframe_db.py — the DBoW2 analog, reference:
/root/reference/src/KeyFrameDatabase.cc:581 DetectNBestCandidates).
Analytic equivalence arguments only go so far: with repeated structure
(two identical-looking regions) the two systems can rank a LOOK-ALIKE
above the true revisit differently. This test renders such a world,
replays a revisit trajectory, and reports recall@3 for both systems on
the same keyframe set — evidence ahead of
real-data parity.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras
from openmavis_jax.io import synthetic
from openmavis_jax.slam_map import bow, vocabulary as voc_mod

W, H = 320, 240
PIN = np.array([280.0, 280.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def _aliased_world():
    """Two regions with NEAR-identical blob constellations 24 m apart —
    perceptual aliasing as it occurs in reality (an imperfect copy: same
    constellation, slightly perturbed geometry). A pixel-identical twin
    would tie every score and the ranking would be decided by argsort
    order, not by the retrieval system."""
    rng = np.random.default_rng(99)
    base = synthetic.BlobWorld.create(seed=11, n=1200,
                                      box=((-6, 6), (-4, 4), (2, 10)))
    twin = synthetic.BlobWorld(
        points=(base.points + np.array([24.0, 0, 0], np.float32)
                + rng.normal(0, 0.08, base.points.shape).astype(
                    np.float32)),
        intensity=base.intensity, size=base.size)
    return synthetic.BlobWorld(
        points=np.concatenate([base.points, twin.points]),
        intensity=np.concatenate([base.intensity, twin.intensity]),
        size=np.concatenate([base.size, twin.size]))


def _trajectory():
    """Sweep region A -> region B (the look-alike) -> REVISIT region A.
    Every region-A revisit frame has both a true match (phase 1) and an
    aliased impostor (phase 2 frames look identical)."""
    xs = []
    # phase 1: region A left-to-right
    xs += [np.array([x, 0.0, 0.0]) for x in np.linspace(-3, 3, 12)]
    # phase 2: the twin region (identical appearance)
    xs += [np.array([24 + x, 0.0, 0.0]) for x in np.linspace(-3, 3, 12)]
    # phase 3: revisit region A from a DIFFERENT viewpoint (offset +
    # height change) — the true match must win on content, not on
    # pixel identity
    xs += [np.array([x, 0.35, -0.5]) for x in np.linspace(-3, 3, 12)]
    t = np.stack(xs).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (len(t), 1, 1))
    return R, t


def _keyframe_banks():
    world = _aliased_world()
    R_wc, t_wc = _trajectory()
    frames = synthetic.render_sequence(world, cameras.PINHOLE, PIN,
                                       R_wc, t_wc, W, H)
    cfg = extractor.OrbConfig(n_features=256, n_levels=4)
    descs, valids = [], []
    for f in frames:
        feats = extractor.extract(jnp.asarray(f), cfg)
        descs.append(np.asarray(feats.desc))
        valids.append(np.asarray(feats.valid))
    return np.stack(descs), np.stack(valids), t_wc


@pytest.fixture(scope="module")
def banks():
    return _keyframe_banks()


def _recall_at_3(scores_fn, t_wc, n, gap=6, radius=2.0):
    """Queries = phase-3 frames; a hit = any top-3 (excluding temporal
    neighbors) within `radius` m of the query pose."""
    hits = tries = 0
    impostor_ranks = 0
    for q in range(2 * n // 3, n):
        s = np.asarray(scores_fn(q), np.float64).copy()
        s[max(0, q - gap):] = -1e9          # exclude self + recent
        top3 = np.argsort(-s)[:3]
        d = np.linalg.norm(t_wc[top3] - t_wc[q], axis=1)
        tries += 1
        if (d < radius).any():
            hits += 1
        # impostor = best-ranked frame from the twin region
        if np.linalg.norm(t_wc[np.argmax(s)] - t_wc[q]) > 10.0:
            impostor_ranks += 1
    return hits / tries, impostor_ranks / tries


def test_lsh_vs_vocabulary_recall(banks):
    descs, valids, t_wc = banks
    n = len(descs)

    # --- LSH signatures (the device LC path) -------------------------
    sigs = np.stack([np.asarray(bow.histogram(jnp.asarray(d),
                                              jnp.asarray(v)))
                     for d, v in zip(descs, valids)])

    def lsh_scores(q):
        return bow.scores(jnp.asarray(sigs), jnp.asarray(sigs[q]))

    # --- trained vocabulary + tf-idf L1 (the DBoW2 analog) -----------
    train = descs[valids].reshape(-1, 256)[:6000]
    vocab = voc_mod.train(train, k=8, levels=2, iters=4, seed=0)
    vecs = np.stack([np.asarray(voc_mod.transform(
        vocab, jnp.asarray(d), jnp.asarray(v)))
        for d, v in zip(descs, valids)])

    def voc_scores(q):
        return voc_mod.l1_score(jnp.asarray(vecs),
                                jnp.asarray(vecs[q]))

    r_lsh, imp_lsh = _recall_at_3(lsh_scores, t_wc, n)
    r_voc, imp_voc = _recall_at_3(voc_scores, t_wc, n)
    print(f"\nretrieval under aliasing: recall@3 LSH={r_lsh:.2f} "
          f"(impostor-top rate {imp_lsh:.2f}), "
          f"vocab={r_voc:.2f} (impostor-top rate {imp_voc:.2f})")

    # both systems must find the true revisit in their top-3 most of
    # the time despite a pixel-identical impostor region; record the
    # numbers above for the flagship-retrieval decision
    assert r_lsh >= 0.6, f"LSH recall@3 {r_lsh}"
    assert r_voc >= 0.6, f"vocabulary recall@3 {r_voc}"
