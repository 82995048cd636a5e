"""DBoW2 text-format vocabulary ingestion (slam_map/vocabulary.py).

Reference parity target: TemplatedVocabulary::loadFromTextFile
(/root/reference/Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1338) — the
format the stock ORBvoc.txt ships in (include/ORBVocabulary.h:9). The
tests cover: (1) round-trip of our own trained vocabulary through the
text format with bit-exact transform/score parity; (2) hand-written
INCOMPLETE trees (missing children, leaves above the bottom level) —
the shapes DBoW2 training actually produces — descending to the right
words; (3) the System-facing `load()` dispatch on `.txt`.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from openmavis_jax.slam_map import vocabulary as voc_mod


def _rand_desc(rng, n):
    return rng.integers(0, 2, (n, 256)).astype(np.int8)


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(0)
    desc = _rand_desc(rng, 600)
    return voc_mod.train(desc, k=3, levels=2, iters=4, seed=0), desc


def test_text_roundtrip_transform_parity(trained, tmp_path):
    """save_dbow2_text -> load_dbow2_text must reproduce the SAME BoW
    vectors and L1 scores as the in-memory vocabulary."""
    vocab, desc = trained
    p = tmp_path / "voc.txt"
    voc_mod.save_dbow2_text(str(p), vocab)
    vocab2 = voc_mod.load_dbow2_text(str(p))
    assert vocab2.k == vocab.k
    assert vocab2.n_words == vocab.n_words

    rng = np.random.default_rng(1)
    q = jnp.asarray(_rand_desc(rng, 64))
    valid = jnp.ones((64,), bool)
    v1 = voc_mod.transform(vocab, q, valid)
    v2 = voc_mod.transform(vocab2, q, valid)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2),
                               atol=1e-6)
    w1 = voc_mod.word_ids(vocab, q)
    w2 = voc_mod.word_ids(vocab2, q)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    s = voc_mod.l1_score(v1, v2)
    assert float(s) > 0.999


def _write_lines(path, k, L, nodes):
    """nodes: list of (parent, is_leaf, bits [256] {0,1}, weight)."""
    lines = [f"{k} {L} 0 0"]
    for parent, is_leaf, bits, w in nodes:
        packed = np.packbits(np.asarray(bits, np.uint8),
                             bitorder="little")
        byte_str = " ".join(str(int(b)) for b in packed)
        lines.append(f"{parent} {int(is_leaf)} {byte_str} {w}")
    path.write_text("\n".join(lines) + "\n")


def _bits(fill):
    b = np.zeros(256, np.int8)
    b[:] = 0
    for i in fill:
        b[i] = 1
    return b


def test_incomplete_tree_missing_children(tmp_path):
    """A node with fewer than k children: padded slots must never win
    the argmin descent (DBoW2 walks only the real children)."""
    k, L = 3, 1
    # root with TWO children (slot 2 missing): word 0 near-zero bits,
    # word 1 with bits 0..127 set
    n0 = _bits([0])
    n1 = _bits(range(128))
    p = tmp_path / "voc.txt"
    _write_lines(p, k, L, [(0, 1, n0, 0.5), (0, 1, n1, 0.25)])
    vocab = voc_mod.load_dbow2_text(str(p))
    assert vocab.n_words == k  # dense capacity

    q = jnp.asarray(np.stack([n0, n1, _bits(range(100))]))
    words = voc_mod.word_ids(vocab, q)
    # descriptor equal to word 0 -> word 0; near word 1 -> word 1;
    # never the padded slot 2
    assert int(words[0]) == 0
    assert int(words[1]) == 1
    assert int(words[2]) == 1
    assert int(jnp.max(words)) < 2
    np.testing.assert_allclose(np.asarray(vocab.idf[:2]), [0.5, 0.25])


def test_leaf_above_bottom_level(tmp_path):
    """A leaf at level 0 of an L=2 tree: descent must still reach a
    unique bottom-level word carrying that leaf's weight."""
    k, L = 2, 2
    lf = _bits(range(200, 256))          # leaf directly under the root
    inner = _bits(range(0, 64))          # internal node
    c0 = _bits(range(0, 32))             # its two children (words)
    c1 = _bits(range(32, 96))
    p = tmp_path / "voc.txt"
    _write_lines(p, k, L, [
        (0, 1, lf, 0.7),     # node 1: leaf at level 0
        (0, 0, inner, 0.0),  # node 2: internal at level 0
        (2, 1, c0, 0.4),     # node 3
        (2, 1, c1, 0.3),     # node 4
    ])
    vocab = voc_mod.load_dbow2_text(str(p))

    q = jnp.asarray(np.stack([lf, c0, c1]))
    words = np.asarray(voc_mod.word_ids(vocab, q))
    # the shallow leaf resolves to ONE fixed bottom word with weight 0.7
    idf = np.asarray(vocab.idf)
    assert idf[words[0]] == pytest.approx(0.7)
    assert idf[words[1]] == pytest.approx(0.4)
    assert idf[words[2]] == pytest.approx(0.3)
    assert len({int(w) for w in words}) == 3

    # transform: one descriptor per word -> tf-idf proportional to idf
    v = np.asarray(voc_mod.transform(vocab, q, jnp.ones((3,), bool)))
    nz = v[v > 0]
    assert len(nz) == 3
    np.testing.assert_allclose(np.sort(nz),
                               np.sort([0.7, 0.4, 0.3]) / 1.4,
                               atol=1e-6)


def test_load_dispatches_on_txt(trained, tmp_path):
    vocab, _ = trained
    p = tmp_path / "ORBvoc.txt"
    voc_mod.save_dbow2_text(str(p), vocab)
    v2, md5 = voc_mod.load(str(p))
    assert v2.n_words == vocab.n_words
    assert isinstance(md5, str) and len(md5) == 32
