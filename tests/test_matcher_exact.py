"""The XLA Hamming best-2 matcher against a numpy popcount reference.

`matcher.hamming_matrix` + `masked_best2` (and `match_nn` on top) must give
exactly what popcount(a XOR b) gives: {0,1} planes in bf16 with a float32
accumulator are exact, so the comparison is bit-exact, not a tolerance.
Reference behaviour: ORBmatcher's best/second-best Hamming search with
admissibility masks (src/ORBmatcher.cc SearchByProjection / SearchByBoW).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import reference_best2
from openmavis_jax.frontend import matcher


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "small":
        n, m, p = 96, 200, 0.3
    elif name == "unaligned":
        n, m, p = 130, 517, 0.5
    elif name == "all_masked":
        n, m, p = 64, 64, 1.1
    else:                      # ties: identical targets
        n, m, p = 8, 32, 0.0
    d1 = (rng.random((n, 256)) < 0.5).astype(np.int8)
    d2 = (rng.random((m, 256)) < 0.5).astype(np.int8)
    mask = rng.random((n, m)) >= p
    if name == "ties":
        d2 = np.tile(d1[:1], (m, 1))
        mask[:, :3] = False            # forbid cols 0-2
    return d1, d2, mask


@pytest.mark.parametrize("name", ["small", "unaligned", "all_masked",
                                  "ties"])
def test_best2_matches_popcount_reference(name):
    d1, d2, mask = _case(name)
    dist = matcher.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2))
    bi, b, s = (np.asarray(x) for x in
                matcher.masked_best2(dist, jnp.asarray(mask)))
    rbi, rb, rs, rdist = reference_best2(d1, d2, mask)
    np.testing.assert_array_equal(np.asarray(dist), rdist)
    has = rb < 300
    np.testing.assert_array_equal(bi[has], rbi[has])
    np.testing.assert_array_equal(b, rb)
    np.testing.assert_array_equal(s, rs)
    if name == "all_masked":
        assert not has.any() and (s == 300).all()
    if name == "ties":
        # all targets are equal: the smallest admissible index wins and
        # the second best is another column at the same distance
        assert (bi == 3).all() and (s == b).all() and b[0] == 0

    # match_nn on top: accepted matches are the reference's, under its
    # threshold, ratio and mutual checks
    idx, hd = matcher.match_nn(jnp.asarray(d1), jnp.ones(len(d1), bool),
                               jnp.asarray(d2), jnp.ones(len(d2), bool),
                               max_dist=80, ratio=0.9, mutual=True,
                               extra_mask=jnp.asarray(mask))
    idx, hd = np.asarray(idx), np.asarray(hd)
    ok = (rb <= 80) & (rb <= 0.9 * rs)
    dt = np.where(mask.T, np.minimum(rdist.T, 299), 300)
    back = dt.argmin(1)
    ok &= back[np.where(ok, rbi, 0)] == np.arange(len(d1))
    np.testing.assert_array_equal(idx, np.where(ok, rbi, -1))
    np.testing.assert_array_equal(hd[ok], rb[ok])
