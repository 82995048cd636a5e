"""Front-end tests: FAST on synthetic corners, descriptor invariance under
rotation, Hamming matcher vs numpy brute force, projection-window search."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.frontend import extractor, fast, matcher, orb, pyramid


def checkerboard(h=128, w=128, sq=16, lo=50.0, hi=200.0):
    y, x = np.mgrid[0:h, 0:w]
    board = (((y // sq) + (x // sq)) % 2).astype(np.float32)
    return lo + (hi - lo) * board


def square_grid(h=128, w=128, pitch=16, size=6, lo=50.0, hi=200.0):
    """Isolated bright squares — their corners are true FAST-9 corners
    (perfect checkerboard saddles split the ring 8/8 and must NOT fire)."""
    img = np.full((h, w), lo, np.float32)
    for cy in range(pitch // 2, h, pitch):
        for cx in range(pitch // 2, w, pitch):
            img[cy:cy + size, cx:cx + size] = hi
    return img


def random_texture(key, h=192, w=192):
    """Smooth random texture with strong blobs -> stable corners."""
    base = jax.random.uniform(key, (h // 8, w // 8)) * 255.0
    img = jax.image.resize(base, (h, w), "bilinear")
    return img


class TestFast:
    def test_square_corners(self):
        img = jnp.asarray(square_grid())
        score = fast.fast_score_map(img, 20.0)
        ys, xs = np.nonzero(np.asarray(score) > 0)
        assert len(ys) > 10
        # all detections within 3 px of a square corner (corners at
        # pitch/2 + {0, size-1} on each axis, pitch 16, size 6)
        def corner_dist(v):
            m = (v - 8) % 16
            d1 = np.minimum(m, 16 - m)            # near offset 8
            m2 = (v - 13) % 16
            d2 = np.minimum(m2, 16 - m2)          # near offset 13 (8+5)
            return np.minimum(d1, d2)
        assert np.max(np.maximum(corner_dist(ys), corner_dist(xs))) <= 3

    def test_checkerboard_saddles_do_not_fire(self):
        """Ideal saddle points split the ring 8/8 — FAST-9 must reject."""
        img = jnp.asarray(checkerboard())
        score = fast.fast_score_map(img, 20.0)
        assert float(jnp.max(score)) == 0.0

    def test_flat_image_no_corners(self):
        img = jnp.full((64, 64), 128.0)
        score = fast.fast_score_map(img, 10.0)
        assert float(jnp.max(score)) == 0.0

    def test_arc_detector(self):
        m = np.zeros((3, 16), dtype=bool)
        m[0, 0:9] = True          # run of 9 -> corner
        m[1, 0:8] = True          # run of 8 -> not
        m[2, 10:16] = True        # wrapped run 10..15 + 0..2 = 9 -> corner
        m[2, 0:3] = True
        out = np.asarray(fast._has_arc(jnp.asarray(m)))
        assert out.tolist() == [True, False, True]

    def test_detect_budget_and_coords(self):
        img = jnp.asarray(square_grid(192, 192, pitch=12, size=5))
        xy, score, valid = fast.detect(img, 20.0, 7.0)
        n = int(valid.sum())
        assert n > 20
        # valid keypoints must actually be corners (score > 0 at location)
        s = fast.nms3x3(fast.fast_score_map(img, 7.0))
        xs = np.asarray(xy[:, 0], np.int32)
        ys = np.asarray(xy[:, 1], np.int32)
        v = np.asarray(valid)
        assert np.all(np.asarray(s)[ys[v], xs[v]] > 0)


class TestOrb:
    def test_angle_gradient_direction(self):
        """A half-bright patch must orient toward the bright side."""
        img = np.full((64, 64), 50.0, np.float32)
        img[:, 40:] = 200.0  # bright on +x side
        ang = orb.keypoint_angles(jnp.asarray(img),
                                  jnp.asarray([[38.0, 32.0]]))
        assert abs(float(ang[0])) < 0.2  # points along +x

    def test_descriptor_rotation_invariance(self):
        """Rotating the image (and angle) keeps most descriptor bits."""
        key = jax.random.PRNGKey(0)
        img = np.asarray(random_texture(key))
        h, w = img.shape
        kp = jnp.asarray([[96.0, 96.0]])
        ang0 = orb.keypoint_angles(jnp.asarray(img), kp)
        d0 = orb.describe(pyramid.blur(jnp.asarray(img)), kp, ang0)

        # rotate image by 30 deg about the keypoint (bilinear, numpy)
        theta = np.deg2rad(30.0)
        c, s = np.cos(theta), np.sin(theta)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        xs = c * (xx - 96) + s * (yy - 96) + 96
        ys = -s * (xx - 96) + c * (yy - 96) + 96
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 2)
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 2)
        fx = np.clip(xs - x0, 0, 1)
        fy = np.clip(ys - y0, 0, 1)
        rot = ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
               + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))
        rot = jnp.asarray(rot, dtype=jnp.float32)

        ang1 = orb.keypoint_angles(rot, kp)
        d1 = orb.describe(pyramid.blur(rot), kp, ang1)
        hamming = int(jnp.sum(jnp.abs(d0 - d1)))
        assert hamming < 60, hamming  # << 128 (random would be ~128)

    def test_pack_unpack(self):
        key = jax.random.PRNGKey(1)
        bits = jax.random.bernoulli(key, 0.5, (16, 256)).astype(jnp.int8)
        packed = orb.pack_bits(bits)
        assert packed.shape == (16, 8)
        np.testing.assert_array_equal(np.asarray(orb.unpack_bits(packed)),
                                      np.asarray(bits))


class TestMatcher:
    def test_hamming_matrix_vs_numpy(self):
        key = jax.random.PRNGKey(2)
        d1 = jax.random.bernoulli(key, 0.5, (64, 256)).astype(jnp.int8)
        d2 = jax.random.bernoulli(jax.random.PRNGKey(3), 0.5,
                                  (80, 256)).astype(jnp.int8)
        H = np.asarray(matcher.hamming_matrix(d1, d2))
        gt = (np.asarray(d1)[:, None, :] != np.asarray(d2)[None]).sum(-1)
        np.testing.assert_array_equal(H, gt)

    def test_match_nn_recovers_permutation(self):
        key = jax.random.PRNGKey(4)
        n = 128
        d2 = jax.random.bernoulli(key, 0.5, (n, 256)).astype(jnp.int8)
        perm = jax.random.permutation(jax.random.PRNGKey(5), n)
        # queries = permuted targets with 10 flipped bits of noise
        noise = jax.random.bernoulli(jax.random.PRNGKey(6), 10.0 / 256,
                                     (n, 256)).astype(jnp.int8)
        d1 = jnp.abs(d2[perm] - noise)
        valid = jnp.ones((n,), bool)
        idx, dist = matcher.match_nn(d1, valid, d2, valid, max_dist=50,
                                     ratio=0.9)
        recovered = np.asarray(idx)
        ok = recovered == np.asarray(perm)
        assert ok.mean() > 0.95, ok.mean()

    def test_window_mask_and_projection(self):
        n, m = 8, 16
        xy1 = jnp.asarray(np.random.default_rng(0).uniform(0, 100, (n, 2)),
                          dtype=jnp.float32)
        xy2 = jnp.asarray(np.random.default_rng(1).uniform(0, 100, (m, 2)),
                          dtype=jnp.float32)
        msk = np.asarray(matcher.window_mask(xy1, xy2, 10.0))
        gt = ((np.abs(np.asarray(xy1)[:, None, 0] - np.asarray(xy2)[None, :, 0]) < 10)
              & (np.abs(np.asarray(xy1)[:, None, 1] - np.asarray(xy2)[None, :, 1]) < 10))
        np.testing.assert_array_equal(msk, gt)

    def test_dedup_targets(self):
        idx = jnp.asarray([3, 3, 2, -1, 3], dtype=jnp.int32)
        dist = jnp.asarray([10, 5, 7, 1, 5], dtype=jnp.int32)
        out = np.asarray(matcher.dedup_targets(idx, dist, 8))
        # target 3 claimed by query 1 (dist 5, first among ties), target 2 by
        # query 2
        np.testing.assert_array_equal(out, [-1, 3, 2, -1, -1])

    def test_rotation_histogram(self):
        n = 100
        a1 = jnp.zeros((n,))
        # 80 matches rotated by ~0.5 rad, 20 outliers at random rotations
        a2 = jnp.concatenate([
            jnp.full((80,), 0.5),
            jnp.asarray(np.random.default_rng(2).uniform(-3, 3, 20),
                        dtype=jnp.float32)])
        valid = jnp.ones((n,), bool)
        keep = np.asarray(matcher.rotation_histogram_filter(a1, a2, valid))
        assert keep[:80].all()
        assert keep[80:].sum() < 10


class TestExtractor:
    def test_extract_end_to_end(self):
        img = random_texture(jax.random.PRNGKey(7), 256, 256)
        cfg = extractor.OrbConfig(n_features=256, n_levels=4)
        feats = jax.jit(lambda im: extractor.extract(im, cfg))(img)
        assert feats.xy.shape == (256, 2)
        n_valid = int(feats.valid.sum())
        assert n_valid > 50, n_valid
        v = np.asarray(feats.valid)
        xy = np.asarray(feats.xy)[v]
        assert xy.min() >= 0 and xy.max() < 256
        # descriptors of valid kps should not be all-zero
        dsum = np.asarray(feats.desc).sum(axis=1)[v]
        assert (dsum > 0).mean() > 0.9

    def test_multicam(self):
        imgs = jnp.stack([random_texture(jax.random.PRNGKey(8), 128, 128),
                          random_texture(jax.random.PRNGKey(9), 128, 128)])
        cfg = extractor.OrbConfig(n_features=128, n_levels=3)
        feats = extractor.extract_multicam(imgs, cfg)
        assert feats.xy.shape == (2, 128, 2)
        assert int(feats.valid[0].sum()) > 20


class TestPatchFormulation:
    """The round-4 patch-extraction ORB path must reproduce the stacked-
    gather reference implementation (same math, different data movement)."""

    def _fixture(self):
        import numpy as np
        rng = np.random.default_rng(7)
        L, h, w = 3, 120, 160
        stack = jnp.asarray(rng.uniform(0, 255, (L, h, w)).astype(
            np.float32))
        K = 64
        lv = jnp.asarray(rng.integers(0, L, K).astype(np.int32))
        # keypoints at least 16 px inside (the detector's border margin)
        xy = jnp.asarray(np.stack([
            rng.uniform(16, w - 17, K), rng.uniform(16, h - 17, K)],
            axis=-1).astype(np.float32))
        return stack, lv, jnp.floor(xy)

    def test_patch_angles_match_stacked(self):
        stack, lv, xy = self._fixture()
        a_old = orb.keypoint_angles_stacked(stack, lv, xy)
        patches, _, _ = orb.extract_patches(stack, lv, xy)
        a_new = orb.patch_angles(patches)
        import numpy as np
        d = np.abs(np.asarray(a_new) - np.asarray(a_old))
        d = np.minimum(d, 2 * np.pi - d)
        assert d.max() < 1e-3, d.max()

    def test_patch_describe_matches_stacked(self):
        import numpy as np
        stack, lv, xy = self._fixture()
        angles = orb.keypoint_angles_stacked(stack, lv, xy)
        bits_old = np.asarray(orb.describe_stacked(stack, lv, xy, angles))
        patches, ox, oy = orb.extract_patches(stack, lv, xy)
        bits_new = np.asarray(orb.patch_describe(patches, xy, ox, oy,
                                                 angles))
        mismatch = (bits_old != bits_new).mean()
        # identical bilinear math; only float-rounding ties may flip bits
        assert mismatch < 0.005, mismatch

    def test_extract_still_works_end_to_end(self):
        import numpy as np
        rng = np.random.default_rng(3)
        img = jnp.asarray(rng.uniform(0, 255, (120, 160)).astype(
            np.float32))
        cfg = extractor.OrbConfig(n_features=128, n_levels=3)
        feats = extractor.extract(img, cfg)
        assert int(feats.valid.sum()) > 20
        d = np.asarray(feats.desc[np.asarray(feats.valid)])
        assert set(np.unique(d)) <= {0, 1}
        # descriptors must be discriminative (not constant)
        assert d.std() > 0.3
