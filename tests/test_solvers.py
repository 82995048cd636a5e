"""RANSAC solver tests: two-view E, PnP resection, Horn Sim3."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.geometry import lie
from openmavis_jax.solvers import pnp, sim3, two_view

F = jnp.float32


def scene_points(key, n, depth=(4.0, 12.0)):
    ks = jax.random.split(key, 3)
    return jnp.stack([
        jax.random.uniform(ks[0], (n,), minval=-4, maxval=4),
        jax.random.uniform(ks[1], (n,), minval=-3, maxval=3),
        jax.random.uniform(ks[2], (n,), minval=depth[0], maxval=depth[1])],
        axis=-1)


class TestTwoView:
    def _make(self, key, n=300, outlier_frac=0.15, noise=0.3 / 400):
        p = scene_points(key, n)
        R = lie.so3_exp(jnp.array([0.02, -0.4, 0.03], dtype=F))
        t = jnp.array([0.8, 0.1, 0.05], dtype=F)
        # camera 2 pose: p_c2 = R p_c1 + t
        p2 = jnp.einsum("ij,nj->ni", R, p) + t
        x1 = p[:, :2] / p[:, 2:3]
        x2 = p2[:, :2] / p2[:, 2:3]
        k1, k2 = jax.random.split(jax.random.PRNGKey(7))
        x1 = x1 + noise * jax.random.normal(k1, x1.shape)
        x2 = x2 + noise * jax.random.normal(k2, x2.shape)
        n_out = int(n * outlier_frac)
        x2 = x2.at[:n_out].add(
            0.3 * jax.random.normal(jax.random.PRNGKey(8), (n_out, 2)))
        valid = p2[:, 2] > 0.5
        return x1, x2, valid, R, t, p, n_out

    def test_recovers_relative_pose(self):
        x1, x2, valid, R_gt, t_gt, p_gt, n_out = self._make(
            jax.random.PRNGKey(0))
        res = jax.jit(lambda k: two_view.reconstruct(
            k, x1, x2, valid, focal=400.0))(jax.random.PRNGKey(1))
        assert bool(res.success)
        rot_err = np.linalg.norm(np.asarray(lie.so3_log(res.R.T @ R_gt)))
        assert rot_err < 0.01, rot_err
        # translation up to scale
        t_dir = np.asarray(res.t) / np.linalg.norm(np.asarray(res.t))
        t_gt_dir = np.asarray(t_gt) / np.linalg.norm(np.asarray(t_gt))
        assert np.abs(t_dir @ t_gt_dir) > 0.999
        # triangulated points match GT up to the same scale
        good = np.asarray(res.is_good)
        assert good.sum() > 150
        scale = np.linalg.norm(np.asarray(t_gt))
        pts = np.asarray(res.points)[good] * scale
        err = np.linalg.norm(pts - np.asarray(p_gt)[good], axis=-1)
        assert np.median(err) < 0.1, np.median(err)

    def test_deterministic(self):
        x1, x2, valid, *_ = self._make(jax.random.PRNGKey(2))
        r1 = two_view.reconstruct(jax.random.PRNGKey(3), x1, x2, valid, 400.0)
        r2 = two_view.reconstruct(jax.random.PRNGKey(3), x1, x2, valid, 400.0)
        np.testing.assert_array_equal(np.asarray(r1.R), np.asarray(r2.R))

    def test_fails_gracefully_on_garbage(self):
        key = jax.random.PRNGKey(4)
        x1 = jax.random.normal(key, (100, 2))
        x2 = jax.random.normal(jax.random.PRNGKey(5), (100, 2))
        res = two_view.reconstruct(jax.random.PRNGKey(6), x1, x2,
                                   jnp.ones(100, bool), 400.0)
        assert not bool(res.success)


class TestPnP:
    def test_resection(self):
        key = jax.random.PRNGKey(10)
        p_w = scene_points(key, 200)
        R_gt = lie.so3_exp(jnp.array([0.2, -0.1, 0.3], dtype=F))
        t_gt = jnp.array([0.5, -0.3, 0.8], dtype=F)
        p_c = jnp.einsum("ij,nj->ni", R_gt, p_w) + t_gt
        bearing = p_c / jnp.linalg.norm(p_c, axis=-1, keepdims=True)
        # perturb 20% with garbage directions
        n_out = 40
        garbage = jax.random.normal(jax.random.PRNGKey(11), (n_out, 3))
        garbage = garbage / jnp.linalg.norm(garbage, axis=-1, keepdims=True)
        bearing = bearing.at[:n_out].set(garbage)
        res = jax.jit(lambda k: pnp.ransac_pnp(
            k, p_w, bearing, jnp.ones(200, bool)))(jax.random.PRNGKey(12))
        assert bool(res.success)
        rot_err = np.linalg.norm(np.asarray(lie.so3_log(res.R_cw.T @ R_gt)))
        assert rot_err < 5e-3, rot_err
        assert np.linalg.norm(np.asarray(res.t_cw - t_gt)) < 0.05
        inl = np.asarray(res.inlier)
        assert inl[:n_out].mean() < 0.1
        assert inl[n_out:].mean() > 0.9


class TestSim3:
    def test_horn_exact(self):
        key = jax.random.PRNGKey(13)
        p1 = scene_points(key, 50)
        s_gt, R_gt = 1.7, lie.so3_exp(jnp.array([0.3, 0.2, -0.4], dtype=F))
        t_gt = jnp.array([2.0, -1.0, 0.5], dtype=F)
        p2 = s_gt * jnp.einsum("ij,nj->ni", R_gt, p1) + t_gt
        s, R, t = sim3.horn_sim3(p1, p2)
        assert abs(float(s) - s_gt) < 1e-4
        assert np.linalg.norm(np.asarray(lie.so3_log(R.T @ R_gt))) < 1e-4
        np.testing.assert_allclose(np.asarray(t), np.asarray(t_gt), atol=1e-3)

    def test_ransac_with_outliers(self):
        key = jax.random.PRNGKey(14)
        p1 = scene_points(key, 150)
        s_gt, R_gt = 0.8, lie.so3_exp(jnp.array([-0.2, 0.5, 0.1], dtype=F))
        t_gt = jnp.array([1.0, 2.0, -0.5], dtype=F)
        p2 = s_gt * jnp.einsum("ij,nj->ni", R_gt, p1) + t_gt
        p2 = p2 + 0.01 * jax.random.normal(jax.random.PRNGKey(15), p2.shape)
        n_out = 40
        p2 = p2.at[:n_out].add(
            3.0 * jax.random.normal(jax.random.PRNGKey(16), (n_out, 3)))
        res = jax.jit(lambda k: sim3.ransac_sim3(
            k, p1, p2, jnp.ones(150, bool)))(jax.random.PRNGKey(17))
        assert bool(res.success)
        assert abs(float(res.s) - s_gt) < 0.02
        assert np.linalg.norm(
            np.asarray(lie.so3_log(res.R.T @ R_gt))) < 0.02
        inl = np.asarray(res.inlier)
        assert inl[:n_out].mean() < 0.2
        assert inl[n_out:].mean() > 0.8

    def test_fix_scale(self):
        key = jax.random.PRNGKey(18)
        p1 = scene_points(key, 100)
        R_gt = lie.so3_exp(jnp.array([0.1, -0.3, 0.2], dtype=F))
        t_gt = jnp.array([0.5, 0.1, -0.2], dtype=F)
        p2 = jnp.einsum("ij,nj->ni", R_gt, p1) + t_gt
        res = sim3.ransac_sim3(jax.random.PRNGKey(19), p1, p2,
                               jnp.ones(100, bool), fix_scale=True)
        assert float(res.s) == 1.0
        assert bool(res.success)


class TestHomographyBranch:
    """Homography model of two-view init (reference:
    TwoViewReconstruction::FindHomography/ReconstructH,
    src/TwoViewReconstruction.cc:48-120)."""

    def _motion(self):
        R = np.asarray(lie.so3_exp(jnp.asarray([0.02, 0.25, 0.01])))
        t = np.array([0.8, 0.05, 0.1])
        return R, t / np.linalg.norm(t)

    def test_decompose_h_contains_truth(self):
        R, t = self._motion()
        n, d = np.array([0.15, -0.1, 1.0]), 5.0
        n = n / np.linalg.norm(n)
        H = R + np.outer(t, n) / d
        Rs, ts = two_view.decompose_H(jnp.asarray(H, jnp.float32))
        r_err = np.linalg.norm(np.asarray(Rs) - R, axis=(1, 2))
        t_dot = np.abs(np.asarray(ts) @ t)
        hit = (r_err < 1e-3) & (t_dot > 0.999)
        assert hit.any(), (r_err, t_dot)

    def test_planar_scene_no_false_init(self):
        """Pure planar two-view geometry carries the twisted-pair
        ambiguity: the solver must refuse (like the reference's
        similar-candidate gate) or return the TRUE motion — never
        succeed with a wrong one."""
        rng = np.random.default_rng(7)
        R, t = self._motion()
        N = 200
        xy = rng.uniform(-2, 2, (N, 2))
        z = 5 + 0.6 * xy[:, 0] - 0.4 * xy[:, 1]
        pts = np.concatenate([xy, z[:, None]], axis=1)
        x1 = pts[:, :2] / pts[:, 2:]
        p2 = pts @ R.T + t
        x2 = p2[:, :2] / p2[:, 2:]
        noise = 0.5 / 380
        res = two_view.reconstruct(
            jax.random.PRNGKey(0),
            jnp.asarray(x1 + rng.normal(0, noise, x1.shape), jnp.float32),
            jnp.asarray(x2 + rng.normal(0, noise, x2.shape), jnp.float32),
            jnp.ones(N, bool), focal=380.0)
        if bool(res.success):
            assert abs(float(jnp.dot(res.t, jnp.asarray(t, jnp.float32)))) \
                > 0.95

    def test_general_scene_with_h_branch_enabled(self):
        rng = np.random.default_rng(3)
        R, t = self._motion()
        N = 200
        pts = rng.uniform([-2, -2, 3], [2, 2, 9], (N, 3))
        x1 = pts[:, :2] / pts[:, 2:]
        p2 = pts @ R.T + t
        x2 = p2[:, :2] / p2[:, 2:]
        noise = 0.5 / 380
        res = two_view.reconstruct(
            jax.random.PRNGKey(0),
            jnp.asarray(x1 + rng.normal(0, noise, x1.shape), jnp.float32),
            jnp.asarray(x2 + rng.normal(0, noise, x2.shape), jnp.float32),
            jnp.ones(N, bool), focal=380.0, use_homography=True)
        assert bool(res.success)
        assert np.linalg.norm(np.asarray(res.R) - R) < 0.05
        assert abs(float(jnp.dot(res.t, jnp.asarray(t, jnp.float32)))) \
            > 0.99


def test_pnp_ml_weighting_downweights_coarse_levels():
    """MLPnP semantics (reference: src/MLPnPsolver.cpp): per-point
    covariance whitening. Half the observations carry 8x the angular
    noise (coarse pyramid levels); the sigma2-weighted solve must beat
    the unweighted one on rotation error."""
    import numpy as np
    from openmavis_jax.solvers import pnp as pnp_mod
    from openmavis_jax.geometry import lie

    rng = np.random.RandomState(0)
    N = 96
    p_w = rng.uniform(-3, 3, (N, 3)) + np.array([0, 0, 8.0])
    R_true = np.asarray(lie.so3_exp(jnp.asarray([0.1, -0.2, 0.05])))
    t_true = np.array([0.3, -0.1, 0.2])
    b = (p_w @ R_true.T) + t_true
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    # noise: fine levels sigma=1, coarse levels sigma=8 (angular)
    sigma = np.where(np.arange(N) % 2 == 0, 1.0, 8.0)
    noise = rng.normal(0, 1, (N, 3)) * (0.002 * sigma)[:, None]
    b_noisy = b + noise
    b_noisy /= np.linalg.norm(b_noisy, axis=-1, keepdims=True)
    valid = jnp.ones((N,), bool)
    key = jax.random.PRNGKey(0)

    def rot_err(R_est):
        c = (np.trace(np.asarray(R_est) @ R_true.T) - 1) / 2
        return float(np.degrees(np.arccos(np.clip(c, -1, 1))))

    errs_u, errs_w = [], []
    for s in range(4):
        k = jax.random.PRNGKey(s)
        ru = pnp_mod.ransac_pnp(k, jnp.asarray(p_w, jnp.float32),
                                jnp.asarray(b_noisy, jnp.float32),
                                valid, cos_th=0.9995)
        rw = pnp_mod.ransac_pnp(k, jnp.asarray(p_w, jnp.float32),
                                jnp.asarray(b_noisy, jnp.float32),
                                valid, cos_th=0.9995,
                                sigma2=jnp.asarray(sigma ** 2,
                                                   jnp.float32))
        assert bool(ru.success) and bool(rw.success)
        errs_u.append(rot_err(ru.R_cw))
        errs_w.append(rot_err(rw.R_cw))
    assert np.mean(errs_w) <= np.mean(errs_u) + 1e-6, (errs_u, errs_w)


class TestMLPnPNullspace:
    """MLPnP tangent-basis rows vs classical cross-product DLT rows at
    strong off-axis bearings (reference: MLPnPsolver.cpp:15, Urban et
    al. — the formulation chosen exactly for fisheye-edge robustness)."""

    def _offaxis_scene(self, noise=0.002, seed=0):
        import numpy as np
        from openmavis_jax.geometry import lie as lie_mod
        rng = np.random.default_rng(seed)
        N = 60
        # bearings 75-88 deg off the optical axis (KB8 fisheye edge)
        theta = rng.uniform(np.deg2rad(75), np.deg2rad(88), N)
        phi = rng.uniform(0, 2 * np.pi, N)
        b = np.stack([np.sin(theta) * np.cos(phi),
                      np.sin(theta) * np.sin(phi),
                      np.cos(theta)], axis=-1)
        depth = rng.uniform(2.0, 12.0, N)
        p_c = b * depth[:, None]
        R_gt = np.asarray(lie_mod.so3_exp(jnp.asarray([0.3, -0.2, 0.5])))
        t_gt = np.array([0.4, -0.3, 1.2])
        # world points: p_c = R_gt p_w + t_gt
        p_w = (R_gt.T @ (p_c - t_gt).T).T
        b_noisy = b + rng.normal(0, noise, b.shape)
        b_noisy /= np.linalg.norm(b_noisy, axis=-1, keepdims=True)
        return (jnp.asarray(p_w, jnp.float32),
                jnp.asarray(b_noisy, jnp.float32), R_gt, t_gt)

    def _err(self, res, R_gt, t_gt):
        import numpy as np
        dR = np.asarray(res.R_cw) @ R_gt.T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        return ang, np.linalg.norm(np.asarray(res.t_cw) - t_gt)

    def test_offaxis_accuracy(self):
        from openmavis_jax.solvers import pnp
        p_w, b, R_gt, t_gt = self._offaxis_scene()
        key = jax.random.PRNGKey(0)
        valid = jnp.ones(p_w.shape[0], bool)
        res = pnp.ransac_pnp(key, p_w, b, valid, cos_th=0.99985)
        assert bool(res.success)
        ang, dt = self._err(res, R_gt, t_gt)
        assert ang < 0.01, ang          # < 0.6 deg
        assert dt < 0.05, dt

    def test_nullspace_beats_cross_formulation(self):
        """Across seeds, the nullspace rows must dominate the classical
        cross-product rows at fisheye-edge bearings."""
        import numpy as np
        from openmavis_jax.solvers import pnp
        wins, total = 0, 0
        for seed in range(6):
            p_w, b, R_gt, t_gt = self._offaxis_scene(noise=0.004,
                                                     seed=seed)
            valid = jnp.ones(p_w.shape[0], bool)
            key = jax.random.PRNGKey(seed)
            e_ns = self._err(pnp.ransac_pnp(
                key, p_w, b, valid, cos_th=0.9997,
                formulation="nullspace"), R_gt, t_gt)
            e_cx = self._err(pnp.ransac_pnp(
                key, p_w, b, valid, cos_th=0.9997,
                formulation="cross"), R_gt, t_gt)
            total += 1
            wins += (e_ns[0] + e_ns[1]) <= (e_cx[0] + e_cx[1]) + 1e-6
        assert wins >= total - 1, (wins, total)

    def test_nullspace_basis_orthonormal(self):
        import numpy as np
        from openmavis_jax.solvers import pnp
        rng = np.random.default_rng(1)
        v = rng.normal(size=(500, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        r, s = pnp.bearing_nullspace(jnp.asarray(v, jnp.float32))
        r, s = np.asarray(r), np.asarray(s)
        np.testing.assert_allclose(np.sum(r * v, -1), 0, atol=1e-5)
        np.testing.assert_allclose(np.sum(s * v, -1), 0, atol=1e-5)
        np.testing.assert_allclose(np.sum(r * s, -1), 0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(r, axis=-1), 1,
                                   atol=1e-5)
