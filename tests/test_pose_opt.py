"""Motion-only pose optimization tests on synthetic multi-camera scenes."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.geometry import cameras, lie
from openmavis_jax.imu import preintegration as pre_mod
from openmavis_jax.optim import inertial as inertial_mod
from openmavis_jax.optim import pose_opt
from openmavis_jax.optim.reprojection import RigParams

F = jnp.float32
PIN = jnp.array([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0], dtype=F)


def two_cam_rig():
    """Body with two pinhole cameras: identity and 0.5 rad yawed."""
    R1 = jnp.eye(3, dtype=F)
    R2 = lie.so3_exp(jnp.array([0.0, 0.5, 0.0], dtype=F))
    return RigParams(
        kind=cameras.PINHOLE,
        params=jnp.stack([PIN, PIN]),
        R_cb=jnp.stack([R1, R2.T]),
        t_cb=jnp.stack([jnp.zeros(3, dtype=F),
                        jnp.array([-0.1, 0.0, 0.0], dtype=F)]))


def make_scene(key, n=256, outlier_frac=0.1, noise_px=0.5):
    rig = two_cam_rig()
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    p_w = jnp.stack([
        jax.random.uniform(k1, (n,), minval=-4, maxval=4),
        jax.random.uniform(k2, (n,), minval=-3, maxval=3),
        jax.random.uniform(k3, (n,), minval=4, maxval=12)], axis=-1)
    # true body pose
    R_gt = lie.so3_exp(jnp.array([0.03, -0.05, 0.02], dtype=F))
    t_gt = jnp.array([0.3, -0.2, 0.1], dtype=F)
    cam_idx = (jax.random.uniform(k4, (n,)) > 0.5).astype(jnp.int32)

    # project through the true pose
    p_b = jnp.einsum("ji,nj->ni", R_gt, p_w - t_gt)
    p_c = jnp.einsum("nij,nj->ni", rig.R_cb[cam_idx], p_b) + rig.t_cb[cam_idx]
    uv = cameras.pinhole_project(rig.params[cam_idx], p_c)
    uv = uv + noise_px * jax.random.normal(k5, uv.shape)
    n_out = int(n * outlier_frac)
    out_noise = 80.0 * jax.random.normal(jax.random.PRNGKey(99), (n_out, 2))
    uv = uv.at[:n_out].add(out_noise)
    valid = p_c[:, 2] > 0.2
    sigma2 = jnp.ones((n,), dtype=F)
    return rig, p_w, cam_idx, uv, sigma2, valid, (R_gt, t_gt), n_out


class TestPoseOptimization:
    def test_recovers_pose_with_outliers(self):
        rig, p_w, cam_idx, uv, sigma2, valid, (R_gt, t_gt), n_out = \
            make_scene(jax.random.PRNGKey(0))
        # start from a perturbed pose
        R0 = R_gt @ lie.so3_exp(jnp.array([0.05, -0.03, 0.04], dtype=F))
        t0 = t_gt + jnp.array([0.2, 0.15, -0.1], dtype=F)
        R, t, inlier, n_in = jax.jit(
            lambda R0, t0: pose_opt.pose_optimization(
                R0, t0, p_w, cam_idx, uv, sigma2, valid, rig))(R0, t0)
        rot_err = np.linalg.norm(np.asarray(lie.so3_log(R.T @ R_gt)))
        t_err = np.linalg.norm(np.asarray(t - t_gt))
        assert rot_err < 2e-3, rot_err
        assert t_err < 2e-2, t_err
        # most outliers rejected, most inliers kept
        inl = np.asarray(inlier)
        assert inl[:n_out].mean() < 0.3
        assert inl[n_out:].mean() > 0.9

    def test_fixed_point_at_truth(self):
        rig, p_w, cam_idx, uv, sigma2, valid, (R_gt, t_gt), _ = \
            make_scene(jax.random.PRNGKey(1), outlier_frac=0.0, noise_px=0.0)
        R, t, inlier, n_in = pose_opt.pose_optimization(
            R_gt, t_gt, p_w, cam_idx, uv, sigma2, valid, rig)
        assert np.linalg.norm(np.asarray(t - t_gt)) < 1e-4
        assert int(n_in) == int(valid.sum())

    def test_all_invalid_is_safe(self):
        rig, p_w, cam_idx, uv, sigma2, valid, (R_gt, t_gt), _ = \
            make_scene(jax.random.PRNGKey(2))
        R, t, inlier, n_in = pose_opt.pose_optimization(
            R_gt, t_gt, p_w, cam_idx, uv, sigma2,
            jnp.zeros_like(valid), rig)
        assert np.all(np.isfinite(np.asarray(R)))
        assert int(n_in) == 0


class TestPoseInertial:
    def test_vi_motion_only(self):
        """Anchor + preintegration + visual obs: recover current state."""
        rig, p_w, cam_idx, _, sigma2, _, _, _ = make_scene(
            jax.random.PRNGKey(3), outlier_frac=0.0)
        # anchor at identity, moving with constant velocity + slight yaw
        anchor = pose_opt.InertialState(
            R=jnp.eye(3, dtype=F), p=jnp.zeros(3, dtype=F),
            v=jnp.array([1.0, 0.0, 0.0], dtype=F),
            bg=jnp.zeros(3, dtype=F), ba=jnp.zeros(3, dtype=F))
        # simulate 0.1s of IMU at 100Hz: w = (0,0,0.3), a_world = (0.5,0,0)
        n_s, dt = 10, 0.01
        w_body = np.array([0.0, 0.0, 0.3], np.float32)
        g = np.array([0, 0, -9.81], np.float32)
        Rk = np.eye(3, dtype=np.float32)
        ws, accs = [], []
        p, v = np.zeros(3, np.float32), np.array([1.0, 0, 0], np.float32)
        a_w = np.array([0.5, 0.0, 0.0], np.float32)
        for i in range(n_s):
            ws.append(w_body)
            accs.append(Rk.T @ (a_w - g))
            # fine integration of ground truth
            sub = 50
            h = dt / sub
            for k in range(sub):
                Rf = Rk @ np.asarray(lie.so3_exp(jnp.asarray(w_body * k * h)))
                aw = Rf @ accs[-1] + g
                p = p + v * h + 0.5 * aw * h * h
                v = v + aw * h
            Rk = Rk @ np.asarray(lie.so3_exp(jnp.asarray(w_body * dt)))
        noise = pre_mod.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3, 100.)
        pre = pre_mod.integrate(jnp.asarray(np.stack(ws)),
                                jnp.asarray(np.stack(accs)),
                                jnp.full((n_s,), dt), jnp.zeros(6), noise)
        R_gt = jnp.asarray(Rk)
        p_gt = jnp.asarray(p)
        v_gt = jnp.asarray(v)

        # visual observations from the true current pose
        p_b = jnp.einsum("ji,nj->ni", R_gt, p_w - p_gt)
        p_c = jnp.einsum("nij,nj->ni", rig.R_cb[cam_idx], p_b) \
            + rig.t_cb[cam_idx]
        uv = cameras.pinhole_project(rig.params[cam_idx], p_c)
        uv = uv + 0.5 * jax.random.normal(jax.random.PRNGKey(5), uv.shape)
        valid = p_c[:, 2] > 0.2

        # start from IMU prediction (should be close) with perturbation
        state0 = pose_opt.InertialState(
            R=R_gt @ lie.so3_exp(jnp.array([0.02, 0.01, -0.02], dtype=F)),
            p=p_gt + jnp.array([0.05, -0.04, 0.03], dtype=F),
            v=v_gt + jnp.array([0.1, 0.1, -0.1], dtype=F),
            bg=jnp.zeros(3, dtype=F), ba=jnp.zeros(3, dtype=F))
        x, inlier, n_in = jax.jit(
            lambda s: pose_opt.pose_inertial_optimization(
                s, anchor, pre, p_w, cam_idx, uv, sigma2, valid, rig))(state0)
        rot_err = np.linalg.norm(np.asarray(lie.so3_log(x.R.T @ R_gt)))
        assert rot_err < 5e-3, rot_err
        assert np.linalg.norm(np.asarray(x.p - p_gt)) < 2e-2
        assert np.linalg.norm(np.asarray(x.v - v_gt)) < 0.1
        assert int(n_in) > 0.8 * int(valid.sum())


class TestInertialJacobians:
    def test_jacobians_vs_finite_difference(self):
        """Analytic inertial-edge Jacobians vs central differences."""
        rng = np.random.default_rng(0)
        noise = pre_mod.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3, 100.)
        ws = jnp.asarray(0.4 * rng.normal(size=(20, 3)), dtype=F)
        accs = jnp.asarray(rng.normal(size=(20, 3))
                           + np.array([0, 0, 9.81]), dtype=F)
        pre = pre_mod.integrate(ws, accs, jnp.full((20,), 0.01),
                                jnp.zeros(6), noise)
        R1 = lie.so3_exp(jnp.asarray(0.3 * rng.normal(size=3), dtype=F))
        p1 = jnp.asarray(rng.normal(size=3), dtype=F)
        v1 = jnp.asarray(rng.normal(size=3), dtype=F)
        bg1 = jnp.asarray(0.01 * rng.normal(size=3), dtype=F)
        ba1 = jnp.asarray(0.05 * rng.normal(size=3), dtype=F)
        R2 = lie.so3_exp(jnp.asarray(0.3 * rng.normal(size=3), dtype=F))
        p2 = jnp.asarray(rng.normal(size=3), dtype=F)
        v2 = jnp.asarray(rng.normal(size=3), dtype=F)

        r0, J1, J2 = inertial_mod.inertial_residual_jac(
            R1, p1, v1, bg1, ba1, R2, p2, v2, pre)

        def res(d1, d2):
            R1p = R1 @ lie.so3_exp(d1[0:3])
            p1p = p1 + R1 @ d1[3:6]
            v1p = v1 + d1[6:9]
            bg1p = bg1 + d1[9:12]
            ba1p = ba1 + d1[12:15]
            R2p = R2 @ lie.so3_exp(d2[0:3])
            p2p = p2 + R2 @ d2[3:6]
            v2p = v2 + d2[6:9]
            return inertial_mod.inertial_residual(
                R1p, p1p, v1p, bg1p, ba1p, R2p, p2p, v2p, pre)

        J1_fd = jax.jacfwd(lambda d: res(d, jnp.zeros(9)))(jnp.zeros(15))
        J2_fd = jax.jacfwd(lambda d: res(jnp.zeros(15), d))(jnp.zeros(9))
        np.testing.assert_allclose(np.asarray(J1), np.asarray(J1_fd),
                                   atol=2e-3)
        np.testing.assert_allclose(np.asarray(J2), np.asarray(J2_fd),
                                   atol=2e-3)
