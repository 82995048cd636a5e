"""Schur-complement bundle adjustment tests on synthetic windows."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.geometry import cameras, lie
from openmavis_jax.imu import preintegration as pre_mod
from openmavis_jax.optim import ba, pose_opt
from openmavis_jax.optim.reprojection import RigParams

F = jnp.float32
PIN = jnp.array([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0], dtype=F)


def mono_rig():
    return RigParams(kind=cameras.PINHOLE, params=PIN[None],
                     R_cb=jnp.eye(3, dtype=F)[None],
                     t_cb=jnp.zeros((1, 3), dtype=F))


def make_window(key, K=6, M=300, noise_px=0.4):
    """K poses moving along x, M landmarks in front."""
    ks = jax.random.split(key, 6)
    points = jnp.stack([
        jax.random.uniform(ks[0], (M,), minval=-6, maxval=8),
        jax.random.uniform(ks[1], (M,), minval=-4, maxval=4),
        jax.random.uniform(ks[2], (M,), minval=6, maxval=14)], axis=-1)
    R_gt = jnp.stack([lie.so3_exp(jnp.array([0.0, 0.05 * k, 0.0], dtype=F))
                      for k in range(K)])
    t_gt = jnp.stack([jnp.array([0.4 * k, 0.02 * k, 0.0], dtype=F)
                      for k in range(K)])

    # observations: each point seen by every KF (dense), validity by frustum
    kf_idx = jnp.repeat(jnp.arange(K), M)
    mp_idx = jnp.tile(jnp.arange(M), K)
    cam_idx = jnp.zeros_like(kf_idx)
    p_b = jnp.einsum("oji,oj->oi", R_gt[kf_idx], points[mp_idx] - t_gt[kf_idx])
    uv = cameras.pinhole_project(PIN, p_b)
    uv = uv + noise_px * jax.random.normal(ks[3], uv.shape)
    valid = ((p_b[:, 2] > 1.0) & (uv[:, 0] > 0) & (uv[:, 0] < 640)
             & (uv[:, 1] > 0) & (uv[:, 1] < 480))
    sigma2 = jnp.ones_like(uv[:, 0])
    obs = ba.BAObservations(kf=kf_idx, mp=mp_idx, cam=cam_idx, uv=uv,
                            sigma2=sigma2, valid=valid)
    return points, R_gt, t_gt, obs


class TestVisualBA:
    def test_recovers_window(self):
        K, M = 6, 300
        points, R_gt, t_gt, obs = make_window(jax.random.PRNGKey(0), K, M)
        key = jax.random.PRNGKey(1)
        # perturb all but the first two (gauge-fixing) poses and all points
        dR = jax.vmap(lie.so3_exp)(
            0.02 * jax.random.normal(key, (K, 3)))
        R0 = R_gt @ dR
        t0 = t_gt + 0.05 * jax.random.normal(jax.random.PRNGKey(2), (K, 3))
        R0 = R0.at[:2].set(R_gt[:2])
        t0 = t0.at[:2].set(t_gt[:2])
        pts0 = points + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                                 points.shape)
        z3 = jnp.zeros((K, 3), dtype=F)
        state0 = ba.BAState(R=R0, t=t0, v=z3, bg=z3, ba=z3, points=pts0)
        fixed = jnp.asarray([True, True] + [False] * (K - 2))

        state, inlier, chi = jax.jit(
            lambda s: ba.bundle_adjust(s, obs, mono_rig(), fixed))(state0)

        t_err = np.abs(np.asarray(state.t - t_gt)).max()
        t_err0 = np.abs(np.asarray(t0 - t_gt)).max()
        assert t_err < 0.02, (t_err, t_err0)
        # judge only well-constrained points (seen by >= 3 KFs): poorly
        # observed ones are legitimately weakly determined along their ray
        n_obs = np.zeros(M)
        np.add.at(n_obs, np.asarray(obs.mp), np.asarray(obs.valid))
        well = n_obs >= 3
        p_err = np.abs(np.asarray(state.points - points))[well]
        # depth sigma at z=13m, f=400, 2.4m baseline, 0.4px noise is ~0.09m;
        # allow 4 sigma at the far end, check the bulk via the median
        assert p_err.max() < 0.35, p_err.max()
        assert np.median(p_err.max(axis=1)) < 0.08
        # chi2 should be near the noise floor: dof ~ 2*O, sigma=0.4px
        n_act = int(inlier.sum())
        assert float(chi) / max(n_act, 1) < 2.0

    def test_outlier_rejection(self):
        K, M = 5, 200
        points, R_gt, t_gt, obs = make_window(jax.random.PRNGKey(4), K, M)
        # corrupt 5% of observations
        n_bad = obs.uv.shape[0] // 20
        uv_bad = obs.uv.at[:n_bad].add(
            60.0 * jax.random.normal(jax.random.PRNGKey(5), (n_bad, 2)))
        obs = obs._replace(uv=uv_bad)
        z3 = jnp.zeros((K, 3), dtype=F)
        state0 = ba.BAState(R=R_gt, t=t_gt, v=z3, bg=z3, ba=z3,
                            points=points)
        fixed = jnp.asarray([True, True] + [False] * (K - 2))
        state, inlier, chi = ba.bundle_adjust(state0, obs, mono_rig(), fixed)
        inl = np.asarray(inlier)
        was_valid = np.asarray(obs.valid)
        # corrupted + valid observations should be gated out
        bad_and_valid = was_valid[:n_bad]
        assert inl[:n_bad][bad_and_valid].mean() < 0.2
        t_err = np.abs(np.asarray(state.t - t_gt)).max()
        assert t_err < 0.02, t_err


class TestInertialBA:
    def test_vi_window(self):
        """VI window: visual obs + exact preintegration chain."""
        K, M = 4, 200
        dt_kf = 0.25
        g_np = np.array([0, 0, -9.81], np.float32)
        # trajectory: constant world acceleration + yaw rate
        w_body = np.array([0.0, 0.0, 0.2], np.float32)
        a_w = np.array([0.4, 0.0, 0.0], np.float32)
        n_s = 25  # imu samples per KF interval (100 Hz)
        dt = dt_kf / n_s

        Rk = np.eye(3, dtype=np.float32)
        p = np.zeros(3, np.float32)
        v = np.array([1.0, 0.0, 0.0], np.float32)
        R_list, p_list, v_list = [Rk.copy()], [p.copy()], [v.copy()]
        pres = []
        noise = pre_mod.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3,
                                             1.0 / dt)
        for kf in range(K - 1):
            ws, accs = [], []
            for i in range(n_s):
                ws.append(w_body)
                accs.append(Rk.T @ (a_w - g_np))
                sub = 20
                h = dt / sub
                for k in range(sub):
                    Rf = Rk @ np.asarray(
                        lie.so3_exp(jnp.asarray(w_body * k * h)))
                    aw = Rf @ accs[-1] + g_np
                    p = p + v * h + 0.5 * aw * h * h
                    v = v + aw * h
                Rk = Rk @ np.asarray(lie.so3_exp(jnp.asarray(w_body * dt)))
            pres.append(pre_mod.integrate(
                jnp.asarray(np.stack(ws)), jnp.asarray(np.stack(accs)),
                jnp.full((n_s,), dt, np.float32), jnp.zeros(6), noise))
            R_list.append(Rk.copy())
            p_list.append(p.copy())
            v_list.append(v.copy())

        R_gt = jnp.asarray(np.stack(R_list))
        t_gt = jnp.asarray(np.stack(p_list))
        v_gt = jnp.asarray(np.stack(v_list))
        pre_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *pres)
        edges = ba.InertialEdges(pre=pre_batch,
                                 valid=jnp.ones((K - 1,), bool))

        # landmarks + observations
        key = jax.random.PRNGKey(6)
        points = jnp.stack([
            jax.random.uniform(key, (M,), minval=-5, maxval=6),
            jax.random.uniform(jax.random.PRNGKey(7), (M,), minval=-4,
                               maxval=4),
            jax.random.uniform(jax.random.PRNGKey(8), (M,), minval=5,
                               maxval=12)], axis=-1)
        kf_idx = jnp.repeat(jnp.arange(K), M)
        mp_idx = jnp.tile(jnp.arange(M), K)
        p_b = jnp.einsum("oji,oj->oi", R_gt[kf_idx],
                         points[mp_idx] - t_gt[kf_idx])
        uv = cameras.pinhole_project(PIN, p_b)
        uv = uv + 0.4 * jax.random.normal(jax.random.PRNGKey(9), uv.shape)
        valid = ((p_b[:, 2] > 1.0) & (uv[:, 0] > 0) & (uv[:, 0] < 640)
                 & (uv[:, 1] > 0) & (uv[:, 1] < 480))
        obs = ba.BAObservations(
            kf=kf_idx, mp=mp_idx, cam=jnp.zeros_like(kf_idx), uv=uv,
            sigma2=jnp.ones_like(uv[:, 0]), valid=valid)

        # perturb
        dR = jax.vmap(lie.so3_exp)(
            0.01 * jax.random.normal(jax.random.PRNGKey(10), (K, 3)))
        state0 = ba.BAState(
            R=(R_gt @ dR).at[0].set(R_gt[0]),
            t=(t_gt + 0.03 * jax.random.normal(
                jax.random.PRNGKey(11), (K, 3))).at[0].set(t_gt[0]),
            v=v_gt + 0.05 * jax.random.normal(
                jax.random.PRNGKey(12), (K, 3)),
            bg=jnp.zeros((K, 3), dtype=F), ba=jnp.zeros((K, 3), dtype=F),
            points=points + 0.03 * jax.random.normal(
                jax.random.PRNGKey(13), points.shape))
        fixed = jnp.asarray([True] + [False] * (K - 1))

        state, inlier, chi = jax.jit(
            lambda s: ba.bundle_adjust(s, obs, mono_rig(), fixed,
                                       edges=edges))(state0)
        t_err = np.abs(np.asarray(state.t - t_gt)).max()
        v_err = np.abs(np.asarray(state.v - v_gt)).max()
        t_err0 = 0.03 * 3
        assert t_err < 0.02, (t_err, t_err0)
        assert v_err < 0.08, v_err
        assert np.all(np.isfinite(np.asarray(state.points)))
