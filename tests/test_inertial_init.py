"""IMU initialization: recover scale, gravity direction and biases from an
up-to-scale visual trajectory + preintegration chain."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.geometry import lie
from openmavis_jax.imu import preintegration as pre_mod
from openmavis_jax.optim import inertial_init

# heavyweight (compile-dominated) — excluded from the fast tier
pytestmark = __import__('pytest').mark.slow

F = jnp.float32


def simulate_chain(K=10, n_s=25, dt=0.01, seed=0,
                   bg=np.zeros(3, np.float32),
                   ba=np.zeros(3, np.float32)):
    """Excited trajectory (varying accel + rotation) with GT states."""
    rng = np.random.default_rng(seed)
    g = np.array([0, 0, -9.81], np.float32)
    Rk = np.eye(3, dtype=np.float32)
    p = np.zeros(3, np.float32)
    v = np.array([0.5, 0.0, 0.0], np.float32)
    R_list, p_list, v_list, pres = [Rk.copy()], [p.copy()], [v.copy()], []
    noise = pre_mod.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3,
                                         1.0 / dt)
    for kf in range(K - 1):
        ws, accs = [], []
        w_body = np.array([0.3 * np.sin(kf), 0.2, 0.4 * np.cos(kf)],
                          np.float32)
        a_w = np.array([np.sin(kf * 0.7), np.cos(kf * 0.9), 0.3],
                       np.float32)
        for i in range(n_s):
            ws.append(w_body + bg)           # measured = true + bias
            accs.append(Rk.T @ (a_w - g) + ba)
            sub = 20
            h = dt / sub
            a_body_true = Rk.T @ (a_w - g)
            for k in range(sub):
                Rf = Rk @ np.asarray(lie.so3_exp(
                    jnp.asarray(w_body * k * h)))
                aw = Rf @ a_body_true + g
                p = p + v * h + 0.5 * aw * h * h
                v = v + aw * h
            Rk = Rk @ np.asarray(lie.so3_exp(jnp.asarray(w_body * dt)))
        pres.append(pre_mod.integrate(
            jnp.asarray(np.stack(ws)), jnp.asarray(np.stack(accs)),
            jnp.full((n_s,), dt, np.float32), jnp.zeros(6), noise))
        R_list.append(Rk.copy())
        p_list.append(p.copy())
        v_list.append(v.copy())
    pre = jax.tree.map(lambda *xs: jnp.stack(xs), *pres)
    return (jnp.asarray(np.stack(R_list)), jnp.asarray(np.stack(p_list)),
            jnp.asarray(np.stack(v_list)), pre)


class TestInertialInit:
    def test_recovers_scale_and_gravity(self):
        K = 10
        R, p, v, pre = simulate_chain(K)
        # visual map is up-to-scale and gravity-misaligned:
        s_gt = 0.4                      # visual scale = s_gt * metric...
        R_tilt = lie.so3_exp(jnp.asarray([0.15, -0.1, 0.0], dtype=F))
        # observed (visual-frame) poses: p_vis = (1/s) * R_tilt^T p
        p_vis = (1.0 / s_gt) * jnp.einsum("ji,kj->ki", R_tilt, p)
        R_vis = jnp.einsum("ji,kjl->kil", R_tilt, R)

        res = jax.jit(inertial_init.inertial_optimization)(
            R_vis, p_vis, jnp.zeros((K, 3)), pre,
            jnp.ones((K - 1,), bool))
        assert abs(float(res.scale) - s_gt) / s_gt < 0.02, float(res.scale)
        # gravity in the visual frame should be R_tilt^T g0 = R_wg g0
        g_est = np.asarray(res.R_wg @ jnp.asarray(pre_mod.GRAVITY))
        g_true = np.asarray(jnp.einsum("ji,j->i", R_tilt,
                                       jnp.asarray(pre_mod.GRAVITY)))
        cos = g_est @ g_true / (np.linalg.norm(g_est)
                                * np.linalg.norm(g_true))
        assert cos > 0.9995, cos
        assert np.abs(np.asarray(res.bg)).max() < 5e-3
        # velocities are METRIC, expressed in the visual frame (they pair
        # with metric gravity and preintegration deltas): v' = R_tilt^T v
        v_vis = jnp.einsum("ji,kj->ki", R_tilt, v)
        err = np.abs(np.asarray(res.v - v_vis)).max()
        assert err < 0.1 * float(jnp.abs(v_vis).max()), err

    def test_recovers_gyro_bias(self):
        K = 10
        bg = np.array([0.02, -0.01, 0.015], np.float32)
        R, p, v, pre = simulate_chain(K, bg=bg)
        res = inertial_init.inertial_optimization(
            R, p, jnp.zeros((K, 3)), pre, jnp.ones((K - 1,), bool),
            fix_scale=True)
        np.testing.assert_allclose(np.asarray(res.bg), bg, atol=2e-3)

    def test_apply_scaled_rotation(self):
        K = 5
        R, p, v, pre = simulate_chain(K)
        pts = jnp.asarray(np.random.default_rng(1).normal(
            size=(20, 3)).astype(np.float32))
        R_gw = lie.so3_exp(jnp.asarray([0.1, 0.2, -0.1], dtype=F))
        s = jnp.asarray(2.0)
        Rn, pn, vn, ptn = inertial_init.apply_scaled_rotation(
            R, p, v, pts, R_gw, s)
        # relative geometry preserved up to scale
        d_before = jnp.linalg.norm(p[1] - p[0])
        d_after = jnp.linalg.norm(pn[1] - pn[0])
        assert abs(float(d_after) - 2.0 * float(d_before)) < 1e-5
        # rotations stay orthonormal
        assert float(jnp.abs(Rn[0] @ Rn[0].T - jnp.eye(3)).max()) < 1e-5
