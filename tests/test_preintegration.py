"""IMU preintegration tests vs closed-form / fine-step numerical ground truth.

Strategy (SURVEY.md §4 "do better"): simulate an exact body trajectory,
generate perfect IMU measurements, and check that the SE2(3) preintegration
reproduces the relative motion; verify the bias Jacobians against finite
differences; verify padding with dt=0 is a no-op.
"""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.imu import preintegration as pre
from openmavis_jax.geometry import lie

G = np.array([0.0, 0.0, -9.81])


def simulate_imu(n, dt, w_body, a_world_fn, R0=np.eye(3)):
    """Generate perfect gyro/accel samples for constant body rate w_body and a
    world-frame acceleration profile; returns samples + ground-truth states.

    The accelerometer measures f = R^T (a_world - g).
    """
    Rs = [R0]
    for _ in range(n):
        Rs.append(Rs[-1] @ np.asarray(lie.so3_exp(jnp.asarray(
            w_body * dt, dtype=jnp.float64).astype(jnp.float32))))
    Rs = np.stack(Rs)  # [n+1, 3, 3]

    ws = np.tile(w_body, (n, 1))
    accs = []
    v = np.zeros(3)
    p = np.zeros(3)
    vs, ps = [v], [p]
    for i in range(n):
        a_w = a_world_fn(i * dt)
        # measurement in body frame at start of interval (ZOH)
        accs.append(Rs[i].T @ (a_w - G))
        # integrate ground truth finely within the step
        sub = 100
        h = dt / sub
        for k in range(sub):
            t = i * dt + k * h
            Rk = Rs[i] @ np.asarray(lie.so3_exp(
                jnp.asarray(w_body * (k * h), dtype=jnp.float32)))
            # world acceleration implied by the ZOH body measurement
            aw = Rk @ accs[-1] + G
            p = p + v * h + 0.5 * aw * h * h
            v = v + aw * h
        vs.append(v.copy())
        ps.append(p.copy())
    return (np.asarray(ws, np.float32), np.asarray(accs, np.float32),
            np.full(n, dt, np.float32), Rs, np.stack(vs), np.stack(ps))


NOISE = pre.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)


class TestPreintegration:
    def test_constant_rotation_translation(self):
        """Rotating + accelerating body: deltas match fine-step integration."""
        w_body = np.array([0.4, -0.2, 0.8])
        a_fn = lambda t: np.array([0.5, -0.3, 0.2])
        n, dt = 100, 0.005
        ws, accs, dts, Rs, vs, ps = simulate_imu(n, dt, w_body, a_fn)

        out = pre.integrate(jnp.asarray(ws), jnp.asarray(accs),
                            jnp.asarray(dts), jnp.zeros(6), NOISE)
        T = n * dt
        # ground-truth deltas in the preintegration convention:
        # dR = R0^T Rn ; dV = R0^T (vn - v0 - g T); dP = R0^T (pn - p0 - v0 T - 1/2 g T^2)
        dR_gt = Rs[0].T @ Rs[-1]
        dV_gt = Rs[0].T @ (vs[-1] - vs[0] - G * T)
        dP_gt = Rs[0].T @ (ps[-1] - ps[0] - vs[0] * T - 0.5 * G * T * T)
        np.testing.assert_allclose(np.asarray(out.dR), dR_gt, atol=2e-4)
        np.testing.assert_allclose(np.asarray(out.dV), dV_gt, atol=2e-3)
        np.testing.assert_allclose(np.asarray(out.dP), dP_gt, atol=2e-3)
        assert abs(float(out.dT) - T) < 1e-5

    def test_se23_beats_euler_on_fast_rotation(self):
        """The exact Gamma forms must beat Euler integration for fast spin.

        This is the MAVIS paper's claim; verify our implementation keeps it.
        """
        w_body = np.array([0.0, 0.0, 6.0])  # fast yaw, 6 rad/s
        a_fn = lambda t: np.array([1.0, 0.0, 0.0])
        n, dt = 40, 0.01
        ws, accs, dts, Rs, vs, ps = simulate_imu(n, dt, w_body, a_fn)
        out = pre.integrate(jnp.asarray(ws), jnp.asarray(accs),
                            jnp.asarray(dts), jnp.zeros(6), NOISE)
        T = n * dt
        dV_gt = Rs[0].T @ (vs[-1] - vs[0] - G * T)

        # Euler version (what ORB-SLAM3 did): dV += dR a dt with ZOH rotation
        dR_e = np.eye(3)
        dV_e = np.zeros(3)
        for i in range(n):
            dV_e = dV_e + dR_e @ accs[i] * dt
            dR_e = dR_e @ np.asarray(lie.so3_exp(jnp.asarray(ws[i] * dt)))
        err_se23 = np.linalg.norm(np.asarray(out.dV) - dV_gt)
        err_euler = np.linalg.norm(dV_e - dV_gt)
        assert err_se23 < 0.2 * err_euler, (err_se23, err_euler)

    def test_zero_dt_padding_is_noop(self):
        ws = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
        accs = np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32)
        dts = np.full(16, 0.005, np.float32)
        out1 = pre.integrate(jnp.asarray(ws), jnp.asarray(accs),
                             jnp.asarray(dts), jnp.zeros(6), NOISE)
        ws_p = np.concatenate([ws, np.ones((8, 3), np.float32)])
        accs_p = np.concatenate([accs, np.ones((8, 3), np.float32)])
        dts_p = np.concatenate([dts, np.zeros(8, np.float32)])
        out2 = pre.integrate(jnp.asarray(ws_p), jnp.asarray(accs_p),
                             jnp.asarray(dts_p), jnp.zeros(6), NOISE)
        np.testing.assert_allclose(np.asarray(out2.dR), np.asarray(out1.dR),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(out2.dP), np.asarray(out1.dP),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(out2.C), np.asarray(out1.C),
                                   atol=1e-9)

    def test_bias_jacobians_vs_reintegration(self):
        """First-order bias correction must match re-integration with the
        perturbed bias (reference: GetDeltaRotation/Velocity/Position)."""
        rng = np.random.default_rng(2)
        ws = (0.5 * rng.normal(size=(50, 3))).astype(np.float32)
        accs = (2.0 * rng.normal(size=(50, 3)) +
                np.array([0, 0, 9.81])).astype(np.float32)
        dts = np.full(50, 0.005, np.float32)
        b0 = jnp.zeros(6)
        out = pre.integrate(jnp.asarray(ws), jnp.asarray(accs),
                            jnp.asarray(dts), b0, NOISE)
        db = jnp.asarray(
            np.r_[1e-3 * rng.normal(size=3), 1e-2 * rng.normal(size=3)],
            dtype=jnp.float32)
        out_b = pre.integrate(jnp.asarray(ws), jnp.asarray(accs),
                              jnp.asarray(dts), b0 + db, NOISE)
        dR_corr = pre.delta_rotation(out, b0 + db)
        dV_corr = pre.delta_velocity(out, b0 + db)
        dP_corr = pre.delta_position(out, b0 + db)
        np.testing.assert_allclose(np.asarray(dR_corr), np.asarray(out_b.dR),
                                   atol=5e-4)
        np.testing.assert_allclose(np.asarray(dV_corr), np.asarray(out_b.dV),
                                   atol=5e-3)
        np.testing.assert_allclose(np.asarray(dP_corr), np.asarray(out_b.dP),
                                   atol=5e-3)

    def test_covariance_psd_and_growth(self):
        rng = np.random.default_rng(3)
        ws = (0.3 * rng.normal(size=(200, 3))).astype(np.float32)
        accs = (1.0 * rng.normal(size=(200, 3)) +
                np.array([0, 0, 9.81])).astype(np.float32)
        dts = np.full(200, 0.0025, np.float32)
        out = pre.integrate(jnp.asarray(ws), jnp.asarray(accs),
                            jnp.asarray(dts), jnp.zeros(6), NOISE)
        C = np.asarray(out.C, np.float64)
        C = 0.5 * (C + C.T)
        eig = np.linalg.eigvalsh(C)
        assert eig.min() > -1e-12, eig.min()
        assert np.all(np.diag(C)[:9] > 0)

    def test_batched_integration(self):
        """vmap over intervals — the bias-update reintegration path."""
        rng = np.random.default_rng(4)
        B = 8
        ws = (0.5 * rng.normal(size=(B, 30, 3))).astype(np.float32)
        accs = (1.0 * rng.normal(size=(B, 30, 3)) +
                np.array([0, 0, 9.81])).astype(np.float32)
        dts = np.full((B, 30), 0.005, np.float32)
        biases = np.zeros((B, 6), np.float32)
        out = pre.integrate_batch(jnp.asarray(ws), jnp.asarray(accs),
                                  jnp.asarray(dts), jnp.asarray(biases), NOISE)
        assert out.dR.shape == (B, 3, 3)
        single = pre.integrate(jnp.asarray(ws[3]), jnp.asarray(accs[3]),
                               jnp.asarray(dts[3]), jnp.zeros(6), NOISE)
        np.testing.assert_allclose(np.asarray(out.dV[3]),
                                   np.asarray(single.dV), atol=1e-6)

    def test_predict_state(self):
        """predict_state must reproduce the simulated trajectory endpoint."""
        w_body = np.array([0.1, 0.2, -0.3])
        a_fn = lambda t: np.array([0.3, 0.1, -0.2])
        n, dt = 60, 0.005
        ws, accs, dts, Rs, vs, ps = simulate_imu(n, dt, w_body, a_fn)
        out = pre.integrate(jnp.asarray(ws), jnp.asarray(accs),
                            jnp.asarray(dts), jnp.zeros(6), NOISE)
        R2, p2, v2 = pre.predict_state(
            jnp.asarray(Rs[0], dtype=jnp.float32), jnp.zeros(3), jnp.zeros(3),
            out, jnp.zeros(6))
        np.testing.assert_allclose(np.asarray(R2), Rs[-1], atol=5e-4)
        np.testing.assert_allclose(np.asarray(p2), ps[-1], atol=5e-3)
        np.testing.assert_allclose(np.asarray(v2), vs[-1], atol=5e-3)


class TestCompose:
    """compose(a, b) must equal integrating the concatenated sample stream
    (the closed-form replacement for MergePrevious's measurement replay,
    reference: src/ImuTypes.cc:241-263)."""

    def _samples(self, seed=0, n=24, dt=0.005):
        rng = np.random.default_rng(seed)
        ws = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
        accs = (rng.normal(0, 1.0, (n, 3)) + [0, 0, 9.81]).astype(np.float32)
        dts = np.full(n, dt, np.float32)
        return jnp.asarray(ws), jnp.asarray(accs), jnp.asarray(dts)

    def test_compose_matches_direct(self):
        ws, accs, dts = self._samples()
        bias = jnp.asarray([0.01, -0.02, 0.005, 0.1, -0.05, 0.02])
        full = pre.integrate(ws, accs, dts, bias, NOISE)
        half = ws.shape[0] // 2
        a = pre.integrate(ws[:half], accs[:half], dts[:half], bias, NOISE)
        b = pre.integrate(ws[half:], accs[half:], dts[half:], bias, NOISE)
        comp = pre.compose(a, b)
        np.testing.assert_allclose(comp.dR, full.dR, atol=1e-5)
        np.testing.assert_allclose(comp.dV, full.dV, atol=1e-5)
        np.testing.assert_allclose(comp.dP, full.dP, atol=1e-5)
        np.testing.assert_allclose(comp.dT, full.dT, atol=1e-6)
        for name in ("JRg", "JVg", "JVa", "JPg", "JPa"):
            np.testing.assert_allclose(
                getattr(comp, name), getattr(full, name),
                atol=2e-4, err_msg=name)
        # covariance: small-angle Jr-vs-I discrepancy only
        np.testing.assert_allclose(comp.C, full.C, atol=1e-8, rtol=2e-3)
        np.testing.assert_allclose(comp.avgA, full.avgA, atol=1e-4)
        np.testing.assert_allclose(comp.avgW, full.avgW, atol=1e-5)

    def test_identity_element(self):
        ws, accs, dts = self._samples(seed=1)
        bias = jnp.zeros(6)
        p = pre.integrate(ws, accs, dts, bias, NOISE)
        ident = pre.init_preintegrated(bias)
        for comp in (pre.compose(ident, p), pre.compose(p, ident)):
            np.testing.assert_allclose(comp.dR, p.dR, atol=1e-6)
            np.testing.assert_allclose(comp.dV, p.dV, atol=1e-6)
            np.testing.assert_allclose(comp.dP, p.dP, atol=1e-6)
            np.testing.assert_allclose(comp.C, p.C, atol=1e-12, rtol=1e-5)
            np.testing.assert_allclose(comp.JPg, p.JPg, atol=1e-6)

    def test_three_way_associative(self):
        ws, accs, dts = self._samples(seed=2, n=30)
        bias = jnp.zeros(6)
        t1, t2 = 10, 20
        a = pre.integrate(ws[:t1], accs[:t1], dts[:t1], bias, NOISE)
        b = pre.integrate(ws[t1:t2], accs[t1:t2], dts[t1:t2], bias, NOISE)
        c = pre.integrate(ws[t2:], accs[t2:], dts[t2:], bias, NOISE)
        ab_c = pre.compose(pre.compose(a, b), c)
        a_bc = pre.compose(a, pre.compose(b, c))
        np.testing.assert_allclose(ab_c.dP, a_bc.dP, atol=1e-5)
        np.testing.assert_allclose(ab_c.C, a_bc.C, atol=1e-9, rtol=1e-3)

    def test_rebias_matches_reintegration(self):
        ws, accs, dts = self._samples(seed=3)
        b0 = jnp.zeros(6)
        db = jnp.asarray([0.002, -0.001, 0.003, 0.01, -0.02, 0.015])
        p0 = pre.integrate(ws, accs, dts, b0, NOISE)
        p1 = pre.integrate(ws, accs, dts, b0 + db, NOISE)
        pr = pre.rebias(p0, b0 + db)
        np.testing.assert_allclose(pr.dR, p1.dR, atol=3e-4)
        np.testing.assert_allclose(pr.dV, p1.dV, atol=3e-3)
        np.testing.assert_allclose(pr.dP, p1.dP, atol=3e-3)

    def test_chain_storage(self):
        ws, accs, dts = self._samples(seed=4)
        bias = jnp.zeros(6)
        p = pre.integrate(ws, accs, dts, bias, NOISE)
        chain = pre.chain_allocate(8)
        chain = pre.chain_set(chain, 3, p)
        got = pre.chain_get(chain, 3)
        np.testing.assert_allclose(got.dP, p.dP, atol=1e-7)
        ident = pre.chain_get(chain, 0)
        np.testing.assert_allclose(ident.dR, np.eye(3), atol=1e-7)
        assert float(ident.dT) == 0.0
