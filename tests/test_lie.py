"""Lie-group property tests: exp/log round trips, Jacobians, Sim3 W integral.

Mirrors the property-test strategy of the reference's vendored Sophus tests
(reference: Thirdparty/Sophus/test/core/test_{so3,se3,sim3}.cpp) but runs them
batched through jit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openmavis_jax.geometry import lie


def _rand_w(key, n, scale=2.0):
    return scale * jax.random.normal(key, (n, 3))


class TestSO3:
    def test_exp_is_rotation(self):
        w = _rand_w(jax.random.PRNGKey(0), 64)
        R = lie.so3_exp(w)
        eye = jnp.eye(3)
        err = jnp.abs(R @ jnp.swapaxes(R, -1, -2) - eye).max()
        assert err < 1e-5
        assert jnp.abs(jnp.linalg.det(R) - 1).max() < 1e-5

    def test_exp_log_roundtrip(self):
        key = jax.random.PRNGKey(1)
        w = _rand_w(key, 256, scale=1.0)
        # clamp to |w| < pi (log returns the principal value), add tiny angles
        norm = jnp.linalg.norm(w, axis=-1, keepdims=True)
        w = w / norm * jnp.minimum(norm, 3.0)
        w = jnp.concatenate([w, 1e-6 * w])
        w2 = lie.so3_log(lie.so3_exp(w))
        np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=3e-4)

    def test_log_near_pi(self):
        axis = np.array([[1.0, 0, 0], [0, 1, 0], [0, 0, 1],
                         [0.6, 0.8, 0.0]])
        for theta in [np.pi - 1e-4, np.pi - 1e-2, 3.1]:
            w = jnp.asarray(theta * axis, dtype=jnp.float32)
            w2 = lie.so3_log(lie.so3_exp(w))
            # w and -w are equivalent near pi; compare rotations
            R1 = np.asarray(lie.so3_exp(w))
            R2 = np.asarray(lie.so3_exp(w2))
            np.testing.assert_allclose(R1, R2, atol=1e-3)

    def test_left_jacobian_derivative_identity(self):
        """exp(w + dw) ~ exp(Jl(w) dw) exp(w) (left Jacobian definition)."""
        key = jax.random.PRNGKey(2)
        w = _rand_w(key, 32, scale=1.5)
        dw = 1e-4 * jax.random.normal(jax.random.PRNGKey(3), (32, 3))
        lhs = lie.so3_exp(w + dw)
        Jl = lie.so3_left_jacobian(w)
        rhs = lie.so3_exp(jnp.einsum("nij,nj->ni", Jl, dw)) @ lie.so3_exp(w)
        np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-6)

    def test_jacobian_inverse(self):
        w = _rand_w(jax.random.PRNGKey(4), 64, scale=2.0)
        w = jnp.concatenate([w, 1e-7 * w])
        J = lie.so3_left_jacobian(w)
        Jinv = lie.so3_left_jacobian_inv(w)
        eye = jnp.broadcast_to(jnp.eye(3), J.shape)
        np.testing.assert_allclose(np.asarray(J @ Jinv), np.asarray(eye),
                                   atol=1e-5)

    def test_gamma2_matches_quadrature(self):
        """Gamma_2(w) = int_0^1 (1-u) exp(u w^) du via dense quadrature."""
        rng = np.random.default_rng(0)
        us = jnp.linspace(0, 1, 4001)[:, None]
        for scale in [1e-5, 0.1, 2.0]:
            w = jnp.asarray(scale * rng.standard_normal(3), dtype=jnp.float32)
            Rs = lie.so3_exp(us * w[None, :])  # [U, 3, 3]
            acc = jnp.mean((1.0 - us)[..., None] * Rs, axis=0)
            np.testing.assert_allclose(np.asarray(lie.so3_gamma2(w)),
                                       np.asarray(acc), atol=5e-4)

    def test_normalize_rotation(self):
        R = lie.so3_exp(_rand_w(jax.random.PRNGKey(5), 16))
        noisy = R + 1e-3 * jax.random.normal(jax.random.PRNGKey(6), R.shape)
        Rn = lie.normalize_rotation(noisy)
        eye = jnp.eye(3)
        assert jnp.abs(Rn @ jnp.swapaxes(Rn, -1, -2) - eye).max() < 1e-5

    def test_gradients_finite_at_zero(self):
        g = jax.grad(lambda w: lie.so3_exp(w).sum())(jnp.zeros(3))
        assert np.all(np.isfinite(np.asarray(g)))
        g2 = jax.grad(lambda w: lie.so3_left_jacobian(w).sum())(jnp.zeros(3))
        assert np.all(np.isfinite(np.asarray(g2)))


class TestSE3:
    def test_exp_log_roundtrip(self):
        key = jax.random.PRNGKey(7)
        xi = jax.random.normal(key, (128, 6))
        wn = jnp.linalg.norm(xi[:, 3:], axis=-1, keepdims=True)
        xi = xi.at[:, 3:].multiply(jnp.minimum(wn, 2.8) / wn)
        xi = jnp.concatenate([xi, 1e-6 * xi])
        R, t = lie.se3_exp(xi)
        xi2 = lie.se3_log(R, t)
        np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi), atol=3e-4)

    def test_compose_inverse(self):
        xi = jax.random.normal(jax.random.PRNGKey(8), (32, 6))
        R, t = lie.se3_exp(xi)
        Ri, ti = lie.se3_inverse(R, t)
        Rc, tc = lie.se3_compose(R, t, Ri, ti)
        np.testing.assert_allclose(np.asarray(Rc),
                                   np.broadcast_to(np.eye(3), Rc.shape),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(tc), 0, atol=1e-5)

    def test_apply_matches_matrix(self):
        xi = jax.random.normal(jax.random.PRNGKey(9), (8, 6))
        R, t = lie.se3_exp(xi)
        p = jax.random.normal(jax.random.PRNGKey(10), (8, 3))
        out = lie.se3_apply(R, t, p)
        M = lie.se3_matrix(R, t)
        ph = jnp.concatenate([p, jnp.ones((8, 1))], axis=-1)
        out2 = jnp.einsum("nij,nj->ni", M, ph)[:, :3]
        np.testing.assert_allclose(np.asarray(out), np.asarray(out2), atol=1e-5)


class TestSim3:
    def test_W_matches_quadrature(self):
        rng = np.random.default_rng(1)
        cases = [(0.5, 1.0), (1e-6, 1.0), (1.5, 1e-6), (1e-6, 1e-6),
                 (2.0, -0.7)]
        n = 8000
        du = 1.0 / n
        um = (jnp.arange(n) + 0.5)[:, None] * du  # midpoint rule
        for theta_scale, sigma in cases:
            w = jnp.asarray(theta_scale * rng.standard_normal(3) /
                            np.sqrt(3), dtype=jnp.float32)
            sig = jnp.asarray(sigma, dtype=jnp.float32)
            Rs = lie.so3_exp(um * w[None, :])
            acc = jnp.mean(jnp.exp(sig * um)[..., None] * Rs, axis=0)
            W = np.asarray(lie._sim3_W(w, sig))
            np.testing.assert_allclose(W, np.asarray(acc), atol=5e-4)

    def test_exp_log_roundtrip(self):
        key = jax.random.PRNGKey(11)
        xi = jax.random.normal(key, (64, 7))
        xi = xi.at[:, 6].multiply(0.3)  # keep scale sane
        wn = jnp.linalg.norm(xi[:, 3:6], axis=-1, keepdims=True)
        xi = xi.at[:, 3:6].multiply(jnp.minimum(wn, 2.8) / wn)
        xi = jnp.concatenate([xi, 1e-5 * xi])
        s, R, t = lie.sim3_exp(xi)
        xi2 = lie.sim3_log(s, R, t)
        np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi), atol=3e-3)

    def test_compose_inverse(self):
        xi = jax.random.normal(jax.random.PRNGKey(12), (16, 7))
        xi = xi.at[:, 6].multiply(0.3)
        s, R, t = lie.sim3_exp(xi)
        si, Ri, ti = lie.sim3_inverse(s, R, t)
        sc, Rc, tc = lie.sim3_compose(s, R, t, si, Ri, ti)
        np.testing.assert_allclose(np.asarray(sc), 1.0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(tc), 0, atol=1e-4)


class TestQuat:
    def test_roundtrip(self):
        w = _rand_w(jax.random.PRNGKey(13), 128, scale=2.5)
        R = lie.so3_exp(w)
        q = lie.rotmat_to_quat(R)
        R2 = lie.quat_to_rotmat(q)
        np.testing.assert_allclose(np.asarray(R2), np.asarray(R), atol=1e-5)
