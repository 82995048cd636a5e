"""Camera model tests: project/unproject round trips, analytic Jacobians vs
autodiff, triangulation of synthetic geometry."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.geometry import cameras, lie, triangulation

PINHOLE_P = jnp.array([458.654, 457.296, 367.215, 248.375, 0, 0, 0, 0],
                      dtype=jnp.float32)
# TUM-VI-like fisheye
KB8_P = jnp.array([190.978, 190.973, 254.932, 256.897,
                   0.00348, 0.000715, -0.0020532, 0.000202], dtype=jnp.float32)


def _random_points(key, n, fov_limit=1.2):
    """Points in front of the camera within ~fov_limit radians off-axis."""
    k1, k2, k3 = jax.random.split(key, 3)
    theta = fov_limit * jax.random.uniform(k1, (n,))
    psi = 2 * jnp.pi * jax.random.uniform(k2, (n,))
    depth = 0.5 + 9.5 * jax.random.uniform(k3, (n,))
    d = jnp.stack([jnp.sin(theta) * jnp.cos(psi),
                   jnp.sin(theta) * jnp.sin(psi),
                   jnp.cos(theta)], axis=-1)
    return depth[:, None] * d


class TestPinhole:
    def test_roundtrip(self):
        p = _random_points(jax.random.PRNGKey(0), 256, fov_limit=0.6)
        uv = cameras.pinhole_project(PINHOLE_P, p)
        ray = cameras.pinhole_unproject(PINHOLE_P, uv)
        p_dir = p / jnp.linalg.norm(p, axis=-1, keepdims=True)
        np.testing.assert_allclose(np.asarray(ray), np.asarray(p_dir),
                                   atol=1e-5)

    def test_jacobian_vs_autodiff(self):
        p = _random_points(jax.random.PRNGKey(1), 64, fov_limit=0.6)
        J = cameras.pinhole_project_jac(PINHOLE_P, p)
        J_auto = jax.vmap(jax.jacfwd(
            lambda q: cameras.pinhole_project(PINHOLE_P, q)))(p)
        np.testing.assert_allclose(np.asarray(J), np.asarray(J_auto),
                                   rtol=1e-4, atol=1e-4)


class TestRadtan:
    DIST = jnp.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
                     dtype=jnp.float32)  # EuRoC cam0

    def test_undistort_inverts_distort(self):
        key = jax.random.PRNGKey(2)
        xy = 0.3 * jax.random.normal(key, (256, 2))
        # keep within the sensor's actual normalized-coordinate range
        # (EuRoC: |x| < ~0.8) where the radtan model is invertible
        n = jnp.linalg.norm(xy, axis=-1, keepdims=True)
        xy = xy * jnp.minimum(n, 0.7) / jnp.maximum(n, 1e-9)
        xy_d = cameras.radtan_distort(self.DIST, xy)
        xy_u = cameras.radtan_undistort(self.DIST, xy_d)
        np.testing.assert_allclose(np.asarray(xy_u), np.asarray(xy),
                                   atol=1e-4)


class TestKB8:
    def test_roundtrip(self):
        p = _random_points(jax.random.PRNGKey(3), 512, fov_limit=1.5)
        uv = cameras.kb8_project(KB8_P, p)
        ray = cameras.kb8_unproject(KB8_P, uv)
        p_dir = p / jnp.linalg.norm(p, axis=-1, keepdims=True)
        np.testing.assert_allclose(np.asarray(ray), np.asarray(p_dir),
                                   atol=1e-4)

    def test_on_axis(self):
        p = jnp.array([[0.0, 0.0, 2.0], [1e-8, -1e-8, 1.0]])
        uv = cameras.kb8_project(KB8_P, p)
        np.testing.assert_allclose(np.asarray(uv),
                                   np.asarray(KB8_P[2:4])[None].repeat(2, 0),
                                   atol=1e-3)

    def test_jacobian_vs_autodiff(self):
        p = _random_points(jax.random.PRNGKey(4), 128, fov_limit=1.4)
        J = cameras.kb8_project_jac(KB8_P, p)
        J_auto = jax.vmap(jax.jacfwd(
            lambda q: cameras.kb8_project(KB8_P, q)))(p)
        np.testing.assert_allclose(np.asarray(J), np.asarray(J_auto),
                                   rtol=2e-3, atol=2e-3)


class TestTriangulation:
    def test_midpoint_exact(self):
        """Two cameras 0.2 m apart looking at known points."""
        key = jax.random.PRNGKey(5)
        p = _random_points(key, 128, fov_limit=0.8) + jnp.array([0, 0, 2.0])
        R12 = jnp.broadcast_to(jnp.eye(3), (128, 3, 3))
        t12 = jnp.broadcast_to(jnp.array([0.2, 0.0, 0.0]), (128, 3))
        d1 = p / jnp.linalg.norm(p, axis=-1, keepdims=True)
        p_c2 = p - t12
        d2 = p_c2 / jnp.linalg.norm(p_c2, axis=-1, keepdims=True)
        X, s1, s2 = triangulation.triangulate_rays_midpoint(
            jnp.zeros_like(t12), d1, t12, d2)
        # f32 conditioning: depth^2/baseline amplifies rounding; ~1 cm at 10 m
        np.testing.assert_allclose(np.asarray(X), np.asarray(p), atol=2e-2)
        assert np.all(np.asarray(s1) > 0) and np.all(np.asarray(s2) > 0)

    def test_triangulate_matches_kb8(self):
        key = jax.random.PRNGKey(6)
        n = 256
        p = _random_points(key, n, fov_limit=1.0) + jnp.array([0, 0, 1.5])
        w = jnp.array([0.0, 0.3, 0.0])
        R12 = jnp.broadcast_to(lie.so3_exp(w), (n, 3, 3))
        t12 = jnp.broadcast_to(jnp.array([0.3, 0.0, 0.05]), (n, 3))
        p_c2 = jnp.einsum("nji,nj->ni", R12, p - t12)
        uv1 = cameras.kb8_project(jnp.broadcast_to(KB8_P, (n, 8)), p)
        uv2 = cameras.kb8_project(jnp.broadcast_to(KB8_P, (n, 8)), p_c2)
        X, depth, valid = triangulation.triangulate_matches(
            cameras.KB8, jnp.broadcast_to(KB8_P, (n, 8)),
            jnp.broadcast_to(KB8_P, (n, 8)), R12, t12, uv1, uv2)
        frac_valid = float(jnp.mean(valid.astype(jnp.float32)))
        assert frac_valid > 0.8, frac_valid
        err = jnp.linalg.norm(X - p, axis=-1)
        assert float(jnp.max(jnp.where(valid, err, 0.0))) < 1e-2

    def test_dlt(self):
        n = 64
        key = jax.random.PRNGKey(7)
        p = _random_points(key, n, fov_limit=0.5) + jnp.array([0, 0, 3.0])
        R = lie.so3_exp(jnp.array([0.05, -0.1, 0.02]))
        t = jnp.array([0.4, 0.0, 0.0])
        P1 = jnp.broadcast_to(
            jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1),
            (n, 3, 4))
        # camera 2 maps world (=cam1) points: x2 = R^T (p - t)
        Rt = R.T
        P2 = jnp.broadcast_to(
            jnp.concatenate([Rt, (-Rt @ t)[:, None]], axis=1), (n, 3, 4))
        x1 = p[:, :2] / p[:, 2:3]
        pc2 = jnp.einsum("ij,nj->ni", Rt, p - t)
        x2 = pc2[:, :2] / pc2[:, 2:3]
        X = triangulation.triangulate_dlt(P1, P2, x1, x2)
        np.testing.assert_allclose(np.asarray(X), np.asarray(p), atol=1e-2)


class TestUndistortFeatures:
    def test_roundtrip_single_and_multicam(self):
        """Distorted-pinhole keypoints lift to ideal pinhole pixels
        (reference: Frame::UndistortKeyPoints via cv::undistortPoints)."""
        from openmavis_jax.frontend import extractor
        params = jnp.asarray([458.0, 457.0, 367.0, 248.0, 0, 0, 0, 0])
        dist = jnp.asarray([-0.28, 0.074, 1.9e-4, 1.8e-5])
        key = jax.random.PRNGKey(0)
        K = 64
        # ideal pixels well inside the image
        uv_ideal = jnp.stack([
            jax.random.uniform(key, (K,), minval=100, maxval=650),
            jax.random.uniform(jax.random.PRNGKey(1), (K,),
                               minval=80, maxval=400)], axis=-1)
        # distort them to get raw-detector coordinates
        fx, fy, cx, cy = params[0], params[1], params[2], params[3]
        xy = jnp.stack([(uv_ideal[:, 0] - cx) / fx,
                        (uv_ideal[:, 1] - cy) / fy], axis=-1)
        xy_d = cameras.radtan_distort(dist, xy)
        uv_raw = jnp.stack([fx * xy_d[:, 0] + cx,
                            fy * xy_d[:, 1] + cy], axis=-1)

        def mk(xy):
            z = jnp.zeros((xy.shape[0],))
            return extractor.Features(
                xy=xy, response=z, angle=z,
                level=z.astype(jnp.int32), sigma2=z + 1,
                desc=jnp.zeros((xy.shape[0], 256), jnp.int8),
                valid=jnp.ones((xy.shape[0],), bool))

        out = extractor.undistort_features(mk(uv_raw), params, dist)
        np.testing.assert_allclose(np.asarray(out.xy),
                                   np.asarray(uv_ideal), atol=0.05)
        # camera-batched variant [C, K, 2]
        f2 = jax.tree.map(lambda a: jnp.stack([a, a]), mk(uv_raw))
        out2 = extractor.undistort_features(
            f2, jnp.stack([params, params]), jnp.stack([dist, dist]))
        np.testing.assert_allclose(np.asarray(out2.xy[1]),
                                   np.asarray(uv_ideal), atol=0.05)
        # None distortion is a no-op
        out3 = extractor.undistort_features(mk(uv_raw), params, None)
        assert out3.xy is not None
        np.testing.assert_allclose(np.asarray(out3.xy),
                                   np.asarray(uv_raw))
