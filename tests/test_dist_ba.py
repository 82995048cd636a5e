"""Distributed BA on the 8-device virtual CPU mesh: must match single-device
results (observation sharding is a pure reduction restructuring)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openmavis_jax.geometry import cameras, lie
from openmavis_jax.optim import ba
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.parallel import dist_ba, dist_place

# heavyweight (compile-dominated) — excluded from the fast tier
pytestmark = __import__('pytest').mark.slow

F = jnp.float32
PIN = jnp.array([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0], dtype=F)


def mono_rig():
    return RigParams(kind=cameras.PINHOLE, params=PIN[None],
                     R_cb=jnp.eye(3, dtype=F)[None],
                     t_cb=jnp.zeros((1, 3), dtype=F))


def make_problem(key, K=6, M=200):
    ks = jax.random.split(key, 8)
    points = jnp.stack([
        jax.random.uniform(ks[0], (M,), minval=-6, maxval=8),
        jax.random.uniform(ks[1], (M,), minval=-4, maxval=4),
        jax.random.uniform(ks[2], (M,), minval=6, maxval=14)], axis=-1)
    R_gt = jnp.stack([lie.so3_exp(jnp.array([0.0, 0.05 * k, 0.0], dtype=F))
                      for k in range(K)])
    t_gt = jnp.stack([jnp.array([0.4 * k, 0.0, 0.0], dtype=F)
                      for k in range(K)])
    kf = jnp.repeat(jnp.arange(K), M)
    mp = jnp.tile(jnp.arange(M), K)
    p_b = jnp.einsum("oji,oj->oi", R_gt[kf], points[mp] - t_gt[kf])
    uv = cameras.pinhole_project(PIN, p_b)
    uv = uv + 0.4 * jax.random.normal(ks[3], uv.shape)
    valid = (p_b[:, 2] > 1.0) & (jnp.abs(uv[:, 0] - 320) < 320) \
        & (jnp.abs(uv[:, 1] - 240) < 240)
    obs = ba.BAObservations(kf=kf, mp=mp, cam=jnp.zeros_like(kf), uv=uv,
                            sigma2=jnp.ones_like(uv[:, 0]), valid=valid)
    dR = jax.vmap(lie.so3_exp)(0.01 * jax.random.normal(ks[4], (K, 3)))
    z3 = jnp.zeros((K, 3), dtype=F)
    state0 = ba.BAState(
        R=(R_gt @ dR).at[:2].set(R_gt[:2]),
        t=(t_gt + 0.03 * jax.random.normal(ks[5], (K, 3))
           ).at[:2].set(t_gt[:2]),
        v=z3, bg=z3, ba=z3,
        points=points + 0.03 * jax.random.normal(ks[6], points.shape))
    fixed = jnp.asarray([True, True] + [False] * (K - 2))
    return state0, obs, fixed, R_gt, t_gt, points


class TestDistributedBA:
    def test_matches_single_device(self):
        assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
        state0, obs, fixed, R_gt, t_gt, points = make_problem(
            jax.random.PRNGKey(0))
        mesh = dist_ba.make_mesh(jax.devices()[:8])

        st_s, inl_s, chi_s = ba.bundle_adjust(state0, obs, mono_rig(),
                                              fixed)
        st_d, inl_d, chi_d = dist_ba.distributed_bundle_adjust(
            mesh, state0, obs, mono_rig(), fixed)

        # both must converge to the ground truth (float assoc. differences
        # mean bit-exactness is not expected, but solutions must agree)
        np.testing.assert_allclose(np.asarray(st_d.t), np.asarray(t_gt),
                                   atol=0.02)
        np.testing.assert_allclose(np.asarray(st_d.t), np.asarray(st_s.t),
                                   atol=0.01)
        assert abs(float(chi_d) - float(chi_s)) / max(float(chi_s), 1) < 0.1
        agree = float((inl_d == inl_s).mean())
        assert agree > 0.99, agree

    def test_uneven_observation_count(self):
        """Padding path: O not divisible by n_devices."""
        state0, obs, fixed, *_ = make_problem(jax.random.PRNGKey(1), K=5,
                                              M=101)
        mesh = dist_ba.make_mesh(jax.devices()[:8])
        st_d, inl_d, chi_d = dist_ba.distributed_bundle_adjust(
            mesh, state0, obs, mono_rig(), fixed)
        assert inl_d.shape[0] == obs.kf.shape[0]
        assert np.isfinite(float(chi_d))


class TestLandmarkShardedGBA:
    def test_matches_replicated(self):
        """Landmark-sharded GBA (points + Hll partitioned over the mesh)
        must agree with the replicated-state GBA and the single-device
        solve — the state-sharding scale-out path."""
        from openmavis_jax.optim import global_ba

        state0, obs, fixed, R_gt, t_gt, points = make_problem(
            jax.random.PRNGKey(2), K=6, M=160)
        mesh = dist_ba.make_mesh(jax.devices()[:8])
        rig = mono_rig()

        st_s, inl_s, chi_s = global_ba.global_bundle_adjust(
            state0, obs, rig, fixed, stages=(4, 6), cg_iters=24)
        st_l, inl_l, chi_l = dist_ba.distributed_global_ba_lsharded(
            mesh, state0, obs, rig, fixed, stages=(4, 6), cg_iters=24)

        np.testing.assert_allclose(np.asarray(st_l.t), np.asarray(t_gt),
                                   atol=0.03)
        np.testing.assert_allclose(np.asarray(st_l.t),
                                   np.asarray(st_s.t), atol=0.01)
        np.testing.assert_allclose(np.asarray(st_l.points),
                                   np.asarray(st_s.points), atol=0.05)
        assert (abs(float(chi_l) - float(chi_s))
                / max(float(chi_s), 1) < 0.1)
        agree = float((inl_l == inl_s).mean())
        assert agree > 0.98, agree

    def test_uneven_landmark_count(self):
        """M not divisible by n_devices: padding path."""
        state0, obs, fixed, *_ = make_problem(jax.random.PRNGKey(3), K=5,
                                              M=101)
        mesh = dist_ba.make_mesh(jax.devices()[:8])
        st_l, inl_l, chi_l = dist_ba.distributed_global_ba_lsharded(
            mesh, state0, obs, mono_rig(), fixed, stages=(3,))
        assert st_l.points.shape[0] == 101
        assert inl_l.shape[0] == obs.kf.shape[0]
        assert np.isfinite(float(chi_l))


class TestShardedPlaceRecognition:
    def test_matches_single_device(self):
        import jax.numpy as jnp
        from openmavis_jax.parallel import dist_place
        from openmavis_jax.pipeline import tracking
        from openmavis_jax.slam_map import map_state as ms

        key = jax.random.PRNGKey(0)
        K, F = 16, 64
        m = ms.allocate(K, F, 32)
        desc = jax.random.bernoulli(key, 0.5, (K, F, 256)).astype(jnp.int8)
        m = m._replace(kf_desc=desc,
                       kf_feat_valid=jnp.ones((K, F), bool),
                       kf_valid=jnp.ones((K,), bool),
                       kf_obs=jnp.zeros((K, F), jnp.int32))
        # query = noisy copy of KF 5's features
        noise = jax.random.bernoulli(jax.random.PRNGKey(1), 0.02,
                                     (F, 256)).astype(jnp.int8)
        q = jnp.abs(desc[5] - noise)
        m = m._replace(kf_desc=m.kf_desc.at[0].set(m.kf_desc[0]))

        # single-device reference: reuse descriptor_place_scores by writing
        # the query into a scratch slot
        m_q = m._replace(kf_desc=m.kf_desc.at[K - 1].set(q),
                         kf_valid=m.kf_valid.at[K - 1].set(True))
        ref = tracking.descriptor_place_scores(m_q, jnp.asarray(K - 1))

        mesh = dist_ba.make_mesh(jax.devices()[:8], axis="kf")
        scores = dist_place.sharded_place_scores(
            mesh, m.kf_desc, m.kf_feat_valid, m.kf_valid, q,
            jnp.ones((F,), bool))
        assert int(jnp.argmax(scores)) == 5
        # agreement with the single-device scoring on shared slots
        np.testing.assert_array_equal(np.asarray(scores[:K - 1]),
                                      np.asarray(ref[:K - 1]))
