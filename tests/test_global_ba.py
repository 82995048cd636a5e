"""Matrix-free Schur+PCG global BA: parity with the dense window BA and
Atlas-scale behavior (reference: Optimizer::GlobalBundleAdjustemnt /
FullInertialBA, src/Optimizer.cc:29/368)."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.geometry import cameras, lie
from openmavis_jax.optim import ba, global_ba
from openmavis_jax.optim.reprojection import RigParams

from test_ba import make_window, mono_rig

# heavyweight (compile-dominated) — excluded from the fast tier
pytestmark = __import__('pytest').mark.slow

F = jnp.float32


def _perturbed(points, R_gt, t_gt, K, seed=1):
    key = jax.random.PRNGKey(seed)
    dR = jax.vmap(lie.so3_exp)(0.02 * jax.random.normal(key, (K, 3)))
    R0 = (R_gt @ dR).at[:2].set(R_gt[:2])
    t0 = (t_gt + 0.05 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                          (K, 3))).at[:2].set(t_gt[:2])
    pts0 = points + 0.05 * jax.random.normal(
        jax.random.PRNGKey(seed + 2), points.shape)
    z3 = jnp.zeros((K, 3), dtype=F)
    return ba.BAState(R=R0, t=t0, v=z3, bg=z3, ba=z3, points=pts0)


class TestGlobalBA:
    def test_matches_dense_window_ba(self):
        K, M = 6, 300
        points, R_gt, t_gt, obs = make_window(jax.random.PRNGKey(0), K, M)
        state0 = _perturbed(points, R_gt, t_gt, K)
        fixed = jnp.asarray([True, True] + [False] * (K - 2))

        st_d, inl_d, chi_d = ba.bundle_adjust(
            state0, obs, mono_rig(), fixed)
        st_p, inl_p, chi_p = global_ba.global_bundle_adjust(
            state0, obs, mono_rig(), fixed, cg_iters=32)

        # both must reach the noise floor and agree on the poses
        t_err_d = np.abs(np.asarray(st_d.t - t_gt)).max()
        t_err_p = np.abs(np.asarray(st_p.t - t_gt)).max()
        assert t_err_p < 0.02, (t_err_p, t_err_d)
        assert float(chi_p) < 1.3 * float(chi_d) + 1.0, \
            (float(chi_p), float(chi_d))

    def test_scales_past_dense_window(self):
        """A problem size where ba.py's dense [K,6,M,3] coupling would be
        ~0.5 GB: the operator path must still run (and converge).
        Landmarks are spread along the whole trajectory so every keyframe
        is observed (make_window's box leaves far KFs unconstrained)."""
        K, M = 48, 4000
        ks = jax.random.split(jax.random.PRNGKey(7), 5)
        span = 0.4 * K
        points = jnp.stack([
            jax.random.uniform(ks[0], (M,), minval=-4, maxval=span + 8),
            jax.random.uniform(ks[1], (M,), minval=-4, maxval=4),
            jax.random.uniform(ks[2], (M,), minval=6, maxval=14)], axis=-1)
        R_gt = jnp.stack([lie.so3_exp(jnp.array([0.0, 0.05, 0.0], dtype=F))
                          for _ in range(K)])
        t_gt = jnp.stack([jnp.array([0.4 * k, 0.0, 0.0], dtype=F)
                          for k in range(K)])
        kf_idx = jnp.repeat(jnp.arange(K), M)
        mp_idx = jnp.tile(jnp.arange(M), K)
        p_b = jnp.einsum("oji,oj->oi", R_gt[kf_idx],
                         points[mp_idx] - t_gt[kf_idx])
        uv = cameras.pinhole_project(
            jnp.array([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0], dtype=F),
            p_b)
        uv = uv + 0.3 * jax.random.normal(ks[3], uv.shape)
        valid = ((p_b[:, 2] > 1.0) & (uv[:, 0] > 0) & (uv[:, 0] < 640)
                 & (uv[:, 1] > 0) & (uv[:, 1] < 480))
        obs = ba.BAObservations(kf=kf_idx, mp=mp_idx,
                                cam=jnp.zeros_like(kf_idx), uv=uv,
                                sigma2=jnp.ones_like(uv[:, 0]),
                                valid=valid)
        state0 = _perturbed(points, R_gt, t_gt, K, seed=11)
        fixed = jnp.asarray([True, True] + [False] * (K - 2))
        st, inl, chi = global_ba.global_bundle_adjust(
            state0, obs, mono_rig(), fixed, stages=(4, 6), cg_iters=32)
        # convergence criterion: reprojection noise floor, not GT-pose
        # distance — a long mono chain's MAP estimate legitimately drifts
        # from GT (gauge modes); the dense solver shows the same chi2
        n_act = int(inl.sum())
        assert float(chi) / max(n_act, 1) < 0.2, float(chi) / n_act
        t_err0 = np.abs(np.asarray(state0.t - t_gt)).max()
        t_err = np.abs(np.asarray(st.t - t_gt)).max()
        assert t_err < t_err0, (t_err, t_err0)

    def test_fixed_poses_untouched(self):
        K, M = 6, 200
        points, R_gt, t_gt, obs = make_window(jax.random.PRNGKey(2), K, M)
        state0 = _perturbed(points, R_gt, t_gt, K, seed=5)
        fixed = jnp.asarray([True, True] + [False] * (K - 2))
        st, _, _ = global_ba.global_bundle_adjust(
            state0, obs, mono_rig(), fixed, stages=(3,))
        np.testing.assert_array_equal(np.asarray(st.t[:2]),
                                      np.asarray(state0.t[:2]))
        np.testing.assert_array_equal(np.asarray(st.R[:2]),
                                      np.asarray(state0.R[:2]))


class TestDistributedGlobalBA:
    def test_matches_single_device(self):
        """Observation-sharded PCG GBA over the 8-device CPU mesh must
        track the single-device result (psum-reduced operators are
        bit-identical math up to reduction order)."""
        import jax
        from openmavis_jax.parallel import dist_ba

        K, M = 8, 400
        points, R_gt, t_gt, obs = make_window(jax.random.PRNGKey(3), K, M)
        state0 = _perturbed(points, R_gt, t_gt, K, seed=21)
        fixed = jnp.asarray([True, True] + [False] * (K - 2))

        st_1, _, chi_1 = global_ba.global_bundle_adjust(
            state0, obs, mono_rig(), fixed, stages=(4,), cg_iters=24)

        mesh = dist_ba.make_mesh(jax.devices()[:8])
        st_8, _, chi_8 = dist_ba.distributed_global_ba(
            mesh, state0, obs, mono_rig(), fixed, stages=(4,),
            cg_iters=24)
        np.testing.assert_allclose(np.asarray(st_8.t),
                                   np.asarray(st_1.t), atol=2e-3)
        t_err = np.abs(np.asarray(st_8.t - t_gt)).max()
        assert t_err < 0.02, t_err
