"""Mapper maintenance ops: landmark fusion, landmark/keyframe culling,
settings parsing."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.io import settings as settings_mod
from openmavis_jax.pipeline import tracking
from openmavis_jax.slam_map import map_state as ms


def small_map(K=6, F=8, M=32):
    return ms.allocate(K, F, M)


class TestFusion:
    def test_duplicate_merged(self):
        m = small_map()
        desc = jax.random.bernoulli(jax.random.PRNGKey(0), 0.5,
                                    (256,)).astype(jnp.int8)
        # old landmark 0 and a fresh duplicate landmark 1 (same pos/desc)
        m = m._replace(
            mp_pos=m.mp_pos.at[0].set(jnp.asarray([1.0, 0, 5.0]))
                           .at[1].set(jnp.asarray([1.001, 0, 5.0])),
            mp_desc=m.mp_desc.at[0].set(desc).at[1].set(desc),
            mp_valid=m.mp_valid.at[:2].set(True),
            mp_first_kf=m.mp_first_kf.at[1].set(3),
            n_mp=jnp.asarray(2, jnp.int32),
            kf_obs=m.kf_obs.at[3, 0].set(1),
            kf_valid=m.kf_valid.at[3].set(True),
            kf_feat_valid=m.kf_feat_valid.at[3, 0].set(True))
        out = tracking.fuse_new_landmarks(m, jnp.asarray(3), cap=8)
        assert not bool(out.mp_valid[1])      # duplicate killed
        assert bool(out.mp_valid[0])
        assert int(out.kf_obs[3, 0]) == 0     # observation re-pointed

    def test_distinct_kept(self):
        m = small_map()
        d0 = jnp.zeros((256,), jnp.int8)
        d1 = jnp.ones((256,), jnp.int8)
        m = m._replace(
            mp_pos=m.mp_pos.at[0].set(jnp.asarray([1.0, 0, 5.0]))
                           .at[1].set(jnp.asarray([3.0, 1, 7.0])),
            mp_desc=m.mp_desc.at[0].set(d0).at[1].set(d1),
            mp_valid=m.mp_valid.at[:2].set(True),
            mp_first_kf=m.mp_first_kf.at[1].set(3),
            n_mp=jnp.asarray(2, jnp.int32))
        out = tracking.fuse_new_landmarks(m, jnp.asarray(3), cap=8)
        assert bool(out.mp_valid[1])


class TestCulling:
    def test_landmark_cull(self):
        m = small_map()
        m = m._replace(
            mp_valid=m.mp_valid.at[:2].set(True),
            mp_visible=m.mp_visible.at[0].set(20).at[1].set(20),
            mp_found=m.mp_found.at[0].set(1).at[1].set(18),
            mp_first_kf=m.mp_first_kf.at[:2].set(0))
        out = tracking.cull_landmarks(m, jnp.asarray(5))
        assert not bool(out.mp_valid[0])   # ratio 0.05 -> culled
        assert bool(out.mp_valid[1])       # ratio 0.9 -> kept

    def test_keyframe_cull(self):
        K, F, M = 10, 8, 32
        m = small_map(K, F, M)
        # landmarks 0..7 observed by KFs 2..6 (>3 other observers each,
        # the reference's nObs > thObs=3 bar), KF 7 observes unique
        # landmarks 8..15
        obs = jnp.full((K, F), -1, jnp.int32)
        for k in [2, 3, 4, 5, 6]:
            obs = obs.at[k].set(jnp.arange(8, dtype=jnp.int32))
        obs = obs.at[7].set(jnp.arange(8, 16, dtype=jnp.int32))
        m = m._replace(
            kf_obs=obs,
            kf_valid=m.kf_valid.at[2:8].set(True),
            kf_feat_valid=jnp.ones((K, F), bool),
            mp_valid=m.mp_valid.at[:16].set(True),
            n_kf=jnp.asarray(8, jnp.int32))
        out, culled = tracking.cull_keyframes(m, jnp.asarray(20),
                                              keep_recent=2)
        # redundant KFs among 2..6 culled (up to max_cull per pass,
        # never temporally adjacent), KF 7 kept
        culled = [int(x) for x in np.asarray(culled) if int(x) >= 0]
        assert 1 <= len(culled) <= 2
        assert int(out.kf_valid[2:7].sum()) == 5 - len(culled)
        assert bool(out.kf_valid[7])
        for ck in culled:
            assert 2 <= ck <= 6
            assert not bool(out.kf_valid[ck])
        if len(culled) == 2:
            assert abs(culled[0] - culled[1]) >= 2

    def test_keyframe_cull_scale_condition(self):
        """Co-observers at a much COARSER pyramid level don't make a
        fine-scale observation redundant (LocalMapping.cc:974's
        scaleLevel <= scaleLevel_i + 1 condition)."""
        K, F, M = 8, 8, 32
        m = small_map(K, F, M)
        obs = jnp.full((K, F), -1, jnp.int32)
        for k in [2, 3, 4, 5]:
            obs = obs.at[k].set(jnp.arange(8, dtype=jnp.int32))
        # KF 3 sees everything at level 0; the other observers only at
        # level 5 — too coarse to replace it
        lvl = jnp.full((K, F), 5, jnp.int32).at[3].set(0)
        m = m._replace(
            kf_obs=obs, kf_level=lvl,
            kf_valid=m.kf_valid.at[2:6].set(True),
            kf_feat_valid=jnp.ones((K, F), bool),
            mp_valid=m.mp_valid.at[:8].set(True),
            n_kf=jnp.asarray(6, jnp.int32))
        out, culled = tracking.cull_keyframes(m, jnp.asarray(20),
                                              keep_recent=2)
        assert bool(out.kf_valid[3])
        # KFs 2/4/5 are mutually redundant at equal scale; 3 survives
        assert all(int(x) != 3 for x in np.asarray(culled))

    def test_keyframe_cull_inertial_guards(self):
        """Inertial culling needs >Nd keyframes in the map and refuses
        culls that open a temporal hole in the preintegration chain
        (LocalMapping.cc:1110-1120)."""
        K, F, M = 32, 8, 64
        m = small_map(K, F, M)
        # every KF sees the same 8 landmarks -> all maximally redundant
        obs = jnp.tile(jnp.arange(8, dtype=jnp.int32)[None], (K, 1))
        times = jnp.arange(K, dtype=jnp.float32) * 0.25
        m = m._replace(
            kf_obs=obs, kf_time=times,
            kf_valid=jnp.ones((K,), bool),
            kf_feat_valid=jnp.ones((K, F), bool),
            mp_valid=m.mp_valid.at[:8].set(True),
            n_kf=jnp.asarray(K, jnp.int32))
        # small map (valid count <= Nd): no culls at all
        m_small = m._replace(
            kf_valid=m.kf_valid.at[21:].set(False))
        _, culled = tracking.cull_keyframes(
            m_small, jnp.asarray(31), keep_recent=2, inertial=True)
        assert all(int(x) == -1 for x in np.asarray(culled))
        # full map, 0.25 s cadence (gap after cull = 0.5 s): culls fire
        out, culled = tracking.cull_keyframes(
            m, jnp.asarray(31), keep_recent=2, inertial=True)
        fired = [int(x) for x in np.asarray(culled) if int(x) >= 0]
        assert fired
        # 4 s cadence (any cull opens an 8 s hole): refused even though
        # every keyframe is redundant
        m_wide = m._replace(kf_time=times * 16.0)
        _, culled = tracking.cull_keyframes(
            m_wide, jnp.asarray(31), keep_recent=2, inertial=True)
        assert all(int(x) == -1 for x in np.asarray(culled))


class TestRecycling:
    """Slot recycling: compaction of culled keyframes/landmarks so
    fixed-capacity slabs survive unbounded sequences (reference deletes
    KFs outright, src/LocalMapping.cc:974)."""

    def _populated(self, K=8, F=8, M=32):
        m = small_map(K, F, M)
        key = jax.random.PRNGKey(1)
        R = jnp.tile(jnp.eye(3), (K, 1, 1))
        t = jax.random.normal(key, (K, 3))
        obs = jnp.where(
            jax.random.bernoulli(key, 0.5, (K, F)),
            jax.random.randint(key, (K, F), 0, 12), -1)
        m = m._replace(
            kf_R=R, kf_t=t,
            kf_time=jnp.arange(K, dtype=jnp.float32),
            kf_valid=jnp.ones((K,), bool),
            kf_feat_valid=jnp.ones((K, F), bool),
            kf_obs=obs,
            mp_pos=jax.random.normal(key, (M, 3)),
            mp_valid=(jnp.arange(M) < 12),
            mp_first_kf=jnp.clip(jnp.arange(M) % K, 0, K - 1),
            mp_last_kf=jnp.clip(jnp.arange(M) % K + 1, 0, K - 1),
            n_kf=jnp.asarray(K, jnp.int32),
            n_mp=jnp.asarray(12, jnp.int32))
        return m

    def test_compact_keyframes(self):
        m = self._populated()
        # cull slots 2 and 5
        m = m._replace(
            kf_valid=m.kf_valid.at[2].set(False).at[5].set(False),
            kf_obs=m.kf_obs.at[2].set(-1).at[5].set(-1))
        out, old_of_new, new_of_old = ms.compact_keyframes(m)
        assert int(out.n_kf) == 6
        assert bool(out.kf_valid[:6].all()) and not bool(
            out.kf_valid[6:].any())
        # survivors keep their data, in temporal order
        old_order = [0, 1, 3, 4, 6, 7]
        np.testing.assert_array_equal(np.asarray(old_of_new)[:6],
                                      old_order)
        np.testing.assert_allclose(np.asarray(out.kf_t[:6]),
                                   np.asarray(m.kf_t)[old_order])
        np.testing.assert_array_equal(np.asarray(out.kf_obs[:6]),
                                      np.asarray(m.kf_obs)[old_order])
        # culled slot maps to nearest preceding survivor
        nol = np.asarray(new_of_old)
        assert nol[2] == nol[1] and nol[5] == nol[4]

    def test_compact_landmarks_remaps_obs(self):
        m = self._populated()
        kill = jnp.asarray([1, 4, 7])
        m = m._replace(mp_valid=m.mp_valid.at[kill].set(False))
        out, n_mp = ms.compact_landmarks(m)
        assert int(n_mp) == 9
        # every surviving observation points at the same 3D point
        old_obs = np.asarray(m.kf_obs)
        new_obs = np.asarray(out.kf_obs)
        old_pos = np.asarray(m.mp_pos)
        new_pos = np.asarray(out.mp_pos)
        mp_valid = np.asarray(m.mp_valid)
        for k in range(old_obs.shape[0]):
            for f in range(old_obs.shape[1]):
                j = old_obs[k, f]
                if j >= 0 and mp_valid[j]:
                    assert new_obs[k, f] >= 0
                    np.testing.assert_allclose(new_pos[new_obs[k, f]],
                                               old_pos[j])
                else:
                    assert new_obs[k, f] == -1

    def test_decimate_frees_slots(self):
        m = self._populated()
        out, drop = ms.decimate_keyframes(m, jnp.asarray(7),
                                          keep_recent=2, keep_first=1)
        assert int(out.kf_valid.sum()) < 8
        assert bool(out.kf_valid[0])          # first KFs protected
        assert bool(out.kf_valid[7]) and bool(out.kf_valid[6])

    def test_recycle_preserves_trajectory(self):
        m = self._populated()
        m = m._replace(
            kf_R=jax.vmap(lambda i: jnp.eye(3) * jnp.cos(i * 0.1)
                          + jnp.sin(i * 0.1) * jnp.asarray(
                              [[0., -1, 0], [1, 0, 0], [0, 0, 0]])
                          + (1 - jnp.cos(i * 0.1)) * jnp.asarray(
                              [[0., 0, 0], [0, 0, 0], [0, 0, 1]]))(
                jnp.arange(8, dtype=jnp.float32)),
            kf_valid=m.kf_valid.at[3].set(False),
            kf_obs=m.kf_obs.at[3].set(-1))
        # trajectory entries referencing culled KF 3 and survivor 4
        kf_R = np.asarray(m.kf_R)
        kf_t = np.asarray(m.kf_t)
        traj = []
        world = []
        for ref in [1, 3, 4, 6]:
            R_rel = np.eye(3)
            t_rel = np.asarray([0.1, 0.0, 0.0])
            traj.append((float(ref), 0, ref, R_rel, t_rel))
            world.append((kf_R[ref] @ R_rel,
                          kf_t[ref] + kf_R[ref] @ t_rel))
        m2, traj2, _, _, _ = tracking.recycle_map_slots(m, traj, 0)
        kf_R2 = np.asarray(m2.kf_R)
        kf_t2 = np.asarray(m2.kf_t)
        for (entry, (R_w, t_w)) in zip(traj2, world):
            _, _, ref, R_rel, t_rel = entry
            np.testing.assert_allclose(kf_R2[ref] @ R_rel, R_w,
                                       atol=1e-5)
            np.testing.assert_allclose(
                kf_t2[ref] + kf_R2[ref] @ t_rel, t_w, atol=1e-5)


class TestSettings:
    def test_parse_roundtrip(self):
        cfg = settings_mod.example_settings(n_cams=2)
        cfg["Camera2"]["T_b_c"] = np.block(
            [[np.eye(3), np.asarray([[0.2], [0.0], [0.0]])],
             [np.zeros((1, 3)), np.ones((1, 1))]]).tolist()
        s = settings_mod.load_settings(cfg)
        rig = s["rig"]
        assert rig.params.shape == (2, 8)
        # camera 2 sits 0.2m along body x: t_cb = -R^T t_bc
        np.testing.assert_allclose(np.asarray(rig.t_cb[1]),
                                   [-0.2, 0, 0], atol=1e-6)
        assert s["orb"].n_features == 512
        assert s["imu_noise"] is not None
