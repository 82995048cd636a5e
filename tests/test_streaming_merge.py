"""Device-side cross-map merge in the streaming pipeline
(streaming_lc.make_merge_step + atlas.merge_maps_device).

Reference parity target: LoopClosing's merge path — detect a candidate
in ANOTHER Atlas map, Sim3-weld the current map into it, run the welding
BA (/root/reference/src/LoopClosing.cc:176-204 scale sanity,
1956-2130 MergeLocal2). Here the whole chain is part of the fused
per-frame device program: session B streams with session A's map slab
resident on device, and the weld fires with ZERO host reads.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras
from openmavis_jax.imu import preintegration as pre_mod
from openmavis_jax.io import synthetic, evaluation
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.pipeline import streaming_vi
from openmavis_jax.slam_map import atlas as atlas_mod
from openmavis_jax.slam_map import map_state as ms

W, H = 320, 240
PIN = np.array([300.0, 300.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def _rig():
    return RigParams(
        kind=cameras.PINHOLE,
        params=jnp.asarray(np.stack([PIN, PIN])),
        R_cb=jnp.asarray(np.stack([np.eye(3), np.eye(3)])).astype(
            jnp.float32),
        t_cb=jnp.asarray([[0.1, 0, 0], [-0.1, 0, 0]],
                         jnp.float32))


def _render(world, rig, R_wb, t_wb):
    frames = []
    for c in range(2):
        R_cb = np.asarray(rig.R_cb[c])
        cb = -R_cb.T @ np.asarray(rig.t_cb[c])
        frames.append(synthetic.render_sequence(
            world, cameras.PINHOLE, np.asarray(rig.params[c]),
            R_wb @ R_cb.T,
            t_wb + np.einsum("tij,j->ti", R_wb, cb), W, H))
    return np.stack(frames, axis=1).astype(np.float32)


def _stream(tr, frames, imu, dt):
    it = iter(imu)
    pending = next(it, None)
    for i in range(len(frames)):
        t = i * dt
        b = []
        while pending is not None and pending[2] <= t + 1e-9:
            b.append(pending)
            pending = next(it, None)
        tr.push(frames[i], t, b)
    tr.block()


def _cfg(max_kf=32, max_mp=4096):
    return streaming_vi.VIStreamConfig(
        img_w=W, img_h=H, n_cams=2, stereo_pairs=((0, 1),),
        orb=extractor.OrbConfig(n_features=320, n_levels=6),
        imu_freq=200.0, imu_per_frame=16, max_kf=max_kf,
        max_mp=max_mp, traj_cap=128, ba_window=4, imu_init_kfs=4,
        kf_max_interval_s=0.15, temporal_refs=1, min_rig_landmarks=20,
        obs_cap=16384)


NOISE = pre_mod.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)


def test_merge_maps_device_matches_host():
    """Traced weld == host weld on a populated pair of maps."""
    rng = np.random.default_rng(0)
    K, F, M = 8, 64, 256

    def mk(n_kf, n_mp, seed):
        r = np.random.default_rng(seed)
        m = ms.allocate(K, F, M)
        m = m._replace(
            kf_R=jnp.tile(jnp.eye(3), (K, 1, 1)),
            kf_t=jnp.asarray(r.normal(0, 1, (K, 3)).astype(np.float32)),
            kf_valid=jnp.asarray(np.arange(K) < n_kf),
            kf_obs=jnp.asarray(
                np.where(r.uniform(size=(K, F)) < 0.5,
                         r.integers(0, n_mp, (K, F)), -1)),
            kf_feat_valid=jnp.ones((K, F), bool),
            mp_pos=jnp.asarray(r.normal(0, 2, (M, 3)).astype(
                np.float32)),
            mp_valid=jnp.asarray(np.arange(M) < n_mp),
            n_kf=jnp.asarray(n_kf, jnp.int32),
            n_mp=jnp.asarray(n_mp, jnp.int32))
        return m

    dst = mk(3, 100, 1)
    src = mk(4, 120, 2)
    s = jnp.asarray(1.0)
    Rm = jnp.asarray(np.eye(3, dtype=np.float32))
    t = jnp.asarray(np.array([1.0, 0.5, -0.25], np.float32))
    host, ok_h = atlas_mod.merge_maps(dst, src, s, Rm, t)
    dev_m, ok_d = atlas_mod.merge_maps_device(dst, src, s, Rm, t)
    assert ok_h and bool(ok_d)
    np.testing.assert_allclose(np.asarray(dev_m.kf_t),
                               np.asarray(host.kf_t), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(dev_m.kf_obs),
                                  np.asarray(host.kf_obs))
    np.testing.assert_allclose(np.asarray(dev_m.mp_pos),
                               np.asarray(host.mp_pos), atol=1e-5)
    assert int(dev_m.n_kf) == 7 and int(dev_m.n_mp) == 220

    # capacity overflow refuses the weld
    big = mk(6, 200, 3)
    _, ok_o = atlas_mod.merge_maps_device(big, src, s, Rm, t)
    assert not bool(ok_o)


@pytest.mark.slow
def test_two_session_device_merge():
    """Session B (fresh world origin, offset trajectory) welds into
    session A's resident slab on device; combined map is consistent."""
    rig = _rig()
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    dt = 0.05

    # session A: first 60% of an orbit
    nfa = 50
    R_a, t_a = synthetic.orbit_trajectory(nfa, radius=3.0, frac=0.35)
    frames_a = _render(world, rig, R_a, t_a)
    imu_a = synthetic.imu_from_trajectory(R_a, t_a, dt, rate_mult=10)
    tra = streaming_vi.StreamingVITracker(
        rig, _cfg(), NOISE, seed=0, device_lc=dict(score_min=25))
    _stream(tra, frames_a, imu_a, dt)
    snap_a = tra.snapshot()
    n_kf_a = int(snap_a["n_kf"])
    assert n_kf_a >= 4

    # session B: REVISITS the start of A's trajectory (same world poses)
    # but initializes its own world frame there — exactly the
    # new-map-after-loss situation the Atlas merge exists for
    nfb = 50
    R_b, t_b = synthetic.orbit_trajectory(nfb, radius=3.0, frac=0.35)
    frames_b = _render(world, rig, R_b, t_b)
    imu_b = synthetic.imu_from_trajectory(R_b, t_b, dt, rate_mult=10)
    trb = streaming_vi.StreamingVITracker(
        rig, _cfg(), NOISE, seed=1,
        device_lc=dict(score_min=25),
        secondary_map=tra.map,
        merge_kw=dict(score_min=25, min_pairs=15, min_group=20,
                      min_kf=7))
    _stream(trb, frames_b, imu_b, dt)

    snap = trb.snapshot()
    assert int(snap["n_merges"]) == 1, "device merge did not fire"
    kf_off = int(snap["merge_kf_off"])
    assert kf_off == n_kf_a
    # merged map holds BOTH sessions' keyframes
    assert int(snap["n_kf"]) > n_kf_a + 2
    assert np.isfinite(snap["kf_t"][:int(snap["n_kf"])]).all()

    # session B's trajectory, post-merge, lives in A's world frame and
    # must match ground truth after one rigid alignment
    t_est, _, p_est = trb.get_trajectory()
    ok = snap["ok"][:len(t_est)]
    assert ok.sum() > nfb * 0.8
    res = evaluation.ate_rmse(t_est[ok], p_est[ok],
                              np.arange(nfb) * dt, t_b,
                              with_scale=False)
    assert res["rmse"] < 0.12, f"post-merge ATE {res['rmse']}"
