"""Streaming multi-camera VI pipeline end-to-end (single-dispatch-per-frame).

Covers the flagship MAVIS configuration as a device-resident program:
stereo-inertial rig init, VI tracking, staged IMU init inside the step,
and the mono-inertial (two-view init) path.

(reference behaviors: Tracking::GrabImageMulti src/Tracking.cc:1410,
LocalMapping::InitializeIMU src/LocalMapping.cc:1255, 30 fps pacing
Examples/Multi-Inertial/multi_inertial_euroc.cc:193-202.)
"""

import numpy as np
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras
from openmavis_jax.io import evaluation, synthetic
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.pipeline import streaming_vi

W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
BASELINE = 0.2
DT = 1.0 / 20.0


def stereo_rig():
    R_cb = jnp.stack([jnp.eye(3), jnp.eye(3)])
    t_cb = jnp.asarray([[BASELINE / 2, 0, 0], [-BASELINE / 2, 0, 0]],
                       dtype=jnp.float32)
    return RigParams(kind=cameras.PINHOLE,
                     params=jnp.stack([jnp.asarray(PIN)] * 2),
                     R_cb=R_cb, t_cb=t_cb)


@pytest.fixture(scope="module")
def sequence():
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    n_frames = 30
    R_wb, t_wb = synthetic.orbit_trajectory(n_frames, radius=6.0, frac=0.2)
    rig = stereo_rig()
    frames = []
    for c in range(2):
        R_bc = np.asarray(rig.R_cb[c]).T
        c_b = -np.asarray(rig.R_cb[c]).T @ np.asarray(rig.t_cb[c])
        R_wc = R_wb @ R_bc
        t_wc = t_wb + np.einsum("tij,j->ti", R_wb, c_b)
        frames.append(synthetic.render_sequence(
            world, cameras.PINHOLE, PIN, R_wc, t_wc, W, H))
    frames = np.stack(frames, axis=1)        # [T, C, H, W]
    imu = synthetic.imu_from_trajectory(R_wb, t_wb, DT, rate_mult=10)
    return frames, R_wb, t_wb, imu


def drive(tracker, frames, imu, depths=None):
    imu_iter = iter(imu)
    pending = next(imu_iter, None)
    for i in range(len(frames)):
        t = i * DT
        batch = []
        while pending is not None and pending[2] <= t + 1e-9:
            batch.append(pending)
            pending = next(imu_iter, None)
        tracker.push(frames[i], t, batch,
                     depth=None if depths is None else depths[i])
    tracker.block()


@pytest.mark.slow
class TestStreamingVI:
    def test_stereo_inertial_streaming(self, sequence):
        frames, R_wb, t_wb, imu = sequence
        cfg = streaming_vi.VIStreamConfig(
            img_w=W, img_h=H, n_cams=2, stereo_pairs=((0, 1),),
            orb=extractor.OrbConfig(n_features=256, n_levels=3),
            max_kf=16, max_mp=4096, traj_cap=64, imu_per_frame=16,
            ba_window=4, imu_init_kfs=5, kf_max_interval_s=0.25,
            temporal_refs=1, imu_freq=200.0)
        tracker = streaming_vi.StreamingVITracker(stereo_rig(), cfg,
                                                  seed=0)
        drive(tracker, frames, imu)

        assert tracker.imu_initialized, "staged IMU init never engaged"
        assert tracker.n_kf >= 3
        assert int(tracker.map.n_mp) > 150

        t_est, _, p_est = tracker.get_trajectory()
        ok = np.asarray(tracker.carry.traj.ok[:len(t_est)])
        assert ok.sum() >= len(frames) - 3
        t_gt = np.arange(len(frames)) * DT
        res = evaluation.ate_rmse(t_est[ok], p_est[ok], t_gt, t_wb,
                                  with_scale=True)
        # metric scale from the rig baseline: Horn scale ~ 1 and the
        # no-scale ATE small (trajectory ~7.5 m long)
        assert abs(res["scale"] - 1.0) < 0.06, res
        assert res["rmse_noscale"] < 0.35, res

    def test_depth_prior_streaming(self, sequence):
        """Multi-camera depth priors (reference: Frame.cc:1659-1765,
        1916-1922): a mono+depth+IMU rig must lock METRIC scale from the
        depth maps alone — before and independent of the inertial init —
        via depth-spawned landmarks at keyframe insertion."""
        frames, R_wb, t_wb, imu = sequence
        rig = RigParams(kind=cameras.PINHOLE,
                        params=jnp.asarray(PIN)[None],
                        R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))
        world = synthetic.BlobWorld.create(seed=3, n=3000)
        # depth maps live in the SAME camera frame as the images: the
        # fixture renders cam0 of the stereo rig (center -B/2 in body)
        c_b = np.array([-BASELINE / 2, 0, 0], np.float32)
        t_wc = t_wb + np.einsum("tij,j->ti", R_wb, c_b)
        depths = synthetic.render_depth_sequence(
            world, cameras.PINHOLE, PIN, R_wb, t_wc, W, H)
        depths = depths[:, None]              # [T, 1, H, W]
        cfg = streaming_vi.VIStreamConfig(
            img_w=W, img_h=H, n_cams=1, stereo_pairs=(),
            use_depth=True, depth_cap=192,
            orb=extractor.OrbConfig(n_features=256, n_levels=3),
            max_kf=16, max_mp=4096, traj_cap=64, imu_per_frame=16,
            ba_window=4, imu_init_kfs=5, kf_max_interval_s=0.25,
            temporal_refs=1, imu_freq=200.0)
        assert cfg.metric_scale       # depth priors => metric rig init
        tracker = streaming_vi.StreamingVITracker(rig, cfg, seed=0)
        drive(tracker, frames[:, :1], imu, depths=depths)

        assert int(tracker.map.n_mp) > 100
        t_est, _, p_est = tracker.get_trajectory()
        ok = np.asarray(tracker.carry.traj.ok[:len(t_est)])
        assert ok.sum() >= len(frames) - 3
        t_gt = np.arange(len(frames)) * DT
        res = evaluation.ate_rmse(t_est[ok], p_est[ok], t_gt, t_wb,
                                  with_scale=True)
        # metric scale from depth alone: Horn scale ~ 1 WITHOUT scale
        # correction, mono camera, before IMU init can contribute
        assert abs(res["scale"] - 1.0) < 0.06, res
        assert res["rmse_noscale"] < 0.35, res

    def test_mono_inertial_streaming(self, sequence):
        """IMU_MONOCULAR as a stream: two-view init at arbitrary scale,
        metric scale recovered by the in-step inertial init."""
        frames, R_wb, t_wb, imu = sequence
        rig = RigParams(kind=cameras.PINHOLE,
                        params=jnp.asarray(PIN)[None],
                        R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))
        cfg = streaming_vi.VIStreamConfig(
            img_w=W, img_h=H, n_cams=1, stereo_pairs=(),
            orb=extractor.OrbConfig(n_features=256, n_levels=3),
            max_kf=16, max_mp=4096, traj_cap=64, imu_per_frame=16,
            ba_window=4, imu_init_kfs=5, kf_max_interval_s=0.2,
            temporal_refs=1, imu_freq=200.0)
        assert not cfg.metric_scale
        # body frame == camera-0 frame for this rig; reuse cam-0 images
        mono_frames = frames[:, :1]
        tracker = streaming_vi.StreamingVITracker(rig, cfg, seed=0)
        drive(tracker, mono_frames, imu)

        assert tracker.imu_initialized
        t_est, _, p_est = tracker.get_trajectory()
        ok = np.asarray(tracker.carry.traj.ok[:len(t_est)])
        assert ok.sum() >= len(frames) - 4
        t_gt = np.arange(len(frames)) * DT
        res = evaluation.ate_rmse(t_est[ok], p_est[ok], t_gt, t_wb,
                                  with_scale=True)
        # scale recovered from the IMU (fix_scale=False init)
        assert abs(res["scale"] - 1.0) < 0.2, res
        assert res["rmse"] < 0.5, res


@pytest.mark.slow
def test_device_lc_closes_loop():
    """Device-side loop closing (pipeline/streaming_lc.py): a 1.25-orbit
    stereo-VI stream must detect the revisit and apply a correction with
    ZERO host syncs — lc_carry.n_loops advances and the trajectory stays
    accurate (reference cadence: LoopClosing::Run per keyframe,
    src/LoopClosing.cc:98)."""
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    n_frames = 100
    R_wb, t_wb = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=1.25)
    rig = stereo_rig()
    frames = []
    for c in range(2):
        R_bc = np.asarray(rig.R_cb[c]).T
        c_b = -np.asarray(rig.R_cb[c]).T @ np.asarray(rig.t_cb[c])
        frames.append(synthetic.render_sequence(
            world, cameras.PINHOLE, PIN, R_wb @ R_bc,
            t_wb + np.einsum("tij,j->ti", R_wb, c_b), W, H))
    frames = np.stack(frames, axis=1)
    imu = synthetic.imu_from_trajectory(R_wb, t_wb, DT, rate_mult=10)

    cfg = streaming_vi.VIStreamConfig(
        img_w=W, img_h=H, n_cams=2, stereo_pairs=((0, 1),),
        orb=extractor.OrbConfig(n_features=384, n_levels=3),
        max_kf=64, max_mp=8192, traj_cap=128, imu_per_frame=16,
        ba_window=4, imu_init_kfs=5, kf_max_interval_s=0.25,
        temporal_refs=1, imu_freq=200.0)
    # tilt_max: this deliberately DEGRADED stream (384 feats, 3 levels,
    # 200 Hz IMU, 16% scale error) accumulates 0.04-0.05 rad of real
    # gravity drift by loop time (measured via lc_max_tilt telemetry);
    # the flagship-validated default gate (0.02 — flagship/long benches
    # measure <= 0.005 tilt) correctly refuses such a hypothesis, so
    # this machinery test widens the gate to the drift it generates
    tracker = streaming_vi.StreamingVITracker(
        stereo_rig(), cfg, seed=0,
        device_lc=dict(score_min=30, temporal=2, tilt_max=0.08))
    drive(tracker, frames, imu)

    snap = tracker.snapshot()
    assert int(snap["n_loops"]) >= 1, "device LC never fired"
    t_est, _, p_est = tracker.get_trajectory()
    ok = snap["ok"][:len(t_est)]
    t_gt = np.arange(n_frames) * DT
    res = evaluation.ate_rmse(t_est[ok], p_est[ok], t_gt, t_wb,
                              with_scale=True)
    # 47 m path: the SAME stream without LC measures 2.65 m noscale ATE
    # (drift + 16% scale error); the verified correction must cut it
    # roughly in half. (Absolute bound, not a paired run, to keep the
    # test's runtime at one stream.)
    assert res["rmse_noscale"] < 1.8, res


KB8 = np.array([330.0, 330.0, W / 2, H / 2,
                -0.043, 0.003, -0.0037, 0.0008], np.float32)


def kb8_stereo_rig():
    """Hilti-like KannalaBrandt8 front stereo pair (reference rig:
    HiltiChallenge2022.yaml Camera1/Camera2 + Stereo.T_c1_c2)."""
    R_cb = jnp.stack([jnp.eye(3), jnp.eye(3)])
    t_cb = jnp.asarray([[BASELINE / 2, 0, 0], [-BASELINE / 2, 0, 0]],
                       dtype=jnp.float32)
    return RigParams(kind=cameras.KB8,
                     params=jnp.stack([jnp.asarray(KB8)] * 2),
                     R_cb=R_cb, t_cb=t_cb)


@pytest.mark.slow
def test_kb8_fisheye_stereo_vi():
    """The flagship pipeline on a KannalaBrandt8 FISHEYE rig with lapping
    areas (reference: the Hilti flagship is 4x KB8 fisheye —
    Frame::ComputeMultiFishEyeMatches src/Frame.cc:1461-1527,
    KannalaBrandt8::TriangulateMatches KannalaBrandt8.h:86-96).
    The KB8 projection/unprojection/Jacobian path must carry the full VI
    pipeline — rig init, tracking, staged IMU init — not just unit tests.
    """
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    n_frames = 40
    R_wb, t_wb = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=0.25)
    rig = kb8_stereo_rig()
    frames = []
    for c in range(2):
        R_bc = np.asarray(rig.R_cb[c]).T
        c_b = -np.asarray(rig.R_cb[c]).T @ np.asarray(rig.t_cb[c])
        frames.append(synthetic.render_sequence(
            world, cameras.KB8, KB8, R_wb @ R_bc,
            t_wb + np.einsum("tij,j->ti", R_wb, c_b), W, H))
    frames = np.stack(frames, axis=1)
    imu = synthetic.imu_from_trajectory(R_wb, t_wb, DT, rate_mult=10)

    cfg = streaming_vi.VIStreamConfig(
        img_w=W, img_h=H, n_cams=2, stereo_pairs=((0, 1),),
        # partial overlap: only the central lapping columns are stereo
        # candidates (mvLappingArea semantics)
        lapping=((W // 8, W - 1), (0, W - W // 8)),
        orb=extractor.OrbConfig(n_features=384, n_levels=3),
        max_kf=32, max_mp=8192, traj_cap=64, imu_per_frame=16,
        ba_window=4, imu_init_kfs=5, kf_max_interval_s=0.25,
        temporal_refs=1, imu_freq=200.0)
    tracker = streaming_vi.StreamingVITracker(rig, cfg, seed=0)
    drive(tracker, frames, imu)

    assert tracker.imu_initialized
    t_est, _, p_est = tracker.get_trajectory()
    ok = np.asarray(tracker.carry.traj.ok[:len(t_est)])
    assert ok.sum() >= n_frames - 5, int(ok.sum())
    t_gt = np.arange(n_frames) * DT
    res = evaluation.ate_rmse(t_est[ok], p_est[ok], t_gt, t_wb,
                              with_scale=True)
    # metric scale must come from the KB8-triangulated rig baseline
    assert abs(res["scale"] - 1.0) < 0.15, res
    assert res["rmse"] < 0.4, res


@pytest.mark.slow
def test_chunked_dispatch_matches_per_frame(sequence):
    """frames_per_dispatch>1 (lax.scan over a frame chunk, one dispatch)
    must reproduce the per-frame path — same keyframes, same trajectory
    (the scan body IS the per-frame step; only data movement changes)."""
    frames, R_wb, t_wb, imu = sequence
    base = dict(
        img_w=W, img_h=H, n_cams=2, stereo_pairs=((0, 1),),
        orb=extractor.OrbConfig(n_features=256, n_levels=3),
        max_kf=16, max_mp=4096, traj_cap=64, imu_per_frame=16,
        ba_window=4, imu_init_kfs=5, kf_max_interval_s=0.2,
        temporal_refs=1, imu_freq=200.0)
    tr1 = streaming_vi.StreamingVITracker(
        stereo_rig(), streaming_vi.VIStreamConfig(**base), seed=0)
    drive(tr1, frames, imu)
    # chunk=4 with 30 frames -> 7 full chunks + a masked partial flush
    trc = streaming_vi.StreamingVITracker(
        stereo_rig(),
        streaming_vi.VIStreamConfig(**base, frames_per_dispatch=4),
        seed=0)
    drive(trc, frames, imu)

    s1, sc = tr1.snapshot(), trc.snapshot()
    assert int(s1["n_kf"]) == int(sc["n_kf"])
    t1, _, p1 = tr1.get_trajectory()
    t2, _, p2 = trc.get_trajectory()
    assert len(t1) == len(t2)
    np.testing.assert_allclose(p1, p2, atol=5e-3)
