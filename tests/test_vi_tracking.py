"""Visual-inertial tracking end-to-end: mono-inertial scale recovery and
IMU-carried tracking through a visual blackout.

Covers the reference behaviors:
* IMU_MONOCULAR (Examples/Monocular-Inertial/mono_inertial_tum_vi.cc) —
  two-view init at arbitrary scale, then InertialOptimization with
  fix_scale=False recovers metric scale + gravity;
* RECENTLY_LOST IMU coast (src/Tracking.cc:1929-1940) — when the camera
  blacks out, the preintegrated IMU keeps the pose usable and tracking
  re-enters when features return;
* PoseInertialOptimizationLastFrame in the per-frame loop
  (src/Optimizer.cc:5580).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras
from openmavis_jax.io import evaluation, synthetic
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.pipeline import multi_tracking, system

W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
DT = 1.0 / 20.0

BG_TRUE = np.array([0.008, -0.005, 0.01], np.float32)


def mono_rig():
    return RigParams(kind=cameras.PINHOLE,
                     params=jnp.asarray(PIN)[None],
                     R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))


@pytest.fixture(scope="module")
def mono_sequence():
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    n_frames = 40
    R_wb, t_wb = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=0.25)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, PIN,
                                       R_wb, t_wb, W, H)
    imu = synthetic.imu_from_trajectory(R_wb, t_wb, DT, rate_mult=10)
    # inject a constant gyro bias the init must recover
    imu = [(w + BG_TRUE, a, t) for (w, a, t) in imu]
    return np.stack(frames), R_wb, t_wb, imu


def drive(tracker_feed, frames, imu, process):
    imu_iter = iter(imu)
    pending = next(imu_iter, None)
    oks = []
    for i in range(len(frames)):
        t = i * DT
        while pending is not None and pending[2] <= t + 1e-9:
            tracker_feed(*pending)
            pending = next(imu_iter, None)
        oks.append(bool(process(i, t)))
    return oks


class TestMonoInertial:
    def test_scale_and_bias_recovery(self):
        # longer sequence than the shared fixture: mono-inertial scale
        # needs ~3 s of excitation to converge (at 2 s the estimate sits
        # at 1.15-1.25 and the test is seed-chaotic; the reference's own
        # mono-inertial runs refine scale through VIBA over seconds)
        n_frames = 64
        world = synthetic.BlobWorld.create(seed=3, n=3000)
        R_wb, t_wb = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                                frac=0.4)
        frames = np.stack(synthetic.render_sequence(
            world, cameras.PINHOLE, PIN, R_wb, t_wb, W, H))
        imu = synthetic.imu_from_trajectory(R_wb, t_wb, DT,
                                            rate_mult=10)
        imu = [(w + BG_TRUE, a, t) for (w, a, t) in imu]
        rig = mono_rig()
        cfg = multi_tracking.MultiTrackerConfig(
            img_w=W, img_h=H, n_cams=1, stereo_pairs=(),
            orb=extractor.OrbConfig(n_features=384, n_levels=4),
            max_kf=32, max_mp=8192, imu_freq=200.0, imu_init_kfs=6,
            kf_max_interval_s=0.2, min_inliers_track=20,
            kf_min_inliers_abs=60)
        assert not cfg.metric_scale
        tracker = multi_tracking.MultiTracker(rig, cfg, seed=0)

        oks = drive(tracker.feed_imu, frames, imu,
                    lambda i, t: tracker.process_frame(
                        jnp.asarray(frames[i])[None], t))
        assert sum(oks) >= len(frames) - 3
        assert tracker.imu_initialized, "IMU init never engaged"
        assert tracker.viba_stage >= 1

        # metric scale recovered: Horn scale vs ground truth ~ 1
        t_est, _, p_est = tracker.get_trajectory()
        t_gt = np.arange(len(frames)) * DT
        res = evaluation.ate_rmse(t_est, p_est, t_gt, t_wb,
                                  with_scale=True)
        assert abs(res["scale"] - 1.0) < 0.15, res
        assert res["rmse"] < 0.6, res     # ~15 m path
        # injected gyro bias recovered
        bg_est = np.asarray(tracker.bias[:3])
        assert np.linalg.norm(bg_est - BG_TRUE) < 0.5 * np.linalg.norm(
            BG_TRUE) + 2e-3, bg_est

    def test_system_facade_imu_monocular(self, mono_sequence):
        """System(cfg, Sensor.IMU_MONOCULAR) end-to-end entry point."""
        from openmavis_jax.io import settings as settings_mod
        frames, R_wb, t_wb, imu = mono_sequence
        cfg = settings_mod.example_settings(n_cams=1)
        cfg["Camera"]["width"] = W
        cfg["Camera"]["height"] = H
        cfg["Camera1"].update(fx=380.0, fy=380.0, cx=W / 2, cy=H / 2)
        cfg["ORBextractor"]["nFeatures"] = 384
        cfg["ORBextractor"]["nLevels"] = 4
        slam = system.System(
            cfg, system.Sensor.IMU_MONOCULAR, enable_loop_closing=False,
            tracker_overrides=dict(max_kf=32, max_mp=8192,
                                   imu_init_kfs=6,
                                   kf_max_interval_s=0.2))
        imu_iter = iter(imu)
        pending = next(imu_iter, None)
        n_ok = 0
        for i in range(24):
            t = i * DT
            batch = []
            while pending is not None and pending[2] <= t + 1e-9:
                batch.append(pending)
                pending = next(imu_iter, None)
            n_ok += bool(slam.track_monocular(frames[i], t,
                                              imu_samples=batch))
        assert n_ok >= 20
        assert slam.tracker.imu_initialized
        # FullInertialBA path of run_global_ba (reference: the GBA thread
        # runs FullInertialBA on inertial maps, src/LoopClosing.cc:
        # 2366-2368): must converge and keep the trajectory finite
        chi = slam.run_global_ba()
        assert np.isfinite(chi)
        _, _, p_est = slam.tracker.get_trajectory()
        assert np.isfinite(p_est).all()


class TestBlackoutCoast:
    def test_imu_carries_through_blackout(self, mono_sequence):
        """After IMU init, black frames (zero features) must not corrupt
        the pose: the tracker coasts on the preintegrated prediction and
        re-enters when the scene returns."""
        frames, R_wb, t_wb, imu = mono_sequence
        rig = mono_rig()
        cfg = multi_tracking.MultiTrackerConfig(
            img_w=W, img_h=H, n_cams=1, stereo_pairs=(),
            orb=extractor.OrbConfig(n_features=384, n_levels=4),
            max_kf=32, max_mp=8192, imu_freq=200.0, imu_init_kfs=6,
            kf_max_interval_s=0.2, min_inliers_track=20,
            kf_min_inliers_abs=60, max_lost_frames=50)
        tracker = multi_tracking.MultiTracker(rig, cfg, seed=0)
        black = np.zeros_like(frames[0])

        def proc(i, t):
            img = black if (tracker.imu_initialized
                            and 26 <= i < 30) else frames[i]
            return tracker.process_frame(jnp.asarray(img)[None], t)

        oks = drive(tracker.feed_imu, frames, imu, proc)
        assert tracker.imu_initialized
        # blackout frames fail visually...
        assert not any(oks[27:30])
        # ...but tracking re-enters afterwards within two frames
        assert any(oks[30:33]), oks[30:]
        assert tracker.state == tracker.OK
        t_est, _, p_est = tracker.get_trajectory()
        res = evaluation.ate_rmse(
            t_est, p_est, np.arange(len(frames)) * DT, t_wb,
            with_scale=True)
        assert res["rmse"] < 0.6, res
