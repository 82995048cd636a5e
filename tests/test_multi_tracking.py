"""Multi-camera (+IMU) end-to-end tracking on a synthetic stereo rig.

The flagship-path analog of the reference's multi_inertial examples: metric
scale must come from the rig baseline (ATE is checked WITHOUT scale
alignment), and the staged IMU initialization must engage.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras, lie
from openmavis_jax.io import evaluation, synthetic
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.pipeline import multi_tracking

# heavyweight (compile-dominated) — excluded from the fast tier
pytestmark = __import__('pytest').mark.slow

W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
BASELINE = 0.2


def stereo_rig():
    """Two forward-looking pinhole cameras, 0.2 m apart."""
    R_cb = jnp.stack([jnp.eye(3), jnp.eye(3)])
    # camera centers in body frame: c0 at -b/2, c1 at +b/2 along x
    # t_cb = -R_cb @ c  (p_c = R_cb p_b + t_cb)
    t_cb = jnp.asarray([[BASELINE / 2, 0, 0], [-BASELINE / 2, 0, 0]],
                       dtype=jnp.float32)
    return RigParams(kind=cameras.PINHOLE,
                     params=jnp.stack([jnp.asarray(PIN)] * 2),
                     R_cb=R_cb, t_cb=t_cb)


@pytest.fixture(scope="module")
def sequence():
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    n_frames = 30
    R_wb, t_wb = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=0.2)
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
    dt = 1.0 / 20.0
    imu = synthetic.imu_from_trajectory(R_wb, t_wb, dt, rate_mult=10)
    return frames, R_wb, t_wb, imu, dt


class TestMultiE2E:
    def test_stereo_inertial_tracking(self, sequence):
        frames, R_wb, t_wb, imu, dt = sequence
        rig = stereo_rig()
        cfg = multi_tracking.MultiTrackerConfig(
            img_w=W, img_h=H, n_cams=2, stereo_pairs=((0, 1),),
            orb=extractor.OrbConfig(n_features=384, n_levels=4),
            max_kf=32, max_mp=8192, imu_freq=200.0, imu_init_kfs=6,
            kf_max_interval_s=0.25)
        tracker = multi_tracking.MultiTracker(rig, cfg, seed=0)

        imu_iter = iter(imu)
        pending = next(imu_iter, None)
        n_ok = 0
        for i in range(len(frames)):
            t = i * dt
            while pending is not None and pending[2] <= t + 1e-9:
                tracker.feed_imu(*pending)
                pending = next(imu_iter, None)
            ok = tracker.process_frame(jnp.asarray(frames[i]), time=t)
            n_ok += bool(ok)

        assert tracker.state == tracker.OK
        assert n_ok >= len(frames) - 2
        assert tracker.n_kf >= 3
        assert int(tracker.map.n_mp) > 200

        t_est, _, p_est = tracker.get_trajectory()
        t_gt = np.arange(len(frames)) * dt
        res = evaluation.ate_rmse(t_est, p_est, t_gt, t_wb,
                                  with_scale=True)
        # metric scale from the rig: the Horn scale must be ~1 and the
        # no-scale ATE must be small (trajectory ~7.5 m long)
        assert abs(res["scale"] - 1.0) < 0.05, res
        assert res["rmse_noscale"] < 0.30, res
        # IMU must have initialized given the cadence
        assert tracker.imu_initialized
