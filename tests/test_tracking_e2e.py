"""End-to-end monocular tracking on a synthetic rendered sequence.

The hermetic analog of the reference's dataset-replay integration tests
(SURVEY.md §4): render a blob world along a known trajectory, run the full
pipeline (extract -> init -> track -> keyframes -> local BA), and check ATE
after Horn alignment with scale (monocular gauge freedom).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras
from openmavis_jax.io import evaluation, synthetic
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.pipeline import tracking

# heavyweight (compile-dominated) — excluded from the fast tier
pytestmark = __import__('pytest').mark.slow

W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def mono_rig():
    return RigParams(kind=cameras.PINHOLE,
                     params=jnp.asarray(PIN)[None],
                     R_cb=jnp.eye(3)[None],
                     t_cb=jnp.zeros((1, 3)))


@pytest.fixture(scope="module")
def sequence():
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    R_wc, t_wc = synthetic.orbit_trajectory(40, radius=6.0, frac=0.25)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, PIN,
                                       R_wc, t_wc, W, H)
    return frames, R_wc, t_wc


class TestMonoE2E:
    def test_tracks_sequence(self, sequence):
        frames, R_wc, t_wc = sequence
        cfg = tracking.TrackerConfig(
            img_w=W, img_h=H,
            orb=extractor.OrbConfig(n_features=512, n_levels=4),
            max_kf=32, max_mp=4096)
        tracker = tracking.Tracker(mono_rig(), cfg, seed=0)

        n_ok = 0
        for i, img in enumerate(frames):
            ok = tracker.process_frame(jnp.asarray(img), time=i / 20.0)
            n_ok += bool(ok)
        assert tracker.state == tracker.OK, tracker.state
        assert n_ok > 30, n_ok
        assert tracker.n_kf >= 2
        assert int(tracker.map.n_mp) > 100

        t_est, _, p_est = tracker.get_trajectory()
        t_gt = np.arange(len(frames)) / 20.0
        res = evaluation.ate_rmse(t_est, p_est, t_gt, t_wc,
                                  with_scale=True)
        # trajectory length ~4 m; require ATE under 5% of it
        assert res["rmse"] < 0.20, res


@pytest.mark.slow
def test_mono_tracking_under_photometric_degradation():
    """Tracking must survive realistic camera artifacts: per-pixel noise,
    exposure drift, vignetting (synthetic.degrade). The clean-render ATE
    budget is relaxed 2x — robustness, not precision, is under test."""
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    n_frames = 40
    R_wc, t_wc = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=0.2)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, PIN,
                                       R_wc, t_wc, W, H)
    frames = synthetic.degrade(frames, noise_sigma=4.0,
                               exposure_drift=0.2, vignette=0.35)

    cfg = tracking.TrackerConfig(
        img_w=W, img_h=H,
        orb=extractor.OrbConfig(n_features=512, n_levels=4),
        max_kf=32, max_mp=4096)
    tracker = tracking.Tracker(mono_rig(), cfg, seed=0)
    n_ok = 0
    for i, img in enumerate(frames):
        n_ok += bool(tracker.process_frame(jnp.asarray(img),
                                           time=i / 20.0))
    assert tracker.state == tracker.OK
    assert n_ok > n_frames - 8, n_ok
    t_est, _, p_est = tracker.get_trajectory()
    t_gt = np.arange(n_frames) / 20.0
    res = evaluation.ate_rmse(t_est, p_est, t_gt, t_wc, with_scale=True)
    assert res["rmse"] < 0.40, res
