"""Loop closing end-to-end: full-orbit revisit must be detected and the
trajectory corrected."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras
from openmavis_jax.io import evaluation, synthetic
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.pipeline import loop_closing, tracking
from openmavis_jax.slam_map import vocabulary

W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def mono_rig():
    return RigParams(kind=cameras.PINHOLE,
                     params=jnp.asarray(PIN)[None],
                     R_cb=jnp.eye(3)[None],
                     t_cb=jnp.zeros((1, 3)))


def _run_orbit(run_gba: bool):
    """Track 1.25 orbits (the revisit must persist over several keyframes
    so the temporal-consistency gate can confirm, reference:
    mnLoopNumCoincidences src/LoopClosing.cc:440-520)."""
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    n_frames = 100
    R_wc, t_wc = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=1.25)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, PIN,
                                       R_wc, t_wc, W, H)

    cfg = tracking.TrackerConfig(
        img_w=W, img_h=H,
        orb=extractor.OrbConfig(n_features=512, n_levels=4),
        max_kf=64, max_mp=8192,
        local_map_window=6)   # force real drift: no whole-map re-binding

    lc = loop_closing.LoopCloser(
        None, cfg.max_kf,
        loop_closing.LoopConfig(candidate_source="spatial",
                                spatial_radius=0.3, run_gba=run_gba),
        rig=mono_rig(), img_w=W, img_h=H)
    tracker = tracking.Tracker(mono_rig(), cfg, seed=0, loop_closer=lc)
    for i, img in enumerate(frames):
        tracker.process_frame(jnp.asarray(img), time=i / 20.0)

    assert tracker.state == tracker.OK
    assert lc.n_loops >= 1, "no loop detected on an orbit revisit"

    t_est, _, p_est = tracker.get_trajectory()
    t_gt = np.arange(n_frames) / 20.0
    res = evaluation.ate_rmse(t_est, p_est, t_gt, t_wc, with_scale=True)
    return res


@pytest.mark.slow
def test_full_orbit_loop_closes():
    res = _run_orbit(run_gba=True)
    # full 47 m path; with loop closure + post-loop GBA ATE stays small
    assert res["rmse"] < 0.8, res


@pytest.mark.slow
def test_post_loop_gba_tightens_map():
    """The automatic GBA after CorrectLoop (reference:
    RunGlobalBundleAdjustment, src/LoopClosing.cc:1372) must not degrade —
    and should typically improve — the pose-graph-only correction."""
    res_pg = _run_orbit(run_gba=False)
    res_gba = _run_orbit(run_gba=True)
    assert res_gba["rmse"] <= res_pg["rmse"] * 1.1 + 1e-3, (
        res_pg, res_gba)
