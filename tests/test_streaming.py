"""Streaming (zero-fetch) tracker: parity with the host-policy tracker.

The streaming tracker runs the whole state machine on device
(pipeline/streaming.py); these tests check it initializes, tracks, inserts
keyframes and produces a trajectory of the same quality as
tracking.Tracker on the same synthetic sequence.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras
from openmavis_jax.io import evaluation, synthetic
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.pipeline import streaming

W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def _rig():
    return RigParams(kind=cameras.PINHOLE, params=jnp.asarray(PIN)[None],
                     R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))


@pytest.mark.slow
def test_streaming_tracker_e2e():
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    n_frames = 24
    R_wc, t_wc = synthetic.orbit_trajectory(n_frames, radius=6.0, frac=0.15)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, PIN,
                                       R_wc, t_wc, W, H)
    cfg = streaming.StreamConfig(
        img_w=W, img_h=H,
        orb=extractor.OrbConfig(n_features=512, n_levels=4),
        max_kf=16, max_mp=4096, traj_cap=64)
    tr = streaming.StreamingTracker(_rig(), cfg, seed=0)
    for i, f in enumerate(frames):
        tr.push(jnp.asarray(f), i / 20.0)
    tr.block()

    assert tr.n_kf >= 3
    times, R_est, p_est = tr.get_trajectory()
    assert len(times) == n_frames
    ok = np.asarray(tr.carry.traj.ok[:n_frames])
    assert ok[3:].mean() > 0.8, f"tracked frac {ok.mean()}"

    res = evaluation.ate_rmse(times, p_est, np.arange(n_frames) / 20.0,
                              t_wc)
    # mono: scale-corrected ATE
    assert res["rmse"] < 0.15, res


def test_record_ring_overflow():
    """Ring must clamp writes at capacity without error."""
    from openmavis_jax.slam_map import map_state as ms
    cfg = streaming.StreamConfig(img_w=64, img_h=64,
                                 orb=extractor.OrbConfig(
                                     n_features=64, n_levels=2),
                                 max_kf=4, max_mp=128, traj_cap=4)
    c = streaming.init_carry(64, cfg.traj_cap, 0)
    m = ms.allocate(4, 64, 128)
    for k in range(6):
        c = streaming._record(m, c, float(k), jnp.asarray(True))
    assert int(c.traj.idx) == 6
    # last slot holds the final write
    assert float(c.traj.time[3]) == 5.0
