"""Relocalization: kidnap the tracker and verify PnP recovery."""

import numpy as np
import jax
import jax.numpy as jnp

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras
from openmavis_jax.io import synthetic
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.pipeline import tracking

# heavyweight (compile-dominated) — excluded from the fast tier
pytestmark = __import__('pytest').mark.slow

W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def test_kidnap_recovery():
    rig = RigParams(kind=cameras.PINHOLE, params=jnp.asarray(PIN)[None],
                    R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    R_wc, t_wc = synthetic.orbit_trajectory(30, radius=6.0, frac=0.2)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, PIN,
                                       R_wc, t_wc, W, H)
    cfg = tracking.TrackerConfig(
        img_w=W, img_h=H,
        orb=extractor.OrbConfig(n_features=512, n_levels=4),
        max_kf=32, max_mp=4096)
    tracker = tracking.Tracker(rig, cfg, seed=0)

    # run the first 20 frames normally
    for i in range(20):
        tracker.process_frame(jnp.asarray(frames[i]), time=i / 20.0)
    assert tracker.state == tracker.OK

    # kidnap: force LOST with a garbage pose, then feed a frame near the
    # middle of the mapped segment
    tracker.state = tracker.LOST
    tracker.R = jnp.eye(3)
    tracker.t = jnp.asarray([100.0, 100.0, 100.0])

    ok = tracker.process_frame(jnp.asarray(frames[10]), time=21 / 20.0)
    assert ok, "relocalization failed"
    assert tracker.state == tracker.OK
    # recovered pose should be near the frame-10 pose estimate recorded
    # earlier (tolerances loose: scale-free mono world, ~0.05 units)
    _, _, p_est = tracker.get_trajectory()
    d = np.linalg.norm(np.asarray(tracker.t) - p_est[10])
    assert d < 0.1, d
