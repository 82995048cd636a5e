"""System facade test: settings -> full pipeline -> trajectory files."""

import numpy as np
import jax.numpy as jnp

from openmavis_jax.io import settings as settings_mod
from openmavis_jax.io import synthetic, trajectory
from openmavis_jax.geometry import cameras
from openmavis_jax.pipeline.system import Sensor, System

# heavyweight (compile-dominated) — excluded from the fast tier
pytestmark = __import__('pytest').mark.slow

W, H = 384, 288


def make_config():
    cfg = settings_mod.example_settings(n_cams=1)
    cfg["Camera"]["width"] = W
    cfg["Camera"]["height"] = H
    cfg["Camera1"].update(fx=300.0, fy=300.0, cx=W / 2, cy=H / 2)
    cfg["ORBextractor"]["nFeatures"] = 384
    cfg["ORBextractor"]["nLevels"] = 4
    return cfg


def test_system_mono_end_to_end(tmp_path):
    cfg = make_config()
    slam = System(cfg, Sensor.MONOCULAR, enable_loop_closing=False,
                  tracker_overrides={"max_kf": 16, "max_mp": 4096},
                  use_viewer=True)

    world = synthetic.BlobWorld.create(seed=5, n=2500)
    params = np.array([300.0, 300.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    R_wc, t_wc = synthetic.orbit_trajectory(20, radius=6.0, frac=0.12)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, params,
                                       R_wc, t_wc, W, H)
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 20.0)
    assert slam.tracking_state() == slam.tracker.OK

    traj_path = str(tmp_path / "traj_tum.txt")
    slam.save_trajectory_tum(traj_path)
    times, pos, _ = trajectory.load_tum(traj_path)
    assert len(times) == len(frames)

    kf_path = str(tmp_path / "kf_tum.txt")
    slam.save_keyframe_trajectory_tum(kf_path)
    times_kf, _, _ = trajectory.load_tum(kf_path)
    assert len(times_kf) == slam.tracker.n_kf

    atlas_path = str(tmp_path / "atlas.npz")
    slam.save_atlas(atlas_path)
    n_mp = int(slam.map.n_mp)
    slam.load_atlas(atlas_path)
    assert int(slam.map.n_mp) == n_mp

    stats = slam.timer.stats()
    assert "track" in stats and stats["track"]["count"] == len(frames)

    # live viewer (System ctor bUseViewer analog, src/System.cc:79):
    # no client was attached during the run -> zero renders paid; an
    # attached stream client makes the next track publish a snapshot
    import json
    import socket
    import time as _time
    import urllib.request
    v = slam.viewer
    assert v is not None and v.n_renders == 0
    host, port = v._srv.server_address[:2]
    sock = socket.create_connection((host, port), timeout=5)
    sock.sendall(b"GET /map HTTP/1.1\r\nHost: x\r\n\r\n")
    for _ in range(100):
        if v.attached:
            break
        _time.sleep(0.05)
    assert v.attached
    slam.track_monocular(frames[-1], len(frames) / 20.0)
    assert v.n_renders == 1
    st = json.loads(urllib.request.urlopen(
        v.url + "state.json", timeout=5).read())
    assert st["n_keyframes"] == slam.tracker.n_kf
    sock.close()
    slam.shutdown()
    assert slam.viewer is None
