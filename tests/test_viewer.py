"""Headless viewer: map/frame rendering (reference: src/Viewer.cc,
MapDrawer.cc, FrameDrawer.cc rendered to PNG instead of GL)."""

import numpy as np
import jax.numpy as jnp

from openmavis_jax.pipeline import viewer
from openmavis_jax.slam_map import map_state as ms


def _toy_map():
    m = ms.allocate(4, 8, 32)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, (16, 3)).astype(np.float32)
    m = m._replace(
        mp_pos=m.mp_pos.at[:16].set(jnp.asarray(pts)),
        mp_valid=m.mp_valid.at[:16].set(True),
        kf_t=m.kf_t.at[:3].set(jnp.asarray([[0., 0, 0], [1, 0, 0.5],
                                            [2, 0, 1.0]])),
        kf_valid=m.kf_valid.at[:3].set(True),
        n_kf=jnp.asarray(3, jnp.int32), n_mp=jnp.asarray(16, jnp.int32))
    # shared observations so a covisibility edge exists
    obs = jnp.arange(8, dtype=jnp.int32)
    m = m._replace(
        kf_obs=m.kf_obs.at[0].set(obs).at[1].set(obs),
        kf_feat_valid=m.kf_feat_valid.at[:2].set(True))
    return m


def test_draw_map_renders_points_and_keyframes():
    img = viewer.draw_map(_toy_map(), viewer.MapView(width=200, height=160),
                          covis_threshold=4)
    assert img.shape == (160, 200, 3)
    flat = img.reshape(-1, 3)
    assert (flat == [0, 0, 0]).all(axis=1).any()       # map points
    assert (flat == [0, 0, 255]).all(axis=1).any()     # keyframes
    assert (flat == [0, 200, 0]).all(axis=1).any()     # covis edge


def test_draw_map_empty_is_blank():
    img = viewer.draw_map(ms.allocate(2, 4, 8))
    assert (img == 255).all()


def test_draw_frame_overlays_keypoints():
    g = np.zeros((40, 60), np.float32)
    xy = np.asarray([[10.0, 20.0], [50.0, 5.0], [200.0, 300.0]])
    tracked = np.asarray([True, True, False])
    img = viewer.draw_frame(g, xy, tracked)
    assert img.shape == (40, 60, 3)
    assert (img[20, 10] == [0, 255, 0]).all()
    assert (img[5, 50] == [0, 255, 0]).all()


def test_viewer_writes_pngs(tmp_path):
    v = viewer.Viewer(str(tmp_path), every=2,
                      view=viewer.MapView(width=64, height=64))
    m = _toy_map()
    g = np.zeros((16, 16), np.float32)
    xy = np.asarray([[4.0, 4.0]])
    for _ in range(4):
        v.update(m, img=g, xy=xy, tracked=np.asarray([True]),
                 trajectory=np.asarray(m.kf_t)[:3])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert "map_000000.png" in files and "map_000002.png" in files
    assert "frame_000000.png" in files
    assert "map_000001.png" not in files


def test_live_viewer_serves_map_and_state():
    """LiveViewer (src/Viewer.cc analog): HTTP server publishes the
    rasterized map + state; update() is a no-op with no client."""
    import json
    import urllib.request

    v = viewer.LiveViewer(port=0, view=viewer.MapView(width=64, height=64))
    try:
        # no client attached -> update renders nothing
        v.update(_toy_map())
        assert v.n_renders == 0
        # forced update publishes the stills + state
        v.update(_toy_map(), state={"n_keyframes": 3}, force=True)
        assert v.n_renders == 1
        page = urllib.request.urlopen(v.url, timeout=5).read()
        assert b"live viewer" in page
        png = urllib.request.urlopen(v.url + "map.png", timeout=5).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        st = json.loads(urllib.request.urlopen(
            v.url + "state.json", timeout=5).read())
        assert st["n_keyframes"] == 3
    finally:
        v.close()


def test_live_viewer_multipart_stream():
    """The /map endpoint is a multipart stream: an attached client makes
    `attached` true and receives each published frame as a PNG part."""
    import socket
    import threading
    import time as _time

    v = viewer.LiveViewer(port=0, view=viewer.MapView(width=64, height=64))
    try:
        host, port = v._srv.server_address[:2]
        sock = socket.create_connection((host, port), timeout=5)
        sock.sendall(b"GET /map HTTP/1.1\r\nHost: x\r\n\r\n")
        got = []

        def reader():
            sock.settimeout(10)
            buf = b""
            try:
                while b"\x89PNG" not in buf:
                    buf += sock.recv(65536)
            except OSError:
                pass
            got.append(buf)

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        # wait for the stream handler to register the client
        for _ in range(100):
            if v.attached:
                break
            _time.sleep(0.05)
        assert v.attached
        v.update(_toy_map())          # unforced: renders because attached
        assert v.n_renders == 1
        th.join(timeout=10)
        assert got and b"multipart/x-mixed-replace" in got[0]
        assert b"\x89PNG" in got[0]
        sock.close()
    finally:
        v.close()
