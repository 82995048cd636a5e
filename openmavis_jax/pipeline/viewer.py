"""Headless map/frame visualization (the Viewer thread analog).

JAX stand-in for the reference's Pangolin GL viewer (reference:
src/Viewer.cc:Run GL loop; src/MapDrawer.cc — map points, keyframe frusta,
covisibility graph; src/FrameDrawer.cc — tracked keypoints over the current
image). Headless deployments render the same content to PNG frames with a
small numpy rasterizer — no GL, no display, suitable for CI artifacts and
offline inspection; the per-frame state mirrors FrameDrawer::Update.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..slam_map import map_state as ms

# sRGB colors matching the reference viewer's palette
_BG = np.array([255, 255, 255], np.uint8)
_MP = np.array([0, 0, 0], np.uint8)          # map points: black
_MP_LOCAL = np.array([255, 0, 0], np.uint8)  # recent landmarks: red
_KF = np.array([0, 0, 255], np.uint8)        # keyframes: blue
_GRAPH = np.array([0, 200, 0], np.uint8)     # covisibility: green
_CUR = np.array([0, 180, 0], np.uint8)       # current camera: green
_FEAT = np.array([0, 255, 0], np.uint8)      # tracked keypoints


def _scatter(canvas, xy, color, size=1):
    H, W, _ = canvas.shape
    x = np.round(xy[:, 0]).astype(np.int64)
    y = np.round(xy[:, 1]).astype(np.int64)
    for dy in range(-size + 1, size):
        for dx in range(-size + 1, size):
            xi = np.clip(x + dx, 0, W - 1)
            yi = np.clip(y + dy, 0, H - 1)
            ok = (x + dx >= 0) & (x + dx < W) & (y + dy >= 0) & (y + dy < H)
            canvas[yi[ok], xi[ok]] = color
    return canvas


def _lines(canvas, p0, p1, color, n_samples=48):
    """Draw line segments by dense sampling (vectorized over segments)."""
    if len(p0) == 0:
        return canvas
    ts = np.linspace(0.0, 1.0, n_samples)[None, :, None]
    pts = p0[:, None, :] * (1 - ts) + p1[:, None, :] * ts
    return _scatter(canvas, pts.reshape(-1, 2), color)


@dataclass
class MapView:
    """Top-down (x-z by default) orthographic view of the map."""
    width: int = 800
    height: int = 800
    axes: tuple = (0, 2)      # world axes mapped to (right, down)
    margin: float = 0.1

    def _fit(self, pts):
        a, b = self.axes
        xy = np.stack([pts[:, a], pts[:, b]], axis=-1)
        lo = xy.min(axis=0)
        hi = xy.max(axis=0)
        span = np.maximum(hi - lo, 1e-6)
        pad = self.margin * span
        lo, hi = lo - pad, hi + pad
        scale = min((self.width - 1) / (hi[0] - lo[0]),
                    (self.height - 1) / (hi[1] - lo[1]))
        return lo, scale

    def _to_px(self, pts, lo, scale):
        a, b = self.axes
        xy = np.stack([pts[:, a], pts[:, b]], axis=-1)
        return (xy - lo) * scale


def draw_map(m: ms.MapState, view: MapView = MapView(),
             covis_threshold: int = 30, trajectory=None,
             recent_kf: int | None = None) -> np.ndarray:
    """Render the map to an RGB image (MapDrawer::DrawMapPoints +
    DrawKeyFrames + covisibility graph, reference: src/MapDrawer.cc).

    Args:
      trajectory: optional [T, 3] world positions drawn as a polyline.
      recent_kf: landmarks first seen at/after this KF drawn in red
        (the reference's 'reference map points' coloring).
    Returns [H, W, 3] uint8.
    """
    canvas = np.full((view.height, view.width, 3), _BG, np.uint8)
    mp_valid = np.asarray(m.mp_valid)
    kf_valid = np.asarray(m.kf_valid)
    pts = np.asarray(m.mp_pos)[mp_valid]
    kfs = np.asarray(m.kf_t)[kf_valid]
    anchors = [p for p in (pts, kfs) if len(p)]
    if trajectory is not None and len(trajectory):
        anchors.append(np.asarray(trajectory))
    if not anchors:
        return canvas
    lo, scale = view._fit(np.concatenate(anchors, axis=0))

    if len(pts):
        if recent_kf is not None:
            first = np.asarray(m.mp_first_kf)[mp_valid]
            old = first < recent_kf
            canvas = _scatter(canvas, view._to_px(pts[old], lo, scale), _MP)
            canvas = _scatter(canvas, view._to_px(pts[~old], lo, scale),
                              _MP_LOCAL)
        else:
            canvas = _scatter(canvas, view._to_px(pts, lo, scale), _MP)

    # covisibility graph edges (green) between keyframe centers
    if len(kfs) >= 2:
        cov = np.asarray(ms.covisibility_matrix(m))
        ids = np.nonzero(kf_valid)[0]
        sub = cov[np.ix_(ids, ids)]
        ii, jj = np.nonzero(np.triu(sub, 1) >= covis_threshold)
        if len(ii):
            p_all = np.asarray(m.kf_t)[ids]
            canvas = _lines(canvas, view._to_px(p_all[ii], lo, scale),
                            view._to_px(p_all[jj], lo, scale), _GRAPH)

    if trajectory is not None and len(trajectory) >= 2:
        tr = np.asarray(trajectory)
        canvas = _lines(canvas, view._to_px(tr[:-1], lo, scale),
                        view._to_px(tr[1:], lo, scale), _CUR)

    if len(kfs):
        canvas = _scatter(canvas, view._to_px(kfs, lo, scale), _KF, size=2)
    return canvas


def draw_frame(img: np.ndarray, xy: np.ndarray, tracked: np.ndarray,
               state_text: str = "") -> np.ndarray:
    """Overlay tracked keypoints on a grayscale frame
    (FrameDrawer::DrawFrame, reference: src/FrameDrawer.cc — tracked
    points as green squares). Returns [H, W, 3] uint8."""
    g = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    canvas = np.stack([g, g, g], axis=-1)
    sel = np.asarray(tracked)
    pts = np.asarray(xy)[sel]
    if len(pts):
        canvas = _scatter(canvas, pts, _FEAT, size=2)
    return canvas


def save_png(path: str, arr: np.ndarray):
    from PIL import Image
    Image.fromarray(arr).save(path)


class Viewer:
    """Offline viewer: renders map + frame PNGs per update.

    The reference's Viewer thread polls shared state at ~30 Hz
    (src/Viewer.cc:Run); here every `every` keyframes one snapshot is
    rendered to `out_dir` — a pull becomes a push, no thread."""

    def __init__(self, out_dir: str, every: int = 1,
                 view: MapView = MapView()):
        self.out_dir = out_dir
        self.every = every
        self.view = view
        self.n_updates = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, m: ms.MapState, img=None, xy=None, tracked=None,
               trajectory=None):
        i = self.n_updates
        self.n_updates += 1
        if i % self.every:
            return
        save_png(os.path.join(self.out_dir, f"map_{i:06d}.png"),
                 draw_map(m, self.view, trajectory=trajectory))
        if img is not None and xy is not None:
            save_png(os.path.join(self.out_dir, f"frame_{i:06d}.png"),
                     draw_frame(img, xy, tracked))


_PAGE = b"""<!doctype html><html><head><title>OpenMAVIS-JAX viewer</title>
<style>body{background:#111;color:#ddd;font:13px monospace;margin:12px}
img{border:1px solid #444;margin:4px;max-width:46vw}
#state{white-space:pre;color:#9c9}</style></head><body>
<h3>OpenMAVIS-JAX live viewer</h3>
<div><img src="/map" alt="map"><img src="/frame" alt="frame"></div>
<div id="state"></div>
<script>setInterval(async()=>{try{const r=await fetch('/state.json');
document.getElementById('state').textContent=
JSON.stringify(await r.json(),null,1);}catch(e){}},500);</script>
</body></html>"""


class LiveViewer:
    """Interactive live viewer: an in-process HTTP server streaming the
    map/frame renders to a browser.

    JAX replacement for the reference's interactive Pangolin
    viewer (src/Viewer.cc:Run — a GL loop polling shared tracker state
    at ~30 Hz; src/MapDrawer.cc / src/FrameDrawer.cc draw calls). Here
    the same content is rasterized by `draw_map`/`draw_frame` and pushed
    over HTTP: `/` serves a page with two multipart (MJPEG-style) image
    streams plus a state ticker, `/map.png` + `/frame.png` serve the
    latest stills, `/state.json` the tracker counters.

    Zero-overhead when idle: `update()` renders only while at least one
    HTTP client is connected (the reference pays its GL loop always;
    a SLAM process on an accelerator must not pay rasterize + d2h for an
    unattached viewer).
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 view: MapView = MapView(), every: int = 1):
        import http.server
        import threading

        self.view = view
        self.every = every
        self.n_updates = 0
        self.n_renders = 0
        self._lock = threading.Condition()
        self._gen = 0                       # bumped per rendered update
        self._png = {}                      # name -> latest PNG bytes
        self._state = {}
        self._clients = 0
        owner = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):      # silence per-request stderr
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                import json as _json
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html", _PAGE)
                elif self.path == "/state.json":
                    with owner._lock:
                        body = _json.dumps(owner._state).encode()
                    self._send(200, "application/json", body)
                elif self.path in ("/map.png", "/frame.png"):
                    with owner._lock:
                        body = owner._png.get(self.path[1:-4])
                    if body is None:
                        self._send(404, "text/plain", b"no render yet")
                    else:
                        self._send(200, "image/png", body)
                elif self.path in ("/map", "/frame"):
                    self._stream(self.path[1:])
                else:
                    self._send(404, "text/plain", b"not found")

            def _stream(self, name):
                # multipart/x-mixed-replace: the browser replaces the
                # <img> with each part as it arrives (the MJPEG idiom,
                # PNG-encoded parts)
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=omv")
                self.end_headers()
                with owner._lock:
                    owner._clients += 1
                try:
                    last = -1
                    while True:
                        with owner._lock:
                            if owner._gen == last:
                                if not owner._lock.wait(timeout=5.0):
                                    continue
                            last = owner._gen
                            body = owner._png.get(name)
                        if body is None:
                            continue
                        self.wfile.write(
                            b"--omv\r\nContent-Type: image/png\r\n"
                            + b"Content-Length: %d\r\n\r\n" % len(body)
                            + body + b"\r\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    with owner._lock:
                        owner._clients -= 1

        self._srv = http.server.ThreadingHTTPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.url = "http://%s:%d/" % self._srv.server_address[:2]

    @property
    def attached(self) -> bool:
        with self._lock:
            return self._clients > 0

    def update(self, m: ms.MapState, img=None, xy=None, tracked=None,
               trajectory=None, state: dict | None = None,
               force: bool = False):
        """Render + publish one snapshot. No-op (beyond a counter)
        unless a stream client is attached or `force` is given."""
        i = self.n_updates
        self.n_updates += 1
        if i % self.every:
            return
        if not (force or self.attached):
            return
        frames = {"map": draw_map(m, self.view, trajectory=trajectory)}
        if img is not None and xy is not None:
            frames["frame"] = draw_frame(img, xy, tracked)
        pngs = {k: _encode_png(v) for k, v in frames.items()}
        with self._lock:
            self._png.update(pngs)
            if state is not None:
                self._state = dict(state)
            self._gen += 1
            self.n_renders += 1
            self._lock.notify_all()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5.0)


def _encode_png(arr: np.ndarray) -> bytes:
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()
