"""Synthetic world renderer for end-to-end tests and benchmarks.

Renders a "blob world" — random 3D points splatted as Gaussian sprites with
per-point intensity patterns — through any camera model of the framework.
This provides deterministic sequences with exact ground truth, standing in
for dataset replay in environments without EuRoC/TUM-VI data (SURVEY.md §4:
the reference's integration tests are dataset replays; this is the hermetic
equivalent).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np



def _np_project(kind: int, params: np.ndarray, p: np.ndarray,
                dist=None) -> np.ndarray:
    """Pure-numpy camera projection mirroring geometry.cameras.project.

    `dist` (pinhole only): radtan (k1, k2, p1, p2) applied before K —
    renders RAW distorted images for the rectification path (reference:
    the distorted EuRoC inputs consumed through
    Settings::precomputeRectificationMaps, src/Settings.cc:683).

    The renderer stays on the host (numpy): sequence generation is set-up,
    and keeping it off the device keeps it out of device timings.
    """
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    if kind == 0:      # PINHOLE
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        xn, yn = x / zs, y / zs
        if dist is not None and np.any(np.asarray(dist)):
            k1, k2, p1, p2 = np.asarray(dist, np.float64)[:4]
            r2 = xn * xn + yn * yn
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
            yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
            xn, yn = xd, yd
        return np.stack([fx * xn + cx, fy * yn + cy], axis=-1)
    # KB8 equidistant fisheye
    k = params[4:8]
    r = np.sqrt(np.maximum(x * x + y * y, 1e-18))
    theta = np.arctan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1 + k[0] * t2 + k[1] * t2 ** 2
                       + k[2] * t2 ** 3 + k[3] * t2 ** 4)
    s = np.where(r < 1e-9, 1.0 / np.where(np.abs(z) < 1e-9, 1e-9, z),
                 theta_d / r)
    return np.stack([fx * s * x + cx, fy * s * y + cy], axis=-1)


@dataclass
class BlobWorld:
    points: np.ndarray       # [N, 3]
    intensity: np.ndarray    # [N]
    size: np.ndarray         # [N] sprite radius scale

    @staticmethod
    def create(seed: int = 0, n: int = 4000,
               box=((-12, 12), (-8, 8), (-4, 18)), cluster: int = 5):
        """Clustered points: each cluster is a distinctive local
        constellation, giving descriptors something to latch onto (isolated
        identical blobs are deliberately ambiguous)."""
        rng = np.random.default_rng(seed)
        n_c = max(n // cluster, 1)
        centers = np.stack([rng.uniform(lo, hi, n_c) for lo, hi in box],
                           axis=-1)
        pts = (centers[:, None, :]
               + rng.normal(0, 0.25, (n_c, cluster, 3))).reshape(-1, 3)[:n]
        inten = rng.uniform(60.0, 255.0, len(pts))
        size = rng.uniform(0.8, 2.2, len(pts))
        return BlobWorld(pts.astype(np.float32), inten.astype(np.float32),
                         size.astype(np.float32))


def render(world: BlobWorld, kind: int, params: np.ndarray,
           R_cw: np.ndarray, t_cw: np.ndarray, w: int, h: int,
           base: float = 30.0, with_depth: bool = False, dist=None):
    """Render one camera view: [h, w] float32 image.

    R_cw, t_cw: camera-from-world (p_c = R_cw p_w + t_cw).
    With `with_depth`, also returns a [h, w] z-depth map (0 = no surface)
    for RGB-D pipeline tests.
    Pure numpy (host-side data generation; not a perf path).
    """
    p_c = world.points @ R_cw.T + t_cw
    in_front = p_c[:, 2] > 0.3
    p_c = p_c[in_front]
    inten = world.intensity[in_front]
    size = world.size[in_front]

    uv = _np_project(kind, np.asarray(params, np.float64),
                     p_c.astype(np.float64), dist=dist).astype(np.float32)
    # sprite radius shrinks with depth
    rad = np.clip(size * 400.0 / (p_c[:, 2] * 100.0), 1.0, 4.0)

    img = np.full((h, w), base, np.float32)
    R = 4
    ok = ((uv[:, 0] > R + 1) & (uv[:, 0] < w - R - 2)
          & (uv[:, 1] > R + 1) & (uv[:, 1] < h - R - 2))
    uv, inten, rad = uv[ok], inten[ok], rad[ok]
    z = p_c[ok, 2]
    xi = np.round(uv[:, 0]).astype(int)
    yi = np.round(uv[:, 1]).astype(int)
    fy, fx = np.mgrid[-R:R + 1, -R:R + 1]
    # vectorized splat: per-blob subpixel Gaussian patches [K, 9, 9]
    # scatter-added into the image (semantically identical to the
    # per-blob loop, ~100x faster for the 4-cam benchmark sequences)
    dx = (uv[:, 0] - xi)[:, None, None]
    dy = (uv[:, 1] - yi)[:, None, None]
    g = np.exp(-(((fx[None] - dx) ** 2 + (fy[None] - dy) ** 2)
                 / (2 * (rad[:, None, None] * 0.6) ** 2)))
    Y = yi[:, None, None] + fy[None]
    X = xi[:, None, None] + fx[None]
    np.add.at(img, (Y, X), inten[:, None, None] * g.astype(np.float32))
    if with_depth:
        # depth at each pixel = min z over blobs whose gaussian hits it
        dmap = np.full((h, w), np.inf, np.float32)
        zval = np.where(g > 0.05, z[:, None, None],
                        np.inf).astype(np.float32)
        np.minimum.at(dmap, (Y, X), zval)
        dmap[~np.isfinite(dmap)] = 0.0
    else:
        dmap = None
    img = np.clip(img, 0, 255)
    return (img, dmap) if with_depth else img


def degrade(frames: np.ndarray, noise_sigma: float = 3.0,
            exposure_drift: float = 0.15, vignette: float = 0.3,
            seed: int = 0) -> np.ndarray:
    """Photometric degradation for realism tests: per-pixel Gaussian noise,
    slow exposure drift across the sequence, and radial vignetting —
    the camera artifacts real EuRoC/TUM-VI footage carries that the clean
    renderer lacks. frames: [T, H, W] or [T, C, H, W].
    """
    rng = np.random.RandomState(seed)
    out = frames.astype(np.float32)
    tdim = out.shape[0]
    h, w = out.shape[-2:]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = (((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2)
    vig = 1.0 - vignette * np.clip(r2, 0, 1)
    gain = 1.0 + exposure_drift * np.sin(
        np.linspace(0, 2 * np.pi, tdim, dtype=np.float32))
    shape = (tdim,) + (1,) * (out.ndim - 1)
    out = out * gain.reshape(shape) * vig
    out = out + rng.normal(0, noise_sigma, out.shape).astype(np.float32)
    return np.clip(out, 0, 255)


def orbit_trajectory(n_frames: int, radius: float = 6.0,
                     frac: float = 0.35, height: float = 0.0,
                     start: float = 0.0):
    """Camera orbit segment looking at the world center.

    `start` offsets the segment along the orbit (fraction of a full turn)
    — overlapping segments make multi-session merge scenarios.
    Returns (R_wc [T,3,3], t_wc [T,3]) world-from-camera poses.
    """
    Rs, ts = [], []
    for i in range(n_frames):
        ang = 2 * np.pi * (start + frac * i / max(n_frames - 1, 1))
        c = np.array([radius * np.sin(ang), height,
                      7.0 - radius * np.cos(ang)], np.float32)
        # look at world center (0, 0, 7)
        fwd = np.array([0, 0, 7.0], np.float32) - c
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0, -1, 0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R_wc = np.stack([right, -up2, fwd], axis=1)  # cols: x,y,z of cam
        Rs.append(R_wc.astype(np.float32))
        ts.append(c)
    return np.stack(Rs), np.stack(ts)



def _np_so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues (host-side; see _np_project note on device purity)."""
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                 np.float64)
    if th < 1e-8:
        return (np.eye(3) + K).astype(np.float32)
    A = np.sin(th) / th
    B = (1 - np.cos(th)) / th ** 2
    return (np.eye(3) + A * K + B * (K @ K)).astype(np.float32)


def _np_so3_log(R: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = np.arccos(tr)
    if th < 1e-8:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]], np.float64) / 2
    return th / (2 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]],
        np.float64)


def forward_trajectory(n_frames: int, step: float = 0.12,
                       yaw_rate: float = 0.004):
    """Mostly-forward motion with gentle yaw (EuRoC-ish)."""
    Rs, ts = [], []
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    for i in range(n_frames):
        Rs.append(R.copy())
        ts.append(t.copy())
        R = R @ _np_so3_exp(np.array([0.0, yaw_rate, 0.0]))
        t = t + R @ np.array([0.0, 0.0, step], np.float32)
    return np.stack(Rs), np.stack(ts)


def imu_from_trajectory(R_wb: np.ndarray, p_wb: np.ndarray, dt: float,
                        rate_mult: int = 10,
                        gravity=(0.0, 0.0, -9.81)):
    """Finite-difference IMU samples along a keyframe trajectory.

    Interpolates the pose sequence `rate_mult`x (geodesic for rotation,
    cubic-ish for position via quadratic finite differences), then emits
    (w_body, a_body, t) samples at dt/rate_mult spacing.
    Returns list of (w [3], a [3], t).
    """
    g = np.asarray(gravity, np.float32)
    T = len(R_wb)
    h = dt / rate_mult
    samples = []
    # dense positions by Catmull-Rom-ish quadratic interpolation
    def pos(u):
        i = min(int(u), T - 2)
        f = u - i
        p0 = p_wb[max(i - 1, 0)]
        p1 = p_wb[i]
        p2 = p_wb[min(i + 1, T - 1)]
        p3 = p_wb[min(i + 2, T - 1)]
        # Catmull-Rom
        return 0.5 * ((2 * p1) + (-p0 + p2) * f
                      + (2 * p0 - 5 * p1 + 4 * p2 - p3) * f * f
                      + (-p0 + 3 * p1 - 3 * p2 + p3) * f ** 3)

    def rot(u):
        i = min(int(u), T - 2)
        f = u - i
        dR = R_wb[i].T @ R_wb[i + 1]
        w = _np_so3_log(np.asarray(dR, np.float64))
        return R_wb[i] @ _np_so3_exp(f * w)

    n = (T - 1) * rate_mult
    for k in range(n):
        u = k / rate_mult
        t = (k + 1) * h
        Rk = rot(u)
        # angular velocity: FD of rotation over h
        dR = Rk.T @ rot(u + 1.0 / rate_mult)
        w = (_np_so3_log(np.asarray(dR, np.float64)) / h).astype(
            np.float32)
        # world acceleration: central second difference
        a_w = (pos(u + 1.0 / rate_mult) - 2 * pos(u)
               + pos(max(u - 1.0 / rate_mult, 0.0))) / (h * h)
        a_b = Rk.T @ (a_w.astype(np.float32) - g)
        samples.append((w.astype(np.float32), a_b.astype(np.float32),
                        float(t)))
    return samples


def render_sequence(world: BlobWorld, kind, params, R_wc, t_wc, w, h,
                    dist=None):
    """Render all frames: [T, h, w]. Camera poses are world-from-camera.
    `dist`: optional radtan coefficients — raw distorted pinhole frames."""
    frames = []
    for R, t in zip(R_wc, t_wc):
        R_cw = R.T
        t_cw = -R.T @ t
        frames.append(render(world, kind, params, R_cw, t_cw, w, h,
                             dist=dist))
    return np.stack(frames)


def render_depth_sequence(world: BlobWorld, kind, params, R_wc, t_wc,
                          w, h):
    """Depth maps for all frames: [T, h, w] z-depth, 0 = no surface."""
    depths = []
    for R, t in zip(R_wc, t_wc):
        _, dm = render(world, kind, params, R.T, -R.T @ t, w, h,
                       with_depth=True)
        depths.append(dm)
    return np.stack(depths)
