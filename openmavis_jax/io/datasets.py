"""Dataset loaders: EuRoC / TUM-VI directory layouts (+ synthetic).

(reference: the per-dataset loaders in Examples/*/*.cc — e.g.
Examples/Multi-Inertial/multi_inertial_euroc.cc:49-215 loads N camera image
lists + per-camera timestamps + an IMU csv.)

Image decoding prefers the native C++ prefetching loader
(openmavis_jax.io.native_loader) and falls back to PIL.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class Sequence:
    """A time-indexed multi-camera + IMU sequence."""
    cam_dirs: list          # per camera: directory with image files
    cam_files: list         # per camera: sorted filenames
    cam_times: np.ndarray   # [T] seconds (common timeline, cam0)
    imu: np.ndarray         # [N, 7]: t, wx, wy, wz, ax, ay, az
    _loader: object = None

    @property
    def n_frames(self):
        return len(self.cam_times)

    @property
    def n_cams(self):
        return len(self.cam_dirs)

    def frame(self, i: int) -> np.ndarray:
        """[C, H, W] float32 grayscale images of frame i."""
        imgs = []
        for c in range(self.n_cams):
            path = os.path.join(self.cam_dirs[c], self.cam_files[c][i])
            imgs.append(load_gray(path, self._loader))
        return np.stack(imgs)

    def imu_between(self, t0: float, t1: float) -> np.ndarray:
        sel = (self.imu[:, 0] > t0) & (self.imu[:, 0] <= t1)
        return self.imu[sel]


def load_gray(path: str, loader=None) -> np.ndarray:
    """Decode one image to [H, W] float32 (native loader if available)."""
    if loader is not None:
        img = loader.decode(path)
        if img is not None:
            return img
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.float32)


def _read_euroc_csv(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.split(","))
    return rows


def load_euroc(root: str, cams=("cam0",), imu: str = "imu0",
               use_native: bool = True) -> Sequence:
    """Load an EuRoC-format sequence directory.

    Layout: <root>/mav0/{cam0,cam1,...}/data/*.png + data.csv,
            <root>/mav0/imu0/data.csv (ns timestamps).
    """
    mav = os.path.join(root, "mav0")
    if not os.path.isdir(mav):
        mav = root
    cam_dirs, cam_files, times0 = [], [], None
    for c in cams:
        d = os.path.join(mav, c, "data")
        rows = _read_euroc_csv(os.path.join(mav, c, "data.csv"))
        files = [r[1].strip() for r in rows]
        ts = np.asarray([int(r[0]) for r in rows], np.int64) / 1e9
        cam_dirs.append(d)
        cam_files.append(files)
        if times0 is None:
            times0 = ts
    imu_rows = _read_euroc_csv(os.path.join(mav, imu, "data.csv"))
    imu_arr = np.asarray(
        [[int(r[0]) / 1e9] + [float(x) for x in r[1:7]]
         for r in imu_rows], np.float64)

    loader = None
    if use_native:
        try:
            from . import native_loader
            loader = native_loader.NativeDecoder()
        except Exception:
            loader = None
    return Sequence(cam_dirs=cam_dirs, cam_files=cam_files,
                    cam_times=times0, imu=imu_arr, _loader=loader)


def load_tumvi(root: str, cams=("cam0",), imu: str = "imu0",
               use_native: bool = True) -> Sequence:
    """Load a TUM-VI sequence (same mav0 layout as EuRoC).

    (reference: Examples/Monocular-Inertial/mono_inertial_tum_vi.cc — the
    TUM-VI release ships EuRoC-format directories: mav0/cam0/data + csv,
    mav0/imu0/data.csv with ns timestamps; only the calibration — 512x512
    fisheye KannalaBrandt8 — differs, which lives in the yaml settings.)
    """
    return load_euroc(root, cams=cams, imu=imu, use_native=use_native)


def load_kitti(root: str, cams=("image_0",),
               use_native: bool = True) -> Sequence:
    """Load a KITTI odometry sequence directory.

    Layout: <root>/times.txt (seconds, one per line) and
    <root>/image_0/000000.png ... (image_1 = right grayscale camera).
    (reference: Examples/Stereo/stereo_kitti.cc LoadImages — times.txt +
    zero-padded 6-digit frame files; KITTI has no IMU in the odometry
    benchmark, so `imu` is empty.)
    """
    with open(os.path.join(root, "times.txt")) as f:
        times = np.asarray([float(line) for line in f if line.strip()],
                           np.float64)
    cam_dirs, cam_files = [], []
    for c in cams:
        d = os.path.join(root, c)
        files = sorted(fn for fn in os.listdir(d)
                       if fn.endswith((".png", ".jpg", ".pgm")))
        if len(files) < len(times):
            raise ValueError(
                f"{d}: {len(files)} images < {len(times)} timestamps")
        cam_dirs.append(d)
        cam_files.append(files[:len(times)])
    loader = None
    if use_native:
        try:
            from . import native_loader
            loader = native_loader.NativeDecoder()
        except Exception:
            loader = None
    return Sequence(cam_dirs=cam_dirs, cam_files=cam_files,
                    cam_times=times, imu=np.zeros((0, 7), np.float64),
                    _loader=loader)


@dataclass
class RgbdSequence:
    """Associated RGB + depth frame pairs (TUM RGB-D layout), plus an
    optional 6-axis IMU stream for RGB-D-Inertial replays."""
    root: str
    rgb_files: list
    depth_files: list
    times: np.ndarray        # [T] seconds
    depth_scale: float       # depth_png / depth_scale = meters
    imu: np.ndarray = None   # [N, 7]: t, wx, wy, wz, ax, ay, az
    _loader: object = None

    @property
    def n_frames(self):
        return len(self.times)

    def imu_between(self, t0: float, t1: float) -> np.ndarray:
        if self.imu is None or len(self.imu) == 0:
            return np.zeros((0, 7), np.float64)
        sel = (self.imu[:, 0] > t0) & (self.imu[:, 0] <= t1)
        return self.imu[sel]

    def frame(self, i: int):
        """(gray [H, W] f32, depth_m [H, W] f32; 0 = no measurement)."""
        gray = load_gray(os.path.join(self.root, self.rgb_files[i]),
                         self._loader)
        from PIL import Image
        with Image.open(os.path.join(self.root,
                                     self.depth_files[i])) as im:
            depth = np.asarray(im, dtype=np.float32) / self.depth_scale
        return gray, depth


def load_tum_rgbd(root: str, depth_scale: float = 5000.0,
                  max_dt: float = 0.02,
                  use_native: bool = True) -> RgbdSequence:
    """Load a TUM RGB-D sequence directory.

    Layout: <root>/rgb.txt + depth.txt ("t path" lines); depth PNGs are
    16-bit, 5000 units per meter. RGB and depth streams run at slightly
    different rates — frames are associated by nearest timestamp within
    `max_dt` (the evaluation/associate.py policy the reference ships;
    reference main: Examples/RGB-D/rgbd_tum.cc LoadImages reads a
    pre-associated file, this loader does the association inline).
    """
    def read_list(name):
        ts, paths = [], []
        with open(os.path.join(root, name)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, p = line.split()[:2]
                ts.append(float(t))
                paths.append(p)
        return np.asarray(ts), paths

    t_rgb, f_rgb = read_list("rgb.txt")
    t_dep, f_dep = read_list("depth.txt")
    rgb_files, depth_files, times = [], [], []
    j = 0
    for i, t in enumerate(t_rgb):
        j = int(np.searchsorted(t_dep, t))
        best, bdt = -1, max_dt
        for jj in (j - 1, j):
            if 0 <= jj < len(t_dep) and abs(t_dep[jj] - t) <= bdt:
                best, bdt = jj, abs(t_dep[jj] - t)
        if best >= 0:
            rgb_files.append(f_rgb[i])
            depth_files.append(f_dep[best])
            times.append(t)
    loader = None
    if use_native:
        try:
            from . import native_loader
            loader = native_loader.NativeDecoder()
        except Exception:
            loader = None
    # optional 6-axis IMU for RGB-D-Inertial (reference main:
    # Examples/RGB-D-Inertial/rgbd_inertial_realsense_D435i.cc — live
    # gyro+accel; for dataset replay we read an imu.txt with
    # "t wx wy wz ax ay az" lines)
    imu = None
    imu_path = os.path.join(root, "imu.txt")
    if os.path.exists(imu_path):
        rows = []
        with open(imu_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(x)
                             for x in line.replace(",", " ").split()[:7]])
        imu = np.asarray(rows, np.float64)
    return RgbdSequence(root=root, rgb_files=rgb_files,
                        depth_files=depth_files,
                        times=np.asarray(times),
                        depth_scale=depth_scale, imu=imu,
                        _loader=loader)
