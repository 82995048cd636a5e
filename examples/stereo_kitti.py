#!/usr/bin/env python
"""KITTI odometry stereo replay (reference: Examples/Stereo/stereo_kitti.cc).

Usage:
    python examples/stereo_kitti.py <sequence_dir> [--settings cfg.yaml]
        [--out trajectory_kitti.txt] [--max-frames N]

<sequence_dir> is a KITTI odometry directory (times.txt, image_0/,
image_1/). Default calibration is KITTI sequences 00-02
(reference: Examples/Stereo/KITTI00-02.yaml: fx=fy=718.856,
cx=607.1928, cy=185.2157, baseline 0.5372 m). The trajectory is written
in the KITTI format (12 pose-matrix values per line).
"""

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--settings", default=None)
    ap.add_argument("--out", default="trajectory_kitti.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--viewer", nargs="?", const=8080, type=int,
                    default=None, metavar="PORT",
                    help="serve the live map/frame viewer over HTTP "
                         "(the reference mains' bUseViewer; default port 8080)")
    args = ap.parse_args()

    from openmavis_jax.io import datasets
    from openmavis_jax.io import settings as cfg_mod
    from openmavis_jax.pipeline import system

    seq = datasets.load_kitti(args.sequence, cams=("image_0", "image_1"))
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} stereo pairs; replaying {n}",
          file=sys.stderr)

    if args.settings:
        # keep the RAW dict: System re-parses it (and the example
        # indexes raw Camera*/ORBextractor keys)
        cfg = cfg_mod.load_settings(args.settings)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=2)
        img0 = seq.frame(0)[0]
        cfg["Camera"]["width"] = img0.shape[1]
        cfg["Camera"]["height"] = img0.shape[0]
        for c in ("Camera1", "Camera2"):
            cfg[c].update(fx=718.856, fy=718.856, cx=607.1928,
                          cy=185.2157)
        T = np.eye(4)
        T[0, 3] = 0.5372    # KITTI 00-02 stereo baseline (meters)
        cfg["Camera2"]["T_b_c"] = T.tolist()

    slam = system.System(cfg, system.Sensor.STEREO,
                         use_viewer=args.viewer is not None,
                         viewer_port=args.viewer or 0)
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    t0 = time.perf_counter()
    for i in range(n):
        imgs = seq.frame(i)
        slam.track_stereo(imgs[0], imgs[1], float(seq.cam_times[i]))
    dt = time.perf_counter() - t0

    # KITTI-format trajectory (reference: System::SaveTrajectoryKITTI,
    # src/System.cc — 3x4 row-major pose per line, camera frame)
    slam.save_trajectory_kitti(args.out)
    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps",
          file=sys.stderr)
    print(f"trajectory -> {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
