#!/usr/bin/env python
"""RGB-D-Inertial replay (reference:
Examples/RGB-D-Inertial/rgbd_inertial_realsense_D435i.cc — live D435i
gyro+accel+depth; this main replays the same sensor suite from disk).

Usage:
    python examples/rgbd_inertial.py <sequence_dir> [--settings cfg.yaml]
        [--out trajectory_tum.txt] [--gt groundtruth.txt] [--max-frames N]

<sequence_dir> is TUM RGB-D layout (rgb.txt, depth.txt, rgb/, depth/;
16-bit depth PNGs) plus an `imu.txt` with "t wx wy wz ax ay az" lines.
Depth priors lock metric scale immediately (depth-spawned landmarks,
frontend/depth.py); the IMU supplies the gravity direction, velocity and
biases through the staged inertial init — the IMU_RGBD sensor mode
(reference: System.h:64).
"""

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--settings", default=None)
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--depth-scale", type=float, default=5000.0)
    ap.add_argument("--viewer", nargs="?", const=8080, type=int,
                    default=None, metavar="PORT",
                    help="serve the live map/frame viewer over HTTP "
                         "(the reference mains' bUseViewer; default port 8080)")
    args = ap.parse_args()

    from openmavis_jax.io import datasets, evaluation
    from openmavis_jax.io import settings as cfg_mod
    from openmavis_jax.pipeline import system

    seq = datasets.load_tum_rgbd(args.sequence,
                                 depth_scale=args.depth_scale)
    if seq.imu is None:
        print("no imu.txt in sequence dir — use examples/rgbd_tum.py "
              "for vision-only RGB-D", file=sys.stderr)
        sys.exit(2)
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} rgb-d pairs + {len(seq.imu)} imu "
          f"samples; replaying {n}", file=sys.stderr)

    if args.settings:
        cfg = cfg_mod.load_settings(args.settings)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=1)
        gray0, _ = seq.frame(0)
        cfg["Camera"]["width"] = gray0.shape[1]
        cfg["Camera"]["height"] = gray0.shape[0]

    slam = system.System(cfg, system.Sensor.IMU_RGBD,
                         use_viewer=args.viewer is not None,
                         viewer_port=args.viewer or 0)
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    t_prev = None
    t0 = time.perf_counter()
    for i in range(n):
        gray, depth = seq.frame(i)
        t = float(seq.times[i])
        samples = []
        if t_prev is not None:
            for row in seq.imu_between(t_prev, t):
                samples.append((row[1:4], row[4:7], row[0]))
        slam.track_rgbd(gray, depth, t, imu_samples=samples)
        t_prev = t
    dt = time.perf_counter() - t0
    slam.save_trajectory_tum(args.out)
    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps",
          file=sys.stderr)
    print(f"trajectory -> {args.out}", file=sys.stderr)

    if args.gt:
        traj = np.loadtxt(args.out)
        t_gt, p_gt = evaluation.load_ground_truth(args.gt)
        res = evaluation.ate_rmse(traj[:, 0], traj[:, 1:4], t_gt, p_gt,
                                  with_scale=False)
        print(f"ATE RMSE: {res['rmse']:.4f} m (metric scale)",
              file=sys.stderr)


if __name__ == "__main__":
    main()
