#!/usr/bin/env python
"""Mono-inertial EuRoC replay (reference:
Examples/Monocular-Inertial/mono_inertial_euroc.cc).

Usage:
    python examples/mono_inertial_euroc.py <sequence_dir>
        [--settings cfg.yaml] [--out trajectory_tum.txt]
        [--gt groundtruth.txt] [--max-frames N]

<sequence_dir> is an EuRoC-format directory (mav0/cam0 + imu0).
IMU_MONOCULAR: two-view init at arbitrary scale, metric scale recovered
by the fix_scale=False inertial initialization (reference:
Tracking::MonocularInitialization + LocalMapping::InitializeIMU).
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
    ap.add_argument("--viewer", nargs="?", const=8080, type=int,
                    default=None, metavar="PORT",
                    help="serve the live map/frame viewer over HTTP "
                         "(the reference mains' bUseViewer; default port 8080)")
    args = ap.parse_args()

    from openmavis_jax.io import datasets, evaluation
    from openmavis_jax.io import settings as cfg_mod
    from openmavis_jax.pipeline import system

    seq = datasets.load_euroc(args.sequence, cams=("cam0",))
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} frames + {len(seq.imu)} IMU samples; "
          f"replaying {n}", file=sys.stderr)

    if args.settings:
        cfg = cfg_mod.load_settings(args.settings)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=1)
        img0 = seq.frame(0)[0]
        cfg["Camera"]["width"] = img0.shape[1]
        cfg["Camera"]["height"] = img0.shape[0]
        # EuRoC cam0 (reference: Examples/Monocular-Inertial/EuRoC.yaml)
        cfg["Camera1"].update(fx=458.654, fy=457.296, cx=367.215,
                              cy=248.375)
        cfg["IMU"] = {"NoiseGyro": 1.7e-4, "NoiseAcc": 2.0e-3,
                      "GyroWalk": 1.9e-5, "AccWalk": 3.0e-3,
                      "Frequency": 200.0}

    slam = system.System(cfg, system.Sensor.IMU_MONOCULAR,
                         use_viewer=args.viewer is not None,
                         viewer_port=args.viewer or 0)
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    t_prev = float(seq.cam_times[0]) - 1e-3
    t0 = time.perf_counter()
    for i in range(n):
        t = float(seq.cam_times[i])
        batch = [(row[1:4], row[4:7], row[0])
                 for row in seq.imu_between(t_prev, t)]
        slam.track_monocular(seq.frame(i)[0], t, imu_samples=batch)
        t_prev = t
    dt = time.perf_counter() - t0
    slam.save_trajectory_tum(args.out)
    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps; "
          f"imu_initialized={slam.tracker.imu_initialized}",
          file=sys.stderr)
    print(f"trajectory -> {args.out}", file=sys.stderr)

    if args.gt:
        traj = np.loadtxt(args.out)
        t_gt, p_gt = evaluation.load_ground_truth(args.gt)
        res = evaluation.ate_rmse(traj[:, 0], traj[:, 1:4], t_gt, p_gt,
                                  with_scale=True)
        print(f"ATE RMSE (scale-aligned): {res['rmse']:.4f} m, "
              f"scale {res['scale']:.4f}", file=sys.stderr)


if __name__ == "__main__":
    main()
