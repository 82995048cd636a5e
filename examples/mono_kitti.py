#!/usr/bin/env python
"""KITTI odometry monocular replay (reference:
Examples/Monocular/mono_kitti.cc).

Usage:
    python examples/mono_kitti.py <sequence_dir> [--settings cfg.yaml]
        [--out trajectory_tum.txt] [--max-frames N]

<sequence_dir> is a KITTI odometry directory (times.txt, image_0/).
Default calibration is sequences 00-02 (reference:
Examples/Monocular/KITTI00-02.yaml: fx=fy=718.856, cx=607.1928,
cy=185.2157). Monocular: the trajectory is up-to-scale.
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

    seq = datasets.load_kitti(args.sequence, cams=("image_0",))
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} frames; replaying {n}", file=sys.stderr)

    if args.settings:
        cfg = cfg_mod.load_settings(args.settings)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=1)
        img0 = seq.frame(0)[0]
        cfg["Camera"]["width"] = img0.shape[1]
        cfg["Camera"]["height"] = img0.shape[0]
        # KITTI 00-02 calibration (Examples/Monocular/KITTI00-02.yaml)
        cfg["Camera1"].update(fx=718.856, fy=718.856, cx=607.1928,
                              cy=185.2157)
        cfg["ORBextractor"]["nFeatures"] = 2000   # KITTI00-02.yaml:47

    slam = system.System(cfg, system.Sensor.MONOCULAR,
                         use_viewer=args.viewer is not None,
                         viewer_port=args.viewer or 0)
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    t0 = time.perf_counter()
    for i in range(n):
        slam.track_monocular(seq.frame(i)[0], float(seq.cam_times[i]))
    dt = time.perf_counter() - t0
    slam.save_trajectory_tum(args.out)
    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps",
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
