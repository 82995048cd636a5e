#!/usr/bin/env python
"""Monocular EuRoC replay (reference: Examples/Monocular/mono_euroc.cc).

Usage:
    python examples/mono_euroc.py <sequence_dir> [--settings cfg.yaml]
        [--out trajectory_tum.txt] [--gt groundtruth.txt] [--max-frames N]
        [--streaming]

<sequence_dir> is an EuRoC-format directory (mav0/cam0/data + data.csv).
With --gt (TUM-format `t x y z qx qy qz qw` or EuRoC state estimate csv),
prints ATE RMSE via the reference's metric (evaluation/
evaluate_ate_scale.py semantics, reimplemented in io/evaluation.py).

--streaming replays through the single-dispatch device pipeline
(pipeline/streaming.py) instead of the host-policy System facade — the
fast path.
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
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--viewer", nargs="?", const=8080, type=int,
                    default=None, metavar="PORT",
                    help="serve the live map/frame viewer over HTTP "
                         "(the reference mains' bUseViewer; default port 8080)")
    args = ap.parse_args()

    import jax.numpy as jnp

    from openmavis_jax.io import datasets, evaluation, settings as cfg_mod
    from openmavis_jax.pipeline import system

    seq = datasets.load_euroc(args.sequence, cams=("cam0",))
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} frames; replaying {n}", file=sys.stderr)

    if args.settings:
        # keep the RAW dict: System re-parses it (and the example
        # indexes raw Camera*/ORBextractor keys)
        cfg = cfg_mod.load_settings(args.settings)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=1)
        img0 = seq.frame(0)[0]
        cfg["Camera"]["width"] = img0.shape[1]
        cfg["Camera"]["height"] = img0.shape[0]
        # EuRoC cam0 calibration (reference: Examples/Monocular/EuRoC.yaml)
        cfg["Camera1"].update(fx=458.654, fy=457.296, cx=367.215,
                              cy=248.375)

    if args.streaming:
        from openmavis_jax.frontend import extractor
        from openmavis_jax.geometry import cameras
        from openmavis_jax.optim.reprojection import RigParams
        from openmavis_jax.pipeline import streaming

        c1 = cfg["Camera1"]
        pin = np.array([c1["fx"], c1["fy"], c1["cx"], c1["cy"],
                        0, 0, 0, 0], np.float32)
        rig = RigParams(kind=cameras.PINHOLE,
                        params=jnp.asarray(pin)[None],
                        R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))
        scfg = streaming.StreamConfig(
            img_w=cfg["Camera"]["width"], img_h=cfg["Camera"]["height"],
            orb=extractor.OrbConfig(
                n_features=cfg["ORBextractor"]["nFeatures"],
                n_levels=cfg["ORBextractor"]["nLevels"]),
            max_kf=64, max_mp=16384, traj_cap=max(n, 64))
        tr = streaming.StreamingTracker(rig, scfg, seed=0)
        t0 = time.perf_counter()
        for i in range(n):
            tr.push(jnp.asarray(seq.frame(i)[0]),
                    float(seq.cam_times[i]))
        tr.block()
        dt = time.perf_counter() - t0
        t_est, R_est, p_est = tr.get_trajectory()
        from openmavis_jax.io import trajectory
        trajectory.save_tum(args.out, t_est, R_est, p_est)
    else:
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
        traj = np.loadtxt(args.out)
        t_est, p_est = traj[:, 0], traj[:, 1:4]

    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps",
          file=sys.stderr)
    print(f"trajectory -> {args.out}", file=sys.stderr)

    if args.gt:
        t_gt, p_gt = evaluation.load_ground_truth(args.gt)
        res = evaluation.ate_rmse(t_est, p_est, t_gt, p_gt,
                                  with_scale=True)
        print(f"ATE RMSE (scale-aligned): {res['rmse']:.4f} m, "
              f"scale {res['scale']:.4f}", file=sys.stderr)


if __name__ == "__main__":
    main()
