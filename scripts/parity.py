#!/usr/bin/env python
"""Dataset-parity harness: BASELINE.json configs 1-5, ready to fire.

Maps each parity config to an example-main invocation with the
REFERENCE'S OWN yaml (ingested verbatim by openmavis_jax.io.settings)
and an ATE gate evaluated with the reference metric semantics
(evaluation/evaluate_ate_scale.py:141-165 — Horn alignment, RMSE with
and without scale).

Usage:
    python scripts/parity.py list
    python scripts/parity.py <config> --data-root /datasets [options]
    python scripts/parity.py all --data-root /datasets

where <config> is one of: mono-mh01, si-v102, mi-tumvi-room1,
multi-hilti-exp01, multisession-mh.

Dataset layout expected under --data-root (standard distribution forms):
    MH_01_easy/mav0/...          (EuRoC)
    MH_02_easy ... MH_05_difficult
    V1_02_medium/mav0/...
    dataset-room1_512_16/mav0/...（TUM-VI)
    exp01/mav0/...               (Hilti 2022, EuRoC-converted)

Each config runs the moment its directory exists; missing directories
are reported and skipped (exit code 2 = nothing runnable). Ground truth
for EuRoC comes from the reference checkout
(/root/reference/evaluation/Ground_truth/EuRoC_left_cam/); TUM-VI and
Hilti ground truth is read from the dataset (mav0/mocap0/data.csv).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
GT_EUROC = os.path.join(REF, "evaluation", "Ground_truth",
                        "EuRoC_left_cam")


def _gt_for(seq_dir: str, euroc_name: str | None):
    """Ground-truth path: reference-shipped EuRoC GT, else the dataset's
    mocap/state estimate csv."""
    if euroc_name:
        p = os.path.join(GT_EUROC, euroc_name)
        if os.path.exists(p):
            return p
    for rel in ("mav0/mocap0/data.csv",
                "mav0/state_groundtruth_estimate0/data.csv"):
        p = os.path.join(seq_dir, rel)
        if os.path.exists(p):
            return p
    return None


# (key, example main, dataset dir candidates, reference yaml,
#  euroc GT file, ate gate [m], extra argv)
CONFIGS = [
    ("mono-mh01", "mono_euroc.py",
     ["MH_01_easy", "MH01"],
     f"{REF}/Examples/Monocular/EuRoC.yaml",
     "MH01_GT.txt", 0.09, []),
    ("si-v102", "stereo_inertial_euroc.py",
     ["V1_02_medium", "V102"],
     f"{REF}/Examples/Stereo-Inertial/EuRoC.yaml",
     "V102_GT.txt", 0.06, []),
    ("mi-tumvi-room1", "mono_inertial_tum_vi.py",
     ["dataset-room1_512_16", "room1"],
     f"{REF}/Examples/Monocular-Inertial/TUM-VI.yaml",
     None, 0.10, []),
    ("multi-hilti-exp01", "multi_inertial_euroc.py",
     ["exp01", "exp01_construction_ground_level"],
     f"{REF}/Examples/Multi-Inertial/HiltiChallenge2022.yaml",
     None, 0.12,
     # reference camera order: cam1 (left), cam0 (right), cam4 (side-
     # left), cam3 (side-right) (multi_inertial_euroc.cc:49-75)
     ["--cams", "cam1,cam0,cam4,cam3", "--max-kf", "256"]),
]

MULTISESSION_SEQS = [
    ("MH_01_easy", "MH01_GT.txt"), ("MH_02_easy", "MH02_GT.txt"),
    ("MH_03_medium", "MH03_GT.txt"), ("MH_04_difficult", "MH04_GT.txt"),
    ("MH_05_difficult", "MH05_GT.txt"),
]


def _find_seq(root: str, candidates):
    for c in candidates:
        p = os.path.join(root, c)
        if os.path.isdir(p):
            return p
    return None


def run_config(key: str, data_root: str, max_frames: int = 0,
               out_dir: str = "/tmp/parity") -> dict:
    os.makedirs(out_dir, exist_ok=True)
    cfg = next((c for c in CONFIGS if c[0] == key), None)
    if cfg is None:
        raise SystemExit(f"unknown config {key}")
    _, main, cands, yaml_path, gt_name, gate, extra = cfg
    seq = _find_seq(data_root, cands)
    if seq is None:
        return {"config": key, "status": "missing",
                "looked_for": [os.path.join(data_root, c)
                               for c in cands]}
    gt = _gt_for(seq, gt_name)
    out = os.path.join(out_dir, f"{key}.txt")
    argv = [sys.executable, os.path.join(REPO, "examples", main),
            seq, "--settings", yaml_path, "--out", out, *extra]
    if gt:
        argv += ["--gt", gt]
    if max_frames:
        argv += ["--max-frames", str(max_frames)]
    proc = subprocess.run(argv, capture_output=True, text=True,
                          cwd=REPO)
    res = {"config": key, "status": "ran", "rc": proc.returncode,
           "cmd": " ".join(argv), "stderr_tail": proc.stderr[-800:]}
    if proc.returncode == 0 and gt:
        import numpy as np
        from openmavis_jax.io import evaluation
        t_gt, p_gt = evaluation.load_ground_truth(gt)
        traj = np.loadtxt(out)
        ate = evaluation.ate_rmse(traj[:, 0], traj[:, 1:4], t_gt, p_gt,
                                  with_scale=True)
        res.update(ate_rmse=round(ate["rmse"], 4),
                   ate_rmse_noscale=round(ate["rmse_noscale"], 4),
                   scale=round(ate["scale"], 4), gate=gate,
                   passed=bool(ate["rmse"] <= gate))
    return res


def run_multisession(data_root: str, max_frames: int = 0,
                     out_dir: str = "/tmp/parity") -> dict:
    """Config 5: sequential EuRoC MH01-05 sessions through one Atlas —
    new map per session, merge re-join by place recognition
    (reference: multi-session experiments of ORB-SLAM3;
    Atlas::CreateNewMap + LoopClosing merge path)."""
    seqs = []
    for name, gt in MULTISESSION_SEQS:
        p = _find_seq(data_root, [name, name.split("_")[0] +
                                  name.split("_")[1]])
        if p:
            seqs.append((p, gt))
    if len(seqs) < 2:
        return {"config": "multisession-mh", "status": "missing",
                "found": len(seqs),
                "note": "needs >= 2 of MH_01..MH_05 under --data-root"}
    argv = [sys.executable, os.path.join(
        REPO, "examples", "multisession_euroc.py"),
        *[s for s, _ in seqs],
        "--settings", f"{REF}/Examples/Stereo-Inertial/EuRoC.yaml",
        "--out-dir", out_dir]
    if max_frames:
        argv += ["--max-frames", str(max_frames)]
    proc = subprocess.run(argv, capture_output=True, text=True,
                          cwd=REPO)
    res = {"config": "multisession-mh", "status": "ran",
           "rc": proc.returncode, "cmd": " ".join(argv),
           "stderr_tail": proc.stderr[-800:]}
    if proc.returncode == 0:
        import numpy as np
        from openmavis_jax.io import evaluation
        ates = {}
        ok_all = True
        for i, (seq, gt_name) in enumerate(seqs):
            gt = _gt_for(seq, gt_name)
            out = os.path.join(out_dir, f"session{i}.txt")
            if gt and os.path.exists(out):
                t_gt, p_gt = evaluation.load_ground_truth(gt)
                traj = np.loadtxt(out)
                ate = evaluation.ate_rmse(traj[:, 0], traj[:, 1:4],
                                          t_gt, p_gt, with_scale=True)
                ates[os.path.basename(seq)] = round(ate["rmse"], 4)
                ok_all &= ate["rmse"] <= 0.10
        res.update(ate_per_session=ates, gate=0.10, passed=ok_all)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="config key, 'all', or 'list'")
    ap.add_argument("--data-root", default="/datasets")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out-dir", default="/tmp/parity")
    args = ap.parse_args()

    if args.config == "list":
        for c in CONFIGS:
            print(f"{c[0]:20s} {c[1]:28s} yaml={os.path.basename(c[3])}"
                  f" gate={c[5]}m")
        print(f"{'multisession-mh':20s} multisession_euroc.py        "
              f"gate=0.10m")
        return 0

    keys = ([c[0] for c in CONFIGS] + ["multisession-mh"]
            if args.config == "all" else [args.config])
    results, ran = [], 0
    for k in keys:
        r = (run_multisession(args.data_root, args.max_frames,
                              args.out_dir)
             if k == "multisession-mh"
             else run_config(k, args.data_root, args.max_frames,
                             args.out_dir))
        results.append(r)
        ran += r["status"] == "ran"
        print(json.dumps(r), flush=True)
    if ran == 0:
        print("no dataset directories found — mount them under "
              f"{args.data_root} (see module docstring)",
              file=sys.stderr)
        return 2
    return 0 if all(r.get("passed", True) for r in results
                    if r["status"] == "ran") else 1


if __name__ == "__main__":
    sys.exit(main())
