#!/bin/bash
# Flagship-bench ablation matrix on the GPU: attributes per-frame cost to
# pipeline stages by end-to-end deltas and isolates accuracy regressions.
# Writes one JSON line per config to stdout.
set -u
cd "$(dirname "$0")/.."
run() {
  echo "### $*" >&2
  timeout 1500 python bench.py "$@" 2>/dev/null | tail -1
}
run                                   # default: 64-KF slab, BoW LC, gba amortized
run --gba-steps 0                     # minus amortized post-loop GBA
run --no-lc                           # minus the whole LC program
run --kf-interval 0.5                 # half the keyframe rate (mapper chain cost)
run --fpd 8                           # chunked dispatch (one scan per 8 frames)
run --max-kf 256 --max-mp 32768 --track-cap 8192   # Atlas-scale slab (slab-size cost)
