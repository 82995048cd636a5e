#!/usr/bin/env python
"""Offline ORB vocabulary trainer (the DBoW2 ORBvoc equivalent).

The reference ships a pre-trained 1M-word vocabulary
(Vocabulary/ORBvoc.txt, k=10 L=6; build.sh:30-33) trained offline on
~10k images. This trains the device tree (slam_map/vocabulary.py —
batched k-means over Hamming space, all nodes of a level in one jitted
loop) from any EuRoC-layout dataset directory, or from a synthetic
world when no dataset is mounted, and persists it with an MD5 content
hash (System.cc:1520-1556 binding semantics).

Usage:
    python scripts/train_vocab.py out.npz [--data mav0_dir[,dir2,...]]
        [--k 10] [--levels 5] [--samples 500000] [--frames 200]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def collect_dataset(dirs, n_frames, orb):
    import numpy as np
    import jax.numpy as jnp
    from openmavis_jax.frontend import extractor
    from openmavis_jax.io import datasets

    out = []
    for d in dirs:
        seq = datasets.load_euroc(d, cams=("cam0",))
        step = max(1, seq.n_frames // n_frames)
        for i in range(0, seq.n_frames, step):
            f = extractor.extract_multicam(
                jnp.asarray(seq.frame(i)), orb)
            v = np.asarray(f.valid[0])
            out.append(np.asarray(f.desc[0])[v])
    return out


def collect_synthetic(n_frames, orb):
    import numpy as np
    import jax.numpy as jnp
    from openmavis_jax.frontend import extractor
    from openmavis_jax.geometry import cameras
    from openmavis_jax.io import synthetic

    W, H = 640, 480
    pin = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    out = []
    for seed in range(max(1, n_frames // 40)):
        world = synthetic.BlobWorld.create(seed=seed, n=4000)
        R, t = synthetic.orbit_trajectory(40, radius=6.0, frac=1.0)
        frames = synthetic.render_sequence(world, cameras.PINHOLE, pin,
                                           R, t, W, H)
        for img in frames:
            f = extractor.extract_multicam(jnp.asarray(img)[None], orb)
            v = np.asarray(f.valid[0])
            out.append(np.asarray(f.desc[0])[v])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--data", default=None)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--samples", type=int, default=500000)
    ap.add_argument("--frames", type=int, default=200)
    args = ap.parse_args()

    import numpy as np
    from openmavis_jax.frontend import extractor
    from openmavis_jax.slam_map import vocabulary as voc

    orb = extractor.OrbConfig(n_features=1024, n_levels=8)
    if args.data:
        banks = collect_dataset(args.data.split(","), args.frames, orb)
    else:
        banks = collect_synthetic(args.frames, orb)
    desc = np.concatenate(banks)
    print(f"collected {len(desc)} descriptors from {len(banks)} frames",
          file=sys.stderr)
    if len(desc) > args.samples:
        sel = np.random.default_rng(0).choice(len(desc), args.samples,
                                              replace=False)
        desc = desc[sel]
    vocab = voc.train(desc, k=args.k, levels=args.levels)
    digest = voc.save(args.out, vocab)
    print(f"{vocab.n_words}-word vocabulary (k={args.k}, "
          f"L={args.levels}) -> {args.out} (md5 {digest})",
          file=sys.stderr)


if __name__ == "__main__":
    main()
