#!/usr/bin/env python
"""Per-stage device timing of the keyframe mapper chain at the flagship
budget. Reuses the bench rig/sequence, streams enough frames to populate
a realistic map, then times each kf_insert stage in isolation (enqueue
`reps` dispatches, block once)."""

import sys
import time

sys.path.insert(0, ".")
import numpy as np

import bench


def main():
    import jax
    import jax.numpy as jnp

    from openmavis_jax.frontend import extractor
    from openmavis_jax.imu import preintegration as pre_mod
    from openmavis_jax.io import synthetic
    from openmavis_jax.pipeline import multi_tracking as mt
    from openmavis_jax.pipeline import streaming_vi, tracking as trk
    from openmavis_jax.slam_map import map_state as ms

    n_frames = 100
    rig, rig_np = bench.build_rig("kb8")
    R_wb, t_wb = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=0.8)
    frames = np.clip(bench.render_rig_sequence(rig_np, R_wb, t_wb),
                     0, 255).astype(np.uint8)
    dt = 1.0 / bench.FPS_IN
    imu = synthetic.imu_from_trajectory(R_wb, t_wb, dt, rate_mult=20)
    orb = extractor.OrbConfig(n_features=512, n_levels=8)
    cfg = streaming_vi.VIStreamConfig(
        img_w=bench.W, img_h=bench.H, n_cams=4, stereo_pairs=((0, 1),),
        orb=orb, imu_freq=400.0, imu_per_frame=32, max_kf=64,
        max_mp=16384, traj_cap=n_frames + 32, ba_window=8,
        imu_init_kfs=6, kf_max_interval_s=0.25, temporal_refs=2,
        po_rounds=2, po_iters=6, ba_stages=(3, 4), obs_cap=24576,
        local_map_window=10)
    noise = pre_mod.ImuNoise.from_sigmas(1.71e-4, 8.6e-3, 3.1e-6,
                                         2.2e-4, 400.0)
    imu_iter = iter(imu)
    pending = next(imu_iter, None)
    tr = streaming_vi.StreamingVITracker(rig, cfg, noise, seed=0,
                                         device_lc=dict(score_min=30,
                                                        temporal=2))
    for i in range(n_frames):
        t = i * dt
        b = []
        while pending is not None and pending[2] <= t + 1e-9:
            b.append(pending)
            pending = next(imu_iter, None)
        tr.push(frames[i], t, b)
    tr.block()
    snap = tr.snapshot()
    print(f"map: {int(snap['n_kf'])} KF, {int(snap['n_mp'])} MP,"
          f" imu_ok={bool(snap['imu_ok'])}", file=sys.stderr)

    m, c, rig = tr.map, tr.carry, tr.rig
    rig_kind = rig.kind
    C = 4
    Wn = cfg.ba_window

    def timeit(f, *fargs, reps=20):
        out = f(*fargs)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*fargs)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps * 1e3

    slot = jnp.maximum(c.last_kf_slot, 0)

    stages = {}

    f = jax.jit(lambda m, s, rig: mt.stereo_spawn(
        m, s, rig_kind, C, rig, (0, 1), cap_new=cfg.new_mp_cap)[0])
    stages["stereo_spawn"] = timeit(f, m, slot, rig)

    def tspawn(m, s, rig):
        refs = s - 1 - jnp.arange(cfg.temporal_refs, dtype=jnp.int32)
        return mt.temporal_spawn_multi(m, s, refs, rig_kind, C, rig,
                                       cfg.new_mp_cap,
                                       n_refs=cfg.temporal_refs)[0]
    stages["temporal_spawn(2)"] = timeit(jax.jit(tspawn), m, slot, rig)

    f = jax.jit(lambda m, s, rig: mt.bind_landmarks_multi(
        m, s, rig_kind, C, rig, bench.W, bench.H,
        min_last_kf=slot - cfg.local_map_window))
    stages["bind_landmarks"] = timeit(f, m, slot, rig)

    f = jax.jit(lambda m, s: trk.fuse_new_landmarks(
        m, s, cap=cfg.new_mp_cap))
    stages["fuse_new_landmarks"] = timeit(f, m, slot)

    f = jax.jit(lambda m, s: trk.cull_landmarks(m, s))
    stages["cull_landmarks"] = timeit(f, m, slot)

    f = jax.jit(lambda m, s: trk.cull_keyframes(
        m, s, inertial=True, imu_ok=True)[0])
    stages["cull_keyframes"] = timeit(f, m, slot)

    f = jax.jit(lambda m: ms.update_mp_geometry(m, None))
    stages["update_mp_geometry"] = timeit(f, m)

    def wba(m, c, s, rig):
        lo = jnp.maximum(s - Wn + 1, 0)
        ids = lo + jnp.arange(Wn)
        kf_in = (ids <= s) & m.kf_valid[ids]
        pre_w = jax.tree.map(lambda x: x[ids[1:]], c.chain)
        edge_ok = (c.chain_valid[ids[1:]] & kf_in[1:] & kf_in[:-1]
                   & c.imu_ok)
        return mt.vi_window_ba_step(m, ids, kf_in, pre_w, edge_ok,
                                    s - lo, rig_kind, rig,
                                    stages=cfg.ba_stages)[0]
    stages["vi_window_ba(3,4)"] = timeit(jax.jit(wba), m, c, slot, rig,
                                         reps=10)

    total = sum(stages.values())
    for k, v in stages.items():
        print(f"{k:24s} {v:7.2f} ms")
    print(f"{'TOTAL kf chain':24s} {total:7.2f} ms")


if __name__ == "__main__":
    main()
