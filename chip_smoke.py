#!/usr/bin/env python
"""Smoke run of the flagship streaming multi-camera VI pipeline on one GPU.

    python chip_smoke.py                # phases a-e, one card
    python chip_smoke.py --four-cards   # phase f only, four cards
    python chip_smoke.py --four-cards --state f.npz   # phase f from a
        # tracker state saved by save_four_card_state("f.npz") on one card

Everything runs in this one process, and any failure exits non-zero. It
exits non-zero before doing any work when JAX finds no GPU.

a. matcher: the Hamming best-2 match at every match shape of the per-frame
   program (read by tracing it), bit-exact against a numpy popcount
   reference, and its time on the card;
b. flagship stream: bench.py's configuration (4x KannalaBrandt8 640x480,
   512 ORB features x 8 levels, 400 Hz IMU, 64-KF / 16384-landmark slab,
   device loop closing, 160 frames over 1.25 orbits) through
   StreamingVITracker.push/block/get_trajectory, with compile seconds,
   memory, counters, ATE and gates;
c. determinism: phase b again with the same seed, timed warm (a smoke
   figure, not a benchmark), and whether the two trajectories are
   bit-identical;
d. facade: the README quick start, System(IMU_MULTI).track_multi over 20
   rendered frames, then save_trajectory_tum;
e. the tests marked `gpu`, in this process;
f. (--four-cards) the landmark-sharded GBA on four cards against one: the
   Atlas-scale product path, and the inertial run_global_ba(mesh=...) from
   one tracker state.

Every line names the card. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# rig sizes: the flagship's; a stereo pair at half width, whose per-frame
# program compiles faster, for phase f's tracker state; a tiny one for CPU
# tests of the phases
FLAGSHIP = dict(w=640, h=480, n_cams=4, n_features=512, n_levels=8)
STEREO_HALF = dict(w=320, h=240, n_cams=2, n_features=256, n_levels=4)
TINY = dict(w=160, h=120, n_cams=2, n_features=96, n_levels=3)

# phase b gates. 0.08 m is the spread of this sequence's scaled ATE under
# perturbation (seed, trajectory length, descriptor sampling path).
MIN_TRACKED = 152
MAX_ATE_M = 0.08
# phase f: keyframe positions of the 4-card and 1-card solves agree within
# 1 mm. Both run the same float32 algorithm; the psum over shards adds the
# per-shard partial sums in another order, which moves the result by
# rounding only (~1e-6 relative), far below a millimetre at these scales.
FOUR_CARD_TOL_M = 1e-3

_CARD = ""
_T0 = time.perf_counter()


def log(msg: str):
    """One output line, naming the card and the seconds since start."""
    print(f"[{_CARD}] +{time.perf_counter() - _T0:.0f}s {msg}", flush=True)


class CompileTimes:
    """Backend compile seconds per jitted program, from jax.monitoring."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.by_name: dict = {}

    def __call__(self, event, duration, **kw):
        if event == self.EVENT:
            name = str(kw.get("fun_name", "?"))
            n, t = self.by_name.get(name, (0, 0.0))
            self.by_name[name] = (n + 1, t + duration)

    def report(self, min_s: float = 0.5) -> str:
        big = sorted(((t, n, k) for k, (n, t) in self.by_name.items()
                      if t >= min_s), reverse=True)
        total = sum(t for n, t in self.by_name.values())
        count = sum(n for n, t in self.by_name.values())
        parts = [f"{k} {t:.1f}s" + (f" (x{n})" if n > 1 else "")
                 for t, n, k in big]
        return (f"{count} programs, {total:.1f}s total; "
                + (", ".join(parts) or "none over 0.5s"))


# ---------------------------------------------------------------------------
# phase a: matcher
# ---------------------------------------------------------------------------

def step_match_shapes(tr, s: dict) -> list:
    """(queries, targets, mutual) of every match_nn call in the tracker's
    per-frame program, read by tracing (and lowering) it once. Later
    calls reuse that trace."""
    from openmavis_jax.frontend import matcher

    orig = matcher.match_nn
    sig = inspect.signature(orig)
    seen = set()

    def recording(*args, **kw):
        b = sig.bind(*args, **kw)
        b.apply_defaults()
        seen.add((int(b.arguments["d1"].shape[0]),
                  int(b.arguments["d2"].shape[0]),
                  bool(b.arguments["mutual"])))
        return orig(*args, **kw)

    matcher.match_nn = recording
    try:
        t, samples = s["frame_imu"][0]
        tr.lower_step(s["frames"][0], t, samples)
    finally:
        matcher.match_nn = orig
    return sorted(seen)


def _popcount_u8(x: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    lut = np.array([bin(i).count("1") for i in range(256)], np.uint8)
    return lut[x]


def reference_best2(d1, d2, mask, chunk: int = 512):
    """numpy reference of matcher.masked_best2 over Hamming distances
    computed as popcount(a XOR b) on packed bits."""
    p1 = np.packbits(d1.astype(bool), axis=1)
    p2 = np.packbits(d2.astype(bool), axis=1)
    n = len(d1)
    bi = np.zeros(n, np.int64)
    b = np.zeros(n, np.int64)
    sec = np.zeros(n, np.int64)
    dists = []
    for lo in range(0, n, chunk):
        x = p1[lo:lo + chunk, None, :] ^ p2[None, :, :]
        dist = _popcount_u8(x).sum(-1, dtype=np.int32)
        dists.append(dist)
        d = np.where(mask[lo:lo + chunk], np.minimum(dist, 299), 300)
        rows = np.arange(len(d))
        i = d.argmin(1)
        bi[lo:lo + chunk] = i
        b[lo:lo + chunk] = d[rows, i]
        d[rows, i] = 300
        sec[lo:lo + chunk] = d.min(1)
    return bi, b, sec, np.concatenate(dists)


def phase_matcher(shapes, reps: int = 20, seed: int = 0) -> list:
    """Exactness against the numpy reference and time per call of the
    match at each (queries, targets, mutual) shape."""
    import jax
    import jax.numpy as jnp

    from openmavis_jax.frontend import matcher

    @jax.jit
    def best2(d1, d2, mask):
        dist = matcher.hamming_matrix(d1, d2)
        bi, b, s = matcher.masked_best2(dist, mask)
        bi21, _ = matcher.masked_argmin(dist.T, mask.T)
        return bi, b, s, bi21

    rng = np.random.default_rng(seed)
    out = []
    for n, m, mutual in shapes:
        d1 = (rng.random((n, 256)) < 0.5).astype(np.int8)
        d2 = (rng.random((m, 256)) < 0.5).astype(np.int8)
        mask = rng.random((n, m)) < 0.1
        # a few exact duplicates exercise smallest-index tie-breaking
        d2[1::97] = d2[0]
        args = (jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask))
        res = [np.asarray(x) for x in jax.block_until_ready(best2(*args))]
        rbi, rb, rs, dist = reference_best2(d1, d2, mask)
        has = rb < 300
        exact = (np.array_equal(res[0][has], rbi[has])
                 and np.array_equal(res[1], rb)
                 and np.array_equal(res[2], rs))
        if mutual:
            dt_ = np.where(mask.T, np.minimum(dist.T, 299), 300)
            has21 = dt_.min(1) < 300
            exact = exact and np.array_equal(res[3][has21],
                                             dt_.argmin(1)[has21])
        t0 = time.perf_counter()
        for _ in range(reps):
            r = best2(*args)
        jax.block_until_ready(r)
        ms = (time.perf_counter() - t0) / reps * 1e3
        out.append(dict(shape=(n, m), mutual=mutual, exact=bool(exact),
                        ms=ms))
    return out


# ---------------------------------------------------------------------------
# phases b-c: flagship stream and determinism
# ---------------------------------------------------------------------------

def stream_setup(size: dict, frames: int, max_kf: int = 64,
                 max_mp: int = 16384, lc: bool = True,
                 orbit_frac: float = 1.25) -> dict:
    import bench

    argv = ["--frames", str(frames), "--orbit-frac", str(orbit_frac),
            "--max-kf", str(max_kf), "--max-mp", str(max_mp)]
    if not lc:
        argv.append("--no-lc")
    return bench.setup(bench.parse_args(argv), **size)


def phase_stream(s: dict, tr=None, seed: int = 0) -> dict:
    """Stream the sequence through `tr` (or a fresh tracker) with push,
    block and get_trajectory; counters, ATE and wall seconds."""
    import bench

    t0 = time.perf_counter()
    tr = bench.run_stream(s, seed, tr)
    wall = time.perf_counter() - t0
    times, R, p = tr.get_trajectory()
    acc = bench.accuracy(tr, s)
    return dict(tracker=tr, wall_s=wall, traj=(times, R, p), **acc)


def step_memory(tr, s: dict) -> dict:
    """Device memory of the compiled per-frame program, and the device's
    peak bytes in use so far (None where the backend keeps no stats)."""
    import jax

    t, samples = s["frame_imu"][0]
    ma = tr.lower_step(s["frames"][0], t, samples).compile()
    ma = ma.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    out = {f: int(getattr(ma, f)) for f in fields if hasattr(ma, f)}
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return out


def same_trajectory(a: dict, b: dict) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a["traj"], b["traj"]))


# ---------------------------------------------------------------------------
# phase d: facade
# ---------------------------------------------------------------------------

def phase_facade(size: dict, out_path: str, n_frames: int = 20) -> dict:
    """README quick start: System(IMU_MULTI) over rendered frames of a
    2-camera stereo rig, then save_trajectory_tum."""
    from openmavis_jax.geometry import cameras
    from openmavis_jax.io import settings, synthetic, trajectory
    from openmavis_jax.pipeline.system import Sensor, System

    w, h = size["w"], size["h"]
    f = 380.0 * w / 640
    cfg = settings.example_settings(n_cams=2)
    cfg["Camera"].update(width=w, height=h, fps=20.0)
    cfg["ORBextractor"].update(nFeatures=size["n_features"],
                               nLevels=size["n_levels"])
    baseline = 0.2
    for i, x in ((1, 0.0), (2, baseline)):
        T = np.eye(4)
        T[0, 3] = x
        cfg[f"Camera{i}"].update(fx=f, fy=f, cx=w / 2, cy=h / 2,
                                 T_b_c=T.tolist())
    slam = System(cfg, Sensor.IMU_MULTI)

    dt = 1.0 / 20.0
    R_wb, t_wb = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=0.08)
    world = synthetic.BlobWorld.create(seed=5, n=3000)
    params = np.array([f, f, w / 2, h / 2, 0, 0, 0, 0], np.float32)
    cams = []
    for x in (0.0, baseline):
        c_b = np.array([x, 0.0, 0.0])
        cams.append(synthetic.render_sequence(
            world, cameras.PINHOLE, params, R_wb,
            t_wb + np.einsum("tij,j->ti", R_wb, c_b), w, h))
    frames = np.stack(cams, axis=1).astype(np.float32)
    imu = synthetic.imu_from_trajectory(R_wb, t_wb, dt, rate_mult=10)
    k = 0
    t0 = time.perf_counter()
    for i in range(n_frames):
        t = i * dt
        batch = []
        while k < len(imu) and imu[k][2] <= t + 1e-9:
            batch.append(imu[k])
            k += 1
        slam.track_multi(frames[i], t, imu_samples=batch)
    wall = time.perf_counter() - t0
    slam.save_trajectory_tum(out_path)
    times, pos, _ = trajectory.load_tum(out_path)
    return dict(lines=len(times), finite=bool(np.isfinite(pos).all()),
                state=int(slam.tracking_state()), wall_s=wall)


# ---------------------------------------------------------------------------
# phase e: GPU-only tests
# ---------------------------------------------------------------------------

def phase_gpu_tests() -> int:
    import pytest

    return int(pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                            os.path.join(ROOT, "tests", "test_gpu.py")]))


# ---------------------------------------------------------------------------
# phase f: four cards
# ---------------------------------------------------------------------------

def _max_kf_delta(m_a, m_b) -> float:
    n = int(m_a.n_kf)
    return float(np.abs(np.asarray(m_a.kf_t)[:n]
                        - np.asarray(m_b.kf_t)[:n]).max())


def four_card_stream(size=None, frames: int = 48) -> dict:
    """The short stream whose tracker state phase f's inertial solve
    starts from."""
    return stream_setup(size or STEREO_HALF, frames, max_kf=32, max_mp=8192,
                        lc=False, orbit_frac=0.3)


def save_four_card_state(path: str, size=None, frames: int = 48) -> dict:
    """Stream four_card_stream() on device 0 and save the tracker's map and
    carry to `path` (npz), for `--four-cards --state path`."""
    import jax

    st = phase_stream(four_card_stream(size, frames))
    tr = st["tracker"]
    np.savez_compressed(path, *jax.device_get(
        jax.tree.leaves((tr.map, tr.carry))))
    return st


def load_four_card_state(s: dict, path: str):
    """A tracker for stream `s` holding the map and carry saved at `path`."""
    import jax
    import bench

    tr = bench.new_tracker(s)
    treedef = jax.tree.structure((tr.map, tr.carry))
    with np.load(path) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    tr.map, tr.carry = jax.tree.unflatten(treedef, jax.device_put(leaves))
    return tr


def _four_devices() -> list:
    import jax

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"needs 4 devices, found {len(devs)}")
    return devs[:4]


def phase_four_cards_atlas(atlas=(128, 32768, 512)) -> dict:
    """The product path tracking.distributed_global_ba_step on a 4-device
    mesh against a 1-device mesh, on the Atlas-scale problem (K keyframes,
    M landmarks, K x obs_per_kf observations)."""
    import jax

    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    from openmavis_jax.parallel import dist_ba
    from openmavis_jax.pipeline import tracking as trk

    devs = _four_devices()
    K, M, opk = atlas
    rig, state0, obs, _ = ge._ba_problem(K=K, M=M, obs_per_kf=opk)
    m = ge._map_from_problem(state0, obs, rig)
    res = {}
    for n in (4, 1):
        mesh = dist_ba.make_mesh(devs[:n])

        def solve():
            m2, chi = trk.distributed_global_ba_step(
                m, rig.kind, rig, mesh, stages=(2,), cg_iters=8)
            jax.block_until_ready(m2.kf_t)
            return m2, chi

        t0 = time.perf_counter()
        solve()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        m2, chi = solve()
        res[n] = (m2, float(chi), first, time.perf_counter() - t0)
    return dict(
        K=K, M=M, obs=K * opk,
        max_kf_delta_m=_max_kf_delta(res[4][0], res[1][0]),
        moved_m=_max_kf_delta(res[1][0], m),
        chi2={n: res[n][1] for n in res},
        first_s={n: res[n][2] for n in res},
        warm_s={n: res[n][3] for n in res})


def phase_four_cards_inertial(stream_size=None, stream_frames: int = 48,
                              state: str | None = None) -> dict:
    """The inertial StreamingVITracker.run_global_ba(mesh=4) against
    mesh=1 from one tracker state, streamed on device 0 or loaded from
    `state` (written by save_four_card_state)."""
    import jax

    _four_devices()
    s = four_card_stream(stream_size, stream_frames)
    if state is not None:
        tr = load_four_card_state(s, state)
    else:
        tr = phase_stream(s)["tracker"]
    saved = (tr.map, tr.carry)
    imu_ok = bool(tr.snapshot()["imu_ok"])
    maps = {}
    for n in (4, 1):
        tr.map, tr.carry = saved
        t0 = time.perf_counter()
        chi = tr.run_global_ba(mesh=n)
        jax.block_until_ready(tr.map.kf_t)
        maps[n] = (tr.map, float(chi), time.perf_counter() - t0)
    return dict(
        n_kf=int(saved[0].n_kf), imu_initialized=imu_ok,
        from_saved_state=state is not None,
        max_kf_delta_m=_max_kf_delta(maps[4][0], maps[1][0]),
        moved_m=_max_kf_delta(maps[1][0], saved[0]),
        chi2={n: maps[n][1] for n in maps},
        first_s={n: maps[n][2] for n in maps})


# ---------------------------------------------------------------------------

def _require_gpu():
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"{d.platform} ({d.device_kind})")
    return jax


def main(argv=None) -> int:
    global _CARD
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--four-cards", action="store_true",
                   help="run only phase f (needs four GPUs)")
    p.add_argument("--state", metavar="NPZ",
                   help="phase f: load the inertial solve's tracker state "
                   "from NPZ (written by save_four_card_state) instead of "
                   "streaming it")
    args = p.parse_args(argv)

    # the package sets its XLA flags on import, before JAX brings up the GPU
    sys.path.insert(0, ROOT)
    import openmavis_jax
    jax = _require_gpu()

    import bench

    _CARD = bench.card_name_and_power_limit()
    devs = jax.devices()
    log(f"card: {_CARD}; jax {jax.__version__}; {len(devs)} x "
        f"{devs[0].device_kind}; compile cache "
        f"{openmavis_jax.compile_cache_dir()}; XLA_FLAGS "
        f"{os.environ.get('XLA_FLAGS', '')!r}")
    compiles = CompileTimes()
    jax.monitoring.register_event_duration_secs_listener(compiles)
    count = len(devs)

    if args.four_cards:
        a = phase_four_cards_atlas()
        log(f"f. atlas GBA K={a['K']} M={a['M']} obs={a['obs']}: "
            f"4-card vs 1-card max keyframe delta {a['max_kf_delta_m']:.3e}"
            f" m (tol {FOUR_CARD_TOL_M} m; the solve moved keyframes by up "
            f"to {a['moved_m']:.3e} m); chi2 {a['chi2']}; first call "
            f"s {a['first_s']}; warm s {a['warm_s']}")
        i = phase_four_cards_inertial(state=args.state)
        log(f"f. inertial run_global_ba over {i['n_kf']} KFs "
            f"(imu init {i['imu_initialized']}, saved state "
            f"{i['from_saved_state']}): max keyframe delta "
            f"{i['max_kf_delta_m']:.3e} m (moved up to {i['moved_m']:.3e} "
            f"m); chi2 {i['chi2']}; "
            f"s {i['first_s']}")
        if (a["max_kf_delta_m"] > FOUR_CARD_TOL_M
                or i["max_kf_delta_m"] > FOUR_CARD_TOL_M
                or not (a["moved_m"] > 0 and i["moved_m"] > 0)
                or not i["imu_initialized"]):
            raise SystemExit("phase f: 4-card and 1-card GBA disagree")
        log(f"compile: {compiles.report()}")
        count = 4
    else:
        # b needs its tracker traced first: a reads the shapes from it
        s = stream_setup(FLAGSHIP, 160)
        tr = bench.new_tracker(s)
        shapes = step_match_shapes(tr, s)
        log(f"a. match shapes in the per-frame program (queries, "
            f"targets, mutual): {shapes}")
        for r in phase_matcher(shapes):
            log(f"a. match {r['shape'][0]}x{r['shape'][1]} "
                f"mutual={r['mutual']}: bit-exact vs numpy popcount "
                f"{r['exact']}; {r['ms']:.3f} ms/call")
            if not r["exact"]:
                raise SystemExit("phase a: matcher differs from reference")

        b = phase_stream(s, tr)
        log(f"b. flagship stream: {b['frames_tracked']}/160 tracked, "
            f"{b['n_keyframes']} KFs, {b['n_landmarks']} landmarks, "
            f"{b['loop_closures']} loop closures, IMU init "
            f"{b['imu_initialized']} (VIBA stage {b['viba_stage']}), ATE "
            f"scaled {b['ate_rmse_m']:.4f} m / unscaled "
            f"{b['ate_rmse_noscale_m']:.4f} m (scale {b['horn_scale']:.4f})"
            f"; cold wall {b['wall_s']:.1f} s")
        log(f"b. compile: {compiles.report()}")
        log(f"b. per-frame program memory: {step_memory(tr, s)}")
        if not (b["frames_tracked"] >= MIN_TRACKED
                and b["loop_closures"] >= 1 and b["imu_initialized"]
                and b["ate_rmse_m"] <= MAX_ATE_M):
            raise SystemExit("phase b: gates not met")

        c = phase_stream(s)
        log(f"c. same seed again: bit-identical trajectory "
            f"{same_trajectory(b, c)}; scaled ATE {c['ate_rmse_m']:.4f} m;"
            f" warm {c['wall_s'] / 160 * 1e3:.2f} ms/frame (smoke figure,"
            f" not a benchmark)")

        with tempfile.TemporaryDirectory() as d:
            fd = phase_facade(FLAGSHIP, os.path.join(d, "traj.txt"))
        log(f"d. facade System(IMU_MULTI) 2 cams: {fd['lines']} poses "
            f"saved, finite {fd['finite']}, tracking state {fd['state']},"
            f" {fd['wall_s']:.1f} s; compile so far: {compiles.report()}")
        if fd["lines"] != 20 or not fd["finite"]:
            raise SystemExit("phase d: facade trajectory incomplete")

        rc = phase_gpu_tests()
        log(f"e. gpu tests: pytest exit {rc}")
        if rc != 0:
            raise SystemExit("phase e: gpu tests failed")
        cache = openmavis_jax.compile_cache_dir()
        log(f"compile cache {cache}: "
            f"{len(os.listdir(cache)) if os.path.isdir(cache) else 0} "
            f"entries")

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
