#!/usr/bin/env python
"""Twin-process multi-host dryrun: two local processes, each with N
virtual CPU devices, join one jax.distributed runtime, build a single
2N-device global mesh, and run the landmark-sharded distributed GBA
(parallel/dist_ba.py) over it.

This validates the MULTI-PROCESS code path (runtime init, global mesh,
process-local -> global array assembly, cross-process collectives) that
real 2-host scale-out uses — the only thing it cannot measure is
the real inter-host bandwidth. Run:

    python scripts/dryrun_multihost.py            # launcher
    (spawns itself twice with _RANK=0/1)

Prints one JSON line with agreement stats vs the single-process solve.
"""

import json
import os
import subprocess
import sys

N_LOCAL = 4          # virtual devices per process
PORT = 47551


def worker(rank: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={N_LOCAL}")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import jax
    # gloo collectives carry the cross-process psum between the CPU
    # processes (on GPUs, NCCL carries it)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    import jax.numpy as jnp

    from openmavis_jax.parallel import multihost
    multihost.initialize(coordinator=f"localhost:{PORT}",
                         num_processes=2, process_id=rank)
    assert jax.process_count() == 2
    assert len(jax.devices()) == 2 * N_LOCAL, len(jax.devices())

    from jax.sharding import PartitionSpec as P
    from openmavis_jax.optim import ba
    from openmavis_jax.parallel import dist_ba

    # synthetic GBA problem (same generator as __graft_entry__'s dryrun,
    # scaled down): K keyframes, M landmarks, O observations
    K, M, O = 32, 4096, 8192
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, K, endpoint=False)
    pos = np.stack([6 * np.cos(t), 6 * np.sin(t), np.zeros(K)], -1)
    pts = rng.uniform(-8, 8, (M, 3)).astype(np.float32)
    pts[:, 2] += 12.0
    kf_i = rng.integers(0, K, O)
    mp_i = rng.integers(0, M, O)

    z3 = jnp.zeros((K, 3))
    state = ba.BAState(
        R=jnp.tile(jnp.eye(3), (K, 1, 1)),
        t=jnp.asarray(pos, jnp.float32),
        v=z3, bg=z3, ba=z3,
        points=jnp.asarray(pts))
    params = jnp.asarray([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0])
    from openmavis_jax.optim.reprojection import RigParams
    rig = RigParams(kind=0, params=params[None],
                    R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))
    # project ground truth to synth observations
    p_c = jnp.einsum("oij,oj->oi",
                     jnp.swapaxes(state.R[kf_i], -1, -2),
                     state.points[mp_i] - state.t[kf_i])
    z = jnp.maximum(p_c[:, 2], 1e-3)
    uv = params[:2] * p_c[:, :2] / z[:, None] + params[2:4]
    obs = ba.BAObservations(
        kf=jnp.asarray(kf_i, jnp.int32), mp=jnp.asarray(mp_i, jnp.int32),
        uv=uv + 0.2 * jnp.asarray(rng.normal(size=(O, 2)), jnp.float32),
        sigma2=jnp.ones((O,)), cam=jnp.zeros((O,), jnp.int32),
        valid=(z > 0.1))

    # perturb the state; both processes hold identical host copies
    state_p = state._replace(
        t=state.t + 0.05 * jnp.asarray(rng.normal(size=(K, 3)),
                                       jnp.float32),
        points=state.points + 0.05 * jnp.asarray(
            rng.normal(size=(M, 3)), jnp.float32))

    mesh = multihost.global_mesh("obs")
    pose_fixed = jnp.zeros((K,), bool).at[0].set(True)
    out, _, chi = dist_ba.distributed_global_ba_lsharded(
        mesh, state_p, obs, rig, pose_fixed, stages=(3, 6),
        cg_iters=12)
    chi = float(chi)
    dt = float(jnp.abs(out.t - state.t).max())

    # ground truth for the multi-PROCESS path: the identical solve on a
    # process-LOCAL mesh (all-addressable devices, no cross-process
    # collective). Agreement means the cross-process psum changed
    # nothing.
    mesh_l = dist_ba.make_mesh(jax.local_devices(), "obs")
    out_l, _, chi_l = dist_ba.distributed_global_ba_lsharded(
        mesh_l, state_p, obs, rig, pose_fixed, stages=(3, 6),
        cg_iters=12)
    d_cross = float(np.abs(np.asarray(out.t)
                           - np.asarray(out_l.t)).max())

    if rank == 0:
        print(json.dumps({
            "metric": "multihost_dryrun",
            "processes": 2, "devices": 2 * N_LOCAL,
            "chi2": round(chi, 3), "chi2_local": round(float(chi_l), 3),
            "max_abs_t_err_m": round(dt, 4),
            "cross_vs_local_t_m": round(d_cross, 6),
            "ok": bool(np.isfinite(chi) and d_cross < 1e-3
                       and dt < 0.1),
        }), flush=True)


def main():
    if os.environ.get("_MH_RANK") is not None:
        worker(int(os.environ["_MH_RANK"]))
        return
    procs = []
    for rank in range(2):
        env = dict(os.environ, _MH_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=None if rank == 0 else subprocess.DEVNULL))
    rcs = [p.wait(timeout=600) for p in procs]
    sys.exit(max(map(abs, rcs)))


if __name__ == "__main__":
    main()
