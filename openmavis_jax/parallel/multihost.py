"""Multi-host (multi-process) scale-out for the distributed optimizers.

The single-host mesh in `dist_ba.py` shards over one process's devices
(NVLink collectives). Scaling past one host (BASELINE.json north star:
>=75% efficiency at 2+ hosts) means a mesh spanning processes, with XLA
routing the same collectives over the network between hosts.

Design: nothing in the solver code changes. `jax.distributed`
makes every process see the GLOBAL device list; the mesh is built over
all of them; `shard_map` programs written against the mesh axis are
oblivious to the host boundary — XLA and NCCL split each `psum` into an
intra-host stage and an inter-host stage. The only additions a
multi-process launch needs are (1) runtime initialization and (2)
assembling global arrays from per-process shards, both below.

(The reference is a single-process C++ system — 3 threads + mutexes,
SURVEY.md §2.3 — so there is no reference call stack to cite; this is
the new capability this build adds.)

Validated by `scripts/dryrun_multihost.py`: two local processes, each
with N virtual CPU devices, form one 2N-device global mesh and run the
landmark-sharded GBA; the driver-visible artifact records agreement with
the single-process solve.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_initialized = False


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join (or start) the distributed runtime. Safe to call once per
    process before any jax computation.

    With no arguments, defers to jax's environment auto-detection (a
    cluster manager such as SLURM provides it). Explicit arguments support
    manual launches: coordinator "host:port", total process count, and
    this process's rank — a bare GPU machine needs them.
    """
    global _initialized
    if _initialized:
        return
    kw = {}
    if coordinator is not None:
        kw = dict(coordinator_address=coordinator,
                  num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kw)
    _initialized = True


def global_mesh(axis: str = "obs") -> Mesh:
    """Mesh over ALL devices of ALL processes (jax.devices() is global
    after initialize()). Device order groups each process's devices
    contiguously, so a sharded axis maps: leading shards -> host 0's
    devices, later shards -> host 1, ... and only the collective's
    reduction stage crosses the network."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def host_local_to_global(mesh: Mesh, spec: P, local_batches):
    """Assemble a globally-sharded array from per-process host data.

    Each process passes its OWN slice (e.g. the observation rows its
    local data loader produced); the result is one logical array sharded
    over the mesh axis, ready for the dist_ba entry points. Wraps
    jax.make_array_from_process_local_data.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            sharding, np.asarray(x)), local_batches)


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()
