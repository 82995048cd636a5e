"""Distributed bundle adjustment over a device mesh.

The reference has no distributed anything (SURVEY.md §2.3: 3 threads +
mutexes); this is the new capability this build adds per BASELINE.json's
north star: map optimization sharded over a `jax.sharding.Mesh` with XLA
collectives (NCCL over NVLink between the GPUs of one host).

Scheme (data-parallel BA): observations are sharded across the mesh axis,
keyframe/landmark state is replicated; each device assembles the normal-
equation contributions of its observation shard; one `psum` reduces the
Schur system; the (small, dense) reduced camera solve is computed
redundantly on every device. This parallelizes the dominant cost —
residual/Jacobian evaluation and Hessian assembly — with a single collective
per LM iteration.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..optim import ba

# Every wrapper below builds its shard_map program through an lru_cache
# keyed by (mesh, static config) and wraps it in jax.jit: without this,
# each call re-traced an UNJITTED shard_map — measured 120x slower than
# the jitted program on the 8-device CPU mesh (17.4 s vs 141 ms for the
# Atlas-scale GBA).


def make_mesh(devices=None, axis: str = "obs") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _pad_obs(obs: ba.BAObservations, n_dev: int):
    o = obs.kf.shape[0]
    pad = (-o) % n_dev
    if pad == 0:
        return obs
    def padd(x, val=0):
        w = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, w, constant_values=val)
    return ba.BAObservations(
        kf=padd(obs.kf), mp=padd(obs.mp), cam=padd(obs.cam),
        uv=padd(obs.uv), sigma2=padd(obs.sigma2, 1),
        valid=padd(obs.valid, False))


_PROG_CACHE: dict = {}


def _cached_program(kind: str, mesh: Mesh, axis: str, key_extra,
                    build):
    key = (kind, mesh, axis, key_extra)
    fn = _PROG_CACHE.get(key)
    if fn is None:
        fn = jax.jit(build())
        _PROG_CACHE[key] = fn
    return fn


def _specs(state, obs_like, rig, point_fixed, edges, prior, axis,
           points_sharded: bool = False):
    rep = P()
    obs_spec = ba.BAObservations(
        kf=P(axis), mp=P(axis), cam=P(axis), uv=P(axis),
        sigma2=P(axis), valid=P(axis))
    if points_sharded:
        state_spec = ba.BAState(R=rep, t=rep, v=rep, bg=rep, ba=rep,
                                points=P(axis))
        pf_spec = P(axis) if point_fixed is not None else None
    else:
        state_spec = jax.tree.map(lambda _: rep, state)
        pf_spec = rep if point_fixed is not None else None
    rig_spec = jax.tree.map(lambda _: rep, rig)
    edges_spec = (None if edges is None
                  else jax.tree.map(lambda _: rep, edges))
    prior_spec = (None if prior is None
                  else jax.tree.map(lambda _: rep, prior))
    return state_spec, obs_spec, rig_spec, pf_spec, edges_spec, prior_spec


def distributed_bundle_adjust(mesh: Mesh, state: ba.BAState,
                              obs: ba.BAObservations, rig,
                              pose_fixed, point_fixed=None,
                              edges=None, prior=None, prior_idx: int = 0,
                              stages=(5, 10), axis: str = "obs"):
    """Run window BA with observations sharded across `mesh`.

    Returns (state, obs_inlier (original length), chi).
    """
    n_dev = mesh.devices.size
    o_orig = obs.kf.shape[0]
    obs_p = _pad_obs(obs, n_dev)

    (state_spec, obs_spec, rig_spec, pf_spec, edges_spec,
     prior_spec) = _specs(state, obs_p, rig, point_fixed, edges, prior,
                          axis)

    def build():
        def run(state, obs_shard, rig, pose_fixed, point_fixed, edges,
                prior):
            return ba.bundle_adjust(
                state, obs_shard, rig, pose_fixed,
                point_fixed=point_fixed, edges=edges, prior=prior,
                prior_idx=prior_idx, stages=stages, psum_axis=axis)

        return shard_map(
            run, mesh=mesh,
            in_specs=(state_spec, obs_spec, rig_spec, P(),
                      pf_spec, edges_spec, prior_spec),
            out_specs=(state_spec, P(axis), P()))

    fn = _cached_program(
        "window", mesh, axis,
        (stages, prior_idx, point_fixed is not None, edges is not None,
         prior is not None), build)
    st, inl, chi = fn(state, obs_p, rig, pose_fixed, point_fixed, edges,
                      prior)
    return st, inl[:o_orig], chi


def shard_observations_by_landmark(obs: ba.BAObservations, M: int,
                                   n_dev: int):
    """Bucket observations by their landmark's owner device (BLOCK
    partition: landmark m lives on device m // (M/n_dev)), pad buckets to
    a common length, and remap mp to OWNER-LOCAL ids.

    Returns (obs_bucketed [n_dev*O_loc], perm [n_dev*O_loc] original
    observation index or -1 for padding). Host-side numpy prep.
    """
    assert M % n_dev == 0
    M_loc = M // n_dev
    mp = np.asarray(obs.mp)
    valid = np.asarray(obs.valid)
    owner = np.clip(mp, 0, M - 1) // M_loc
    owner = np.where(valid, owner, -1)
    buckets = [np.nonzero(owner == d)[0] for d in range(n_dev)]
    # padding rows also carry the leftover (invalid) observations so no
    # data is dropped; they stay valid=False
    rest = np.nonzero(owner < 0)[0]
    O_loc = max(int(np.ceil((max(len(b) for b in buckets) if buckets
                             else 1))), 1)
    O_loc = max(O_loc, int(np.ceil(len(rest) / max(n_dev, 1))))
    idx = np.full((n_dev, O_loc), -1, np.int64)
    for d in range(n_dev):
        idx[d, :len(buckets[d])] = buckets[d]
    # distribute leftover invalid rows round-robin into the padding
    slots = np.nonzero(idx < 0)
    take = min(len(rest), len(slots[0]))
    idx[slots[0][:take], slots[1][:take]] = rest[:take]

    flat = idx.reshape(-1)
    safe = np.maximum(flat, 0)

    def gather(x, fill=0):
        g = np.asarray(x)[safe]
        return np.where((flat >= 0).reshape((-1,) + (1,) * (g.ndim - 1)),
                        g, fill)

    mp_g = gather(mp)
    valid_g = gather(valid, False) & (flat >= 0)
    mp_local = np.where(valid_g, mp_g % M_loc, 0)
    obs_b = ba.BAObservations(
        kf=jnp.asarray(gather(obs.kf)), mp=jnp.asarray(mp_local),
        cam=jnp.asarray(gather(obs.cam)),
        uv=jnp.asarray(gather(obs.uv)),
        sigma2=jnp.asarray(gather(np.asarray(obs.sigma2), 1.0)),
        valid=jnp.asarray(valid_g))
    return obs_b, flat


def distributed_global_ba_lsharded(mesh: Mesh, state: ba.BAState,
                                   obs: ba.BAObservations, rig,
                                   pose_fixed, point_fixed=None,
                                   edges=None, prior=None,
                                   prior_idx: int = 0,
                                   stages=(5, 10), cg_iters: int = 24,
                                   axis: str = "obs"):
    """Landmark-SHARDED Atlas-scale global BA: `state.points`, the
    landmark Hessian blocks Hll, and the observation table are partitioned
    over the mesh (landmark m owned by device m // (M/n_dev)); pose state
    stays replicated. Per CG matvec only one [K, D] psum crosses devices —
    the [M,3,3]/[M,3] landmark reductions of the replicated scheme
    disappear, and landmark memory scales 1/n_dev (map state no longer
    replicates).

    Returns (state, obs_inlier (original length), chi).
    """
    from ..optim import global_ba

    n_dev = mesh.devices.size
    o_orig = obs.kf.shape[0]
    M = state.points.shape[0]
    pad_m = (-M) % n_dev
    if pad_m:
        state = state._replace(points=jnp.pad(state.points,
                                              ((0, pad_m), (0, 0))))
        if point_fixed is not None:
            point_fixed = jnp.pad(point_fixed, (0, pad_m),
                                  constant_values=True)
    Mp = M + pad_m
    obs_b, perm = shard_observations_by_landmark(obs, Mp, n_dev)

    (state_spec, obs_spec, rig_spec, pf_spec, edges_spec,
     prior_spec) = _specs(state, obs_b, rig, point_fixed, edges, prior,
                          axis, points_sharded=True)

    def build():
        def run(state, obs_shard, rig, pose_fixed, point_fixed, edges,
                prior):
            return global_ba.global_bundle_adjust(
                state, obs_shard, rig, pose_fixed,
                point_fixed=point_fixed, edges=edges, prior=prior,
                prior_idx=prior_idx, stages=stages, cg_iters=cg_iters,
                psum_axis=axis, points_local=True)

        return shard_map(
            run, mesh=mesh,
            in_specs=(state_spec, obs_spec, rig_spec, P(),
                      pf_spec, edges_spec, prior_spec),
            out_specs=(state_spec, P(axis), P()))

    fn = _cached_program(
        "lsharded", mesh, axis,
        (stages, cg_iters, prior_idx, point_fixed is not None,
         edges is not None, prior is not None), build)
    st, inl_b, chi = fn(state, obs_b, rig, pose_fixed, point_fixed,
                        edges, prior)
    st = st._replace(points=st.points[:M])
    # un-permute inliers back to the original observation order
    inl = jnp.zeros((o_orig,), bool)
    keep = perm >= 0
    inl = inl.at[np.maximum(perm, 0)].max(
        jnp.where(jnp.asarray(keep), inl_b, False))
    return st, inl, chi


def distributed_global_ba(mesh: Mesh, state: ba.BAState,
                          obs: ba.BAObservations, rig,
                          pose_fixed, point_fixed=None,
                          edges=None, prior=None, prior_idx: int = 0,
                          stages=(5, 10), cg_iters: int = 24,
                          axis: str = "obs"):
    """Atlas-scale global BA sharded over the mesh (the BASELINE.json
    north-star workload: distributed Schur reduction across devices).

    Observations are sharded; keyframe/landmark state is replicated. Each
    device evaluates residual/Jacobian terms and gather/scatter matvec
    passes for its observation shard; one psum per CG matvec reduces a
    [K, D] vector across devices (see optim/global_ba.py). The reduced solve
    itself (PCG iterations) is replicated arithmetic on identical psummed
    operands, so all devices walk the same trajectory deterministically.

    Returns (state, obs_inlier (original length), chi).
    """
    from ..optim import global_ba

    n_dev = mesh.devices.size
    o_orig = obs.kf.shape[0]
    obs_p = _pad_obs(obs, n_dev)

    (state_spec, obs_spec, rig_spec, pf_spec, edges_spec,
     prior_spec) = _specs(state, obs_p, rig, point_fixed, edges, prior,
                          axis)

    def build():
        def run(state, obs_shard, rig, pose_fixed, point_fixed, edges,
                prior):
            return global_ba.global_bundle_adjust(
                state, obs_shard, rig, pose_fixed,
                point_fixed=point_fixed, edges=edges, prior=prior,
                prior_idx=prior_idx, stages=stages, cg_iters=cg_iters,
                psum_axis=axis)

        return shard_map(
            run, mesh=mesh,
            in_specs=(state_spec, obs_spec, rig_spec, P(),
                      pf_spec, edges_spec, prior_spec),
            out_specs=(state_spec, P(axis), P()))

    fn = _cached_program(
        "replicated_gba", mesh, axis,
        (stages, cg_iters, prior_idx, point_fixed is not None,
         edges is not None, prior is not None), build)
    st, inl, chi = fn(state, obs_p, rig, pose_fixed, point_fixed, edges,
                      prior)
    return st, inl[:o_orig], chi
