"""Device-resident SLAM map: fixed-capacity structure-of-arrays slabs.

JAX replacement for the reference's pointer-graph map data model
(reference: src/Map.cc KF/MP sets + mMutexMapUpdate, src/KeyFrame.cc
covisibility graph, src/MapPoint.cc observation map). Instead of heap
objects with mutexes:

* keyframes and landmarks live in pre-allocated arrays with validity masks;
* the observation structure is the per-keyframe feature table `kf_obs`
  ([K, F] landmark id or -1) — the transpose of the reference's
  `MapPoint::mObservations` map (MapPoint.h:117-123);
* "deletion" is flag-clearing (`SetBadFlag` equivalents);
* every mutation is a pure function old-state -> new-state, jit-compiled;
  the single-writer step sequence replaces the big map lock;
* the covisibility graph is not stored — it is *computed* on demand from
  the observation table with one matmul (`covisibility_matrix`), replacing
  KeyFrame::UpdateConnections incremental bookkeeping.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import bow


class MapState(NamedTuple):
    # --- keyframes ---
    kf_R: jnp.ndarray        # [K,3,3] world-from-body rotation
    kf_t: jnp.ndarray        # [K,3]
    kf_v: jnp.ndarray        # [K,3] velocity (inertial)
    kf_bg: jnp.ndarray       # [K,3]
    kf_ba: jnp.ndarray       # [K,3]
    kf_time: jnp.ndarray     # [K]
    kf_valid: jnp.ndarray    # [K] bool
    # --- per-keyframe features ---
    kf_xy: jnp.ndarray       # [K,F,2]
    kf_desc: jnp.ndarray     # [K,F,256] int8 {0,1}
    kf_level: jnp.ndarray    # [K,F] int32
    kf_sigma2: jnp.ndarray   # [K,F]
    kf_cam: jnp.ndarray      # [K,F] int32 camera band
    kf_feat_valid: jnp.ndarray  # [K,F] bool
    kf_obs: jnp.ndarray      # [K,F] int32 map-point id or -1
    # BoW place-recognition signature (slam_map/bow.py): written once at
    # insertion, scored in O(K*W) at retrieval — the device KFDB
    # (reference: KeyFrameDatabase's per-KF BowVector, KeyFrame.h:mBowVec)
    kf_bow: jnp.ndarray      # [K, bow.W] int8 bucket counts
    # --- landmarks ---
    mp_pos: jnp.ndarray      # [M,3]
    mp_desc: jnp.ndarray     # [M,256] int8 distinctive descriptor
    mp_normal: jnp.ndarray   # [M,3] mean viewing direction
    mp_dmin: jnp.ndarray     # [M] scale-invariance range
    mp_dmax: jnp.ndarray     # [M]
    mp_valid: jnp.ndarray    # [M] bool
    mp_visible: jnp.ndarray  # [M] int32 times predicted visible
    mp_found: jnp.ndarray    # [M] int32 times matched
    mp_first_kf: jnp.ndarray  # [M] int32
    mp_last_kf: jnp.ndarray   # [M] int32 most recent observing keyframe
    # --- persistent loop/merge edges ---
    # Accepted loop-closure constraints survive in the map so every later
    # essential-graph solve re-includes them (reference: KeyFrame's
    # permanent mspLoopEdges/mspMergeEdges, KeyFrame.h:216-243, consumed
    # by OptimizeEssentialGraph src/Optimizer.cc:1826). Topology only —
    # like the reference, the edge measurement is re-derived from the
    # current (already corrected) poses at solve time.
    loop_i: jnp.ndarray      # [L] int32 endpoint slot (-1 = free)
    loop_j: jnp.ndarray      # [L] int32
    loop_valid: jnp.ndarray  # [L] bool
    # --- counters ---
    n_kf: jnp.ndarray        # [] int32
    n_mp: jnp.ndarray        # [] int32
    n_loop: jnp.ndarray      # [] int32 total edges ever accepted


MAX_LOOP_EDGES = 16


def allocate(max_kf: int, max_feat: int, max_mp: int,
             dtype=jnp.float32) -> MapState:
    K, F, M = max_kf, max_feat, max_mp
    return MapState(
        kf_R=jnp.tile(jnp.eye(3, dtype=dtype), (K, 1, 1)),
        kf_t=jnp.zeros((K, 3), dtype),
        kf_v=jnp.zeros((K, 3), dtype),
        kf_bg=jnp.zeros((K, 3), dtype),
        kf_ba=jnp.zeros((K, 3), dtype),
        kf_time=jnp.zeros((K,), dtype),
        kf_valid=jnp.zeros((K,), bool),
        kf_xy=jnp.zeros((K, F, 2), dtype),
        kf_desc=jnp.zeros((K, F, 256), jnp.int8),
        kf_level=jnp.zeros((K, F), jnp.int32),
        kf_sigma2=jnp.ones((K, F), dtype),
        kf_cam=jnp.zeros((K, F), jnp.int32),
        kf_feat_valid=jnp.zeros((K, F), bool),
        kf_obs=jnp.full((K, F), -1, jnp.int32),
        kf_bow=jnp.zeros((K, bow.W), jnp.int8),
        mp_pos=jnp.zeros((M, 3), dtype),
        mp_desc=jnp.zeros((M, 256), jnp.int8),
        mp_normal=jnp.zeros((M, 3), dtype),
        mp_dmin=jnp.zeros((M,), dtype),
        mp_dmax=jnp.full((M,), 1e9, dtype),
        mp_valid=jnp.zeros((M,), bool),
        mp_visible=jnp.zeros((M,), jnp.int32),
        mp_found=jnp.zeros((M,), jnp.int32),
        mp_first_kf=jnp.zeros((M,), jnp.int32),
        mp_last_kf=jnp.zeros((M,), jnp.int32),
        loop_i=jnp.full((MAX_LOOP_EDGES,), -1, jnp.int32),
        loop_j=jnp.full((MAX_LOOP_EDGES,), -1, jnp.int32),
        loop_valid=jnp.zeros((MAX_LOOP_EDGES,), bool),
        n_kf=jnp.zeros((), jnp.int32),
        n_mp=jnp.zeros((), jnp.int32),
        n_loop=jnp.zeros((), jnp.int32),
    )


def add_loop_edge(m: MapState, i, j) -> MapState:
    """Record an accepted loop/merge constraint between keyframe slots
    (ring buffer over MAX_LOOP_EDGES; jit-safe)."""
    L = m.loop_i.shape[0]
    slot = jnp.mod(m.n_loop, L)
    return m._replace(
        loop_i=m.loop_i.at[slot].set(jnp.asarray(i, jnp.int32)),
        loop_j=m.loop_j.at[slot].set(jnp.asarray(j, jnp.int32)),
        loop_valid=m.loop_valid.at[slot].set(True),
        n_loop=m.n_loop + 1)


def covisibility_matrix(m: MapState) -> jnp.ndarray:
    """[K, K] count of shared landmarks between keyframes.

    One incidence matmul replaces KeyFrame::UpdateConnections' per-point
    counting loops (reference: src/KeyFrame.cc). Incidence is built by
    scatter into [K, M] then contracted by one matmul.
    """
    K, F = m.kf_obs.shape
    M = m.mp_pos.shape[0]
    valid_obs = (m.kf_obs >= 0) & m.kf_feat_valid \
        & m.kf_valid[:, None]
    mp = jnp.where(valid_obs, m.kf_obs, M)  # overflow bin
    inc = jnp.zeros((K, M + 1), jnp.bfloat16)
    inc = inc.at[jnp.arange(K)[:, None], mp].max(
        jnp.where(valid_obs, 1.0, 0.0).astype(jnp.bfloat16))
    inc = inc[:, :M]
    cov = jax.lax.dot_general(
        inc, inc, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT).astype(jnp.int32)
    return cov - jnp.diag(jnp.diagonal(cov))


def insert_keyframe(m: MapState, slot, R, t, v, bg, ba, time,
                    xy, desc, level, sigma2, cam, feat_valid,
                    obs) -> MapState:
    """Write a keyframe into `slot` and update landmark statistics.

    `obs` [F]: matched landmark id per feature (-1 = none). Equivalent of
    Tracking::CreateNewKeyFrame + LocalMapping::ProcessNewKeyFrame.
    """
    m = m._replace(
        kf_R=m.kf_R.at[slot].set(R),
        kf_t=m.kf_t.at[slot].set(t),
        kf_v=m.kf_v.at[slot].set(v),
        kf_bg=m.kf_bg.at[slot].set(bg),
        kf_ba=m.kf_ba.at[slot].set(ba),
        kf_time=m.kf_time.at[slot].set(time),
        kf_valid=m.kf_valid.at[slot].set(True),
        kf_xy=m.kf_xy.at[slot].set(xy),
        kf_desc=m.kf_desc.at[slot].set(desc),
        kf_level=m.kf_level.at[slot].set(level),
        kf_sigma2=m.kf_sigma2.at[slot].set(sigma2),
        kf_cam=m.kf_cam.at[slot].set(cam),
        kf_feat_valid=m.kf_feat_valid.at[slot].set(feat_valid),
        kf_obs=m.kf_obs.at[slot].set(obs),
        kf_bow=m.kf_bow.at[slot].set(bow.histogram(desc, feat_valid)),
        n_kf=jnp.maximum(m.n_kf, slot + 1),
    )
    # bump found counters for landmarks observed by this KF
    M = m.mp_pos.shape[0]
    tgt = jnp.where(obs >= 0, obs, M)
    found = jnp.zeros((M + 1,), jnp.int32).at[tgt].add(1)[:M]
    # refresh landmark descriptors from this keyframe's observations —
    # keeps them matchable as the viewpoint drifts. (The reference keeps the
    # min-median-Hamming descriptor over all observations,
    # MapPoint::ComputeDistinctiveDescriptors; latest-observation is the
    # streaming approximation.)
    new_desc = jnp.zeros((M + 1, 256), jnp.int8).at[tgt].set(desc)[:M]
    touched = jnp.zeros((M + 1,), bool).at[tgt].set(obs >= 0)[:M]
    return m._replace(
        mp_found=m.mp_found + found,
        mp_desc=jnp.where(touched[:, None], new_desc, m.mp_desc),
        mp_last_kf=jnp.where(touched, slot, m.mp_last_kf))


def update_mp_geometry(m: MapState, mp_ids: jnp.ndarray,
                       scale: float = 1.2,
                       n_levels: int = 8) -> MapState:
    """Refresh landmark normals and scale-invariance ranges from their
    observing keyframes (reference: MapPoint::UpdateNormalAndDepth).

    Uses the observation table: normal = mean of (pos - kf_center) dirs.
    `mp_ids` may include -1 padding; full refresh is O(K*F) either way, so
    the implementation just refreshes all valid landmarks.
    """
    K, F = m.kf_obs.shape
    M = m.mp_pos.shape[0]
    valid_obs = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    mp = jnp.where(valid_obs, m.kf_obs, M)
    centers = m.kf_t[:, None, :].repeat(F, axis=1)       # [K,F,3]
    dirs = m.mp_pos[jnp.minimum(mp, M - 1)] - centers
    dist = jnp.linalg.norm(dirs, axis=-1)
    dirs = dirs / jnp.maximum(dist[..., None], 1e-9)
    w = valid_obs.astype(m.mp_pos.dtype)

    flat_mp = mp.reshape(-1)
    # one packed scatter-add (dirs + count) — the scatter launch
    # latency over the K*F-row table dominates, not its FLOPs
    acc4 = jnp.zeros((M + 1, 4), m.mp_pos.dtype).at[flat_mp].add(
        jnp.concatenate([(dirs * w[..., None]).reshape(-1, 3),
                         w.reshape(-1, 1)], axis=-1))
    cnt = acc4[:M, 3]
    normal = acc4[:M, :3] / jnp.maximum(cnt[:, None], 1.0)

    # reference keyframe distance/level -> scale range: use the max
    # level-scaled distance observation (approximation of mpRefKF logic)
    lv = m.kf_level
    dist_eff = jnp.where(valid_obs, dist, 0.0)
    level_factor = scale ** lv.astype(m.mp_pos.dtype)
    dmax = jnp.zeros((M + 1,), m.mp_pos.dtype).at[flat_mp].max(
        (dist_eff * level_factor).reshape(-1))[:M]
    dmin = dmax / (scale ** (n_levels - 1))
    has_obs = cnt > 0
    return m._replace(
        mp_normal=jnp.where(has_obs[:, None], normal, m.mp_normal),
        mp_dmax=jnp.where(has_obs, jnp.maximum(dmax, 1e-3), m.mp_dmax),
        mp_dmin=jnp.where(has_obs, jnp.maximum(dmin, 1e-4), m.mp_dmin))


def compact_keyframes(m: MapState):
    """Pack valid keyframes to the front of the slab, preserving temporal
    order, so culled slots become reusable.

    The reference deletes KeyFrame objects outright
    (KeyFrame::SetBadFlag + erase, src/LocalMapping.cc:974); with
    fixed-capacity slabs the equivalent is periodic compaction — a pure
    gather. Returns (m', old_of_new [K], new_of_old [K]):
    `new_of_old[k]` is the new slot of old keyframe k, or the new slot of
    the nearest PRECEDING valid keyframe if k was culled (so relative-pose
    trajectory references stay meaningful), clamped to 0.
    """
    K, F = m.kf_obs.shape
    valid = m.kf_valid
    order = jnp.cumsum(valid.astype(jnp.int32)) - 1   # new slot per old
    n_valid = jnp.sum(valid.astype(jnp.int32))
    # old slot per new position (scatter; unused new slots point at K)
    old_of_new = jnp.full((K + 1,), 0, jnp.int32).at[
        jnp.where(valid, order, K)].set(jnp.arange(K, dtype=jnp.int32))
    old_of_new = old_of_new[:K]
    used = jnp.arange(K) < n_valid
    new_of_old = jnp.maximum(order, 0)

    def gather(x):
        return x[old_of_new]

    # loop edges follow their endpoints; an edge dies with either endpoint
    le_ok = (m.loop_valid & (m.loop_i >= 0) & (m.loop_j >= 0)
             & valid[jnp.clip(m.loop_i, 0, K - 1)]
             & valid[jnp.clip(m.loop_j, 0, K - 1)])
    le_i = jnp.where(le_ok, new_of_old[jnp.clip(m.loop_i, 0, K - 1)], -1)
    le_j = jnp.where(le_ok, new_of_old[jnp.clip(m.loop_j, 0, K - 1)], -1)
    m2 = m._replace(
        kf_R=gather(m.kf_R), kf_t=gather(m.kf_t), kf_v=gather(m.kf_v),
        kf_bg=gather(m.kf_bg), kf_ba=gather(m.kf_ba),
        kf_time=gather(m.kf_time),
        kf_valid=used,
        kf_xy=gather(m.kf_xy), kf_desc=gather(m.kf_desc),
        kf_level=gather(m.kf_level), kf_sigma2=gather(m.kf_sigma2),
        kf_cam=gather(m.kf_cam),
        kf_feat_valid=gather(m.kf_feat_valid) & used[:, None],
        kf_obs=jnp.where(used[:, None], gather(m.kf_obs), -1),
        kf_bow=jnp.where(used[:, None], gather(m.kf_bow), 0),
        mp_first_kf=new_of_old[jnp.clip(m.mp_first_kf, 0, K - 1)],
        mp_last_kf=new_of_old[jnp.clip(m.mp_last_kf, 0, K - 1)],
        loop_i=le_i, loop_j=le_j, loop_valid=le_ok,
        n_kf=n_valid,
    )
    return m2, old_of_new, new_of_old


def compact_landmarks(m: MapState):
    """Pack valid landmarks to the front and remap the observation table.
    Returns (m', n_valid)."""
    K, F = m.kf_obs.shape
    M = m.mp_pos.shape[0]
    valid = m.mp_valid
    order = jnp.cumsum(valid.astype(jnp.int32)) - 1
    n_valid = jnp.sum(valid.astype(jnp.int32))
    old_of_new = jnp.full((M + 1,), 0, jnp.int32).at[
        jnp.where(valid, order, M)].set(jnp.arange(M, dtype=jnp.int32))
    old_of_new = old_of_new[:M]
    used = jnp.arange(M) < n_valid
    # old id -> new id (-1 for culled)
    new_of_old = jnp.where(valid, order, -1)

    def gather(x):
        return x[old_of_new]

    obs = m.kf_obs
    obs = jnp.where(obs >= 0, new_of_old[jnp.maximum(obs, 0)], -1)
    return m._replace(
        mp_pos=gather(m.mp_pos), mp_desc=gather(m.mp_desc),
        mp_normal=gather(m.mp_normal), mp_dmin=gather(m.mp_dmin),
        mp_dmax=gather(m.mp_dmax),
        mp_valid=used,
        mp_visible=jnp.where(used, gather(m.mp_visible), 0),
        mp_found=jnp.where(used, gather(m.mp_found), 0),
        mp_first_kf=jnp.where(used, gather(m.mp_first_kf), 0),
        mp_last_kf=jnp.where(used, gather(m.mp_last_kf), 0),
        kf_obs=obs,
        n_mp=n_valid,
    ), n_valid


def decimate_keyframes(m: MapState, current_slot, keep_recent: int = 8,
                       keep_first: int = 2):
    """Emergency slot reclamation when the slab is full and redundancy
    culling freed nothing: invalidate every second keyframe in the old
    half of the history (temporally-decimated long-term map). Returns
    (m', n_culled)."""
    K, F = m.kf_obs.shape
    idx = jnp.arange(K)
    protected = ((idx < keep_first)
                 | (idx > current_slot - keep_recent)
                 | ~m.kf_valid)
    old_half = idx < (current_slot // 2)
    drop = ~protected & old_half & (idx % 2 == 1)
    # loop edges are load-bearing constraints: never decimate their
    # endpoints (would lose the closed-loop topology permanently)
    anchor = jnp.zeros((K,), bool)
    anchor = anchor.at[jnp.clip(m.loop_i, 0, K - 1)].max(
        m.loop_valid & (m.loop_i >= 0))
    anchor = anchor.at[jnp.clip(m.loop_j, 0, K - 1)].max(
        m.loop_valid & (m.loop_j >= 0))
    drop = drop & ~anchor
    kf_valid = m.kf_valid & ~drop
    kf_obs = jnp.where(drop[:, None], -1, m.kf_obs)
    return m._replace(kf_valid=kf_valid, kf_obs=kf_obs), drop


def predict_scale_level(dist, dmax, scale: float = 1.2,
                        n_levels: int = 8) -> jnp.ndarray:
    """Predicted pyramid level from distance (MapPoint::PredictScale)."""
    ratio = dmax / jnp.maximum(dist, 1e-6)
    lvl = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-6)) / np.log(scale))
    return jnp.clip(lvl.astype(jnp.int32), 0, n_levels - 1)
