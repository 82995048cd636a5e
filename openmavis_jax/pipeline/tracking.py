"""Tracking: the per-frame front-end loop (device kernels + host policy).

JAX rebuild of the reference's Tracking thread (reference:
src/Tracking.cc:1781 Track() state machine; 2799 TrackWithMotionModel; 2904
TrackLocalMap; 3003 NeedNewKeyFrame; 3159 CreateNewKeyFrame). The hot math
is jit-compiled device steps over the fixed-capacity MapState slabs; the
thin state machine (initialization / lost handling / keyframe policy) stays
in host Python, mirroring the reference's control flow without threads.

Key idiom shift: there is no "local map harvesting" via covisibility
pointer-walks (Tracking.cc:3396) — the tracker projects *every* valid
landmark against the frame in one batched kernel and lets frustum/scale
masks select the working set: dense masked kernels instead of
gather-based sparsity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..frontend import extractor, matcher
from ..geometry import cameras, lie, triangulation
from ..imu import preintegration as pre_mod
from ..optim import ba, pose_opt
from ..optim.reprojection import RigParams
from ..slam_map import map_state as ms
from ..solvers import two_view


# ---------------------------------------------------------------------------
# jitted device steps
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("rig_kind",))
def project_landmarks(m: ms.MapState, R, t, rig_kind: int, rig_params,
                      R_cb, t_cb, img_w: float, img_h: float):
    """Project all landmarks into one camera; frustum + scale gating.

    (reference: Frame::isInFrustumChecks, src/Frame.cc:1529-1653)
    Returns (uv [M,2], pred_level [M], vis [M] bool, dist [M]).
    """
    p_b = jnp.einsum("ji,mj->mi", R, m.mp_pos - t)
    p_c = jnp.einsum("ij,mj->mi", R_cb, p_b) + t_cb
    uv = cameras.project(rig_kind, rig_params, p_c)
    depth_ok = p_c[:, 2] > 0.1
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < img_w)
              & (uv[:, 1] >= 0) & (uv[:, 1] < img_h))
    # distance within scale-invariance range
    cam_center = t + jnp.einsum("ij,j->i", R, -jnp.einsum(
        "ij,j->i", R_cb.T, t_cb))
    dvec = m.mp_pos - cam_center
    dist = jnp.linalg.norm(dvec, axis=-1)
    dist_ok = (dist > 0.8 * m.mp_dmin) & (dist < 1.2 * m.mp_dmax)
    # viewing angle vs landmark normal
    vdir = dvec / jnp.maximum(dist[:, None], 1e-9)
    cos_view = jnp.sum(vdir * m.mp_normal, axis=-1)
    angle_ok = cos_view > 0.5
    vis = m.mp_valid & depth_ok & in_img & dist_ok & angle_ok
    lvl = ms.predict_scale_level(dist, m.mp_dmax)
    return uv, lvl, vis, dist


@partial(jax.jit, static_argnames=("rig_kind", "orb_cfg"))
def frame_step(m: ms.MapState, img, R_pred, t_pred, rig_kind: int,
               rig: RigParams, orb_cfg, img_w: float, img_h: float,
               radius, min_last_kf=-1, dist=None):
    """Fused per-frame step: ORB extraction + whole-map tracking in ONE
    device program (one dispatch per frame)."""
    feats = extractor.extract(img, orb_cfg)
    if dist is not None:
        feats = extractor.undistort_features(feats, rig.params[0], dist)
    out = track_step(m, feats, R_pred, t_pred, rig_kind, rig, img_w,
                     img_h, radius, min_last_kf)
    return out + (feats,)


@partial(jax.jit, static_argnames=("rig_kind",))
def track_step(m: ms.MapState, feats: extractor.Features,
               R_pred, t_pred, rig_kind: int, rig: RigParams,
               img_w: float, img_h: float, radius,
               min_last_kf=-1):
    """Project-match-optimize against the whole map from a predicted pose.

    Combines TrackWithMotionModel's projection search + PoseOptimization and
    TrackLocalMap's second pass (reference: Tracking.cc:2799-3001).
    Returns (R, t, feat_mp [F] per-feature landmark id or -1, n_inliers,
             vis_mask [M]).
    """
    uv_proj, lvl, vis, dist = project_landmarks(
        m, R_pred, t_pred, rig_kind, rig.params[0], rig.R_cb[0],
        rig.t_cb[0], img_w, img_h)
    # optional local-map recency window (reference: TrackLocalMap's
    # covisibility-harvested local map; -1 = track against the whole map,
    # the default)
    vis = vis & (m.mp_last_kf >= min_last_kf)

    idx, hdist = matcher.match_projection(
        uv_proj, lvl, radius, m.mp_desc, vis,
        feats.xy, feats.level, feats.desc, feats.valid,
        max_dist=matcher.TH_HIGH, ratio=0.9)
    F = feats.xy.shape[0]
    idx = matcher.dedup_targets(idx, hdist, F)     # one landmark per feature

    # pose optimization over matched pairs (queries are landmarks)
    matched = idx >= 0
    safe_idx = jnp.where(matched, idx, 0)
    uv_obs = feats.xy[safe_idx]
    sigma2 = feats.sigma2[safe_idx]
    R, t, inlier, n_in = pose_opt.pose_optimization(
        R_pred, t_pred, m.mp_pos, jnp.zeros_like(idx), uv_obs, sigma2,
        matched & m.mp_valid, rig)

    # per-feature landmark assignment (inverse mapping, inliers only)
    keep = matched & inlier
    feat_mp = jnp.full((F,), -1, jnp.int32)
    feat_mp = feat_mp.at[jnp.where(keep, idx, F - 1)].max(
        jnp.where(keep, jnp.arange(idx.shape[0], dtype=jnp.int32), -1))
    # note: .at[].max with -1 default keeps unmatched at -1; collisions keep
    # the larger landmark id (deterministic)
    return R, t, feat_mp, n_in, vis, keep


def _spawn_pair(m: ms.MapState, slot_new, slot_ref, rig_kind: int,
                rig: RigParams, cap_new: int,
                min_parallax: float = 0.99995):
    """Triangulate new landmarks between a new KF and one reference KF."""
    F = m.kf_xy.shape[1]
    ref_ok = (slot_ref >= 0) & (slot_ref != slot_new)
    slot_ref = jnp.maximum(slot_ref, 0)   # safe gather index
    ref_ok = ref_ok & m.kf_valid[slot_ref]
    d1 = m.kf_desc[slot_new]
    d2 = m.kf_desc[slot_ref]
    un1 = (m.kf_obs[slot_new] < 0) & m.kf_feat_valid[slot_new]
    un2 = ((m.kf_obs[slot_ref] < 0) & m.kf_feat_valid[slot_ref]
           & ref_ok)
    idx, hdist = matcher.match_nn(d1, un1, d2, un2,
                                  max_dist=64, ratio=0.9,
                                  mutual=True)
    idx = matcher.dedup_targets(idx, hdist, F)

    # relative pose cam1(new KF) <- cam2(ref KF):
    R1 = m.kf_R[slot_new] @ rig.R_cb[0].T
    t1 = m.kf_t[slot_new] + m.kf_R[slot_new] @ (
        -rig.R_cb[0].T @ rig.t_cb[0])
    R2 = m.kf_R[slot_ref] @ rig.R_cb[0].T
    t2 = m.kf_t[slot_ref] + m.kf_R[slot_ref] @ (
        -rig.R_cb[0].T @ rig.t_cb[0])
    R12 = R1.T @ R2
    t12 = R1.T @ (t2 - t1)

    matched = idx >= 0
    safe = jnp.where(matched, idx, 0)
    uv1 = m.kf_xy[slot_new]
    uv2 = m.kf_xy[slot_ref][safe]
    params = jnp.broadcast_to(rig.params[0], (F, 8))
    X_c1, depth, tri_ok = triangulation.triangulate_matches(
        rig_kind, params, params,
        jnp.broadcast_to(R12, (F, 3, 3)), jnp.broadcast_to(t12, (F, 3)),
        uv1, uv2,
        sigma_level1=m.kf_sigma2[slot_new],
        sigma_level2=m.kf_sigma2[slot_ref][safe],
        min_cos_parallax=min_parallax)
    good = matched & tri_ok

    # allocate up to cap_new slots in order of feature index
    order = jnp.cumsum(good.astype(jnp.int32)) - 1
    M = m.mp_pos.shape[0]
    slot = m.n_mp + order
    write = good & (order < cap_new) & (slot < M)
    tgt = jnp.where(write, slot, M)                # overflow bin

    X_w = jnp.einsum("ij,fj->fi", R1, X_c1) + t1
    mp_pos = jnp.zeros((M + 1, 3), m.mp_pos.dtype).at[tgt].set(X_w)[:M]
    mp_desc = jnp.zeros((M + 1, 256), jnp.int8).at[tgt].set(d1)[:M]
    newly = jnp.zeros((M + 1,), bool).at[tgt].set(write)[:M]

    m = m._replace(
        mp_pos=jnp.where(newly[:, None], mp_pos, m.mp_pos),
        mp_desc=jnp.where(newly[:, None], mp_desc, m.mp_desc),
        mp_valid=m.mp_valid | newly,
        mp_first_kf=jnp.where(newly, slot_new, m.mp_first_kf),
        mp_last_kf=jnp.where(newly, slot_new, m.mp_last_kf),
        n_mp=m.n_mp + jnp.sum(write.astype(jnp.int32)),
        kf_obs=m.kf_obs
            .at[slot_new].set(jnp.where(write, slot, m.kf_obs[slot_new]))
            .at[slot_ref].set(
                m.kf_obs[slot_ref].at[safe].max(
                    jnp.where(write, slot, -1))),
    )
    return m, jnp.sum(write.astype(jnp.int32))


@partial(jax.jit, static_argnames=("rig_kind",))
def bind_landmarks(m: ms.MapState, slot, rig_kind: int, rig: RigParams,
                   img_w: float, img_h: float, radius: float = 10.0,
                   min_last_kf=-1):
    """Associate a keyframe's unbound features with existing landmarks by
    projection search, writing kf_obs.

    (reference: LocalMapping::SearchInNeighbors / ORBmatcher::Fuse,
    src/LocalMapping.cc:786 — duplicate-aware association of the new KF's
    features to map points of neighboring keyframes.)
    """
    F = m.kf_xy.shape[1]
    uv_proj, lvl, vis, dist = project_landmarks(
        m, m.kf_R[slot], m.kf_t[slot], rig_kind, rig.params[0],
        rig.R_cb[0], rig.t_cb[0], img_w, img_h)
    unbound = (m.kf_obs[slot] < 0) & m.kf_feat_valid[slot]
    # exclude landmarks already bound to this KF
    M = m.mp_pos.shape[0]
    bound = jnp.zeros((M,), bool).at[
        jnp.where(m.kf_obs[slot] >= 0, m.kf_obs[slot], 0)].max(
        m.kf_obs[slot] >= 0)
    vis = vis & (m.mp_last_kf >= min_last_kf)
    idx, hdist = matcher.match_projection(
        uv_proj, lvl, radius, m.mp_desc, vis & ~bound,
        m.kf_xy[slot], m.kf_level[slot], m.kf_desc[slot], unbound,
        max_dist=matcher.TH_LOW, ratio=0.9)
    idx = matcher.dedup_targets(idx, hdist, F)
    keep = idx >= 0
    new_obs = m.kf_obs[slot].at[jnp.where(keep, idx, F - 1)].max(
        jnp.where(keep, jnp.arange(M, dtype=jnp.int32), -1))
    # bump found counters
    tgt = jnp.where(keep, jnp.arange(M), M)
    found = jnp.zeros((M + 1,), jnp.int32).at[tgt].add(1)[:M]
    touched = jnp.zeros((M + 1,), bool).at[tgt].set(keep)[:M]
    return m._replace(kf_obs=m.kf_obs.at[slot].set(new_obs),
                      mp_found=m.mp_found + found,
                      mp_last_kf=jnp.where(touched, slot, m.mp_last_kf))


@jax.jit
def descriptor_place_scores(m: ms.MapState, slot):
    """Direct place-recognition scores: for each keyframe, the number of
    query features whose best Hamming match in that keyframe is < TH_LOW.

    This replaces the reference's BoW inverted file
    (KeyFrameDatabase::DetectNBestCandidates) with one dense descriptor
    matmul over ALL keyframes — affordable on an accelerator and far more
    discriminative than quantized words.
    Returns scores [K] int32.
    """
    K, F = m.kf_obs.shape
    q = m.kf_desc[slot]                          # [F, 256]
    q_valid = m.kf_feat_valid[slot]
    targets = m.kf_desc.reshape(K * F, 256)
    dist = matcher.hamming_matrix(q, targets).reshape(F, K, F)
    t_valid = m.kf_feat_valid.reshape(1, K, F)
    dist = jnp.where(t_valid & q_valid[:, None, None], dist, 1 << 20)
    best = jnp.min(dist, axis=2)                 # [F, K]
    good = best < matcher.TH_LOW
    return jnp.sum(good.astype(jnp.int32), axis=0)


@jax.jit
def cull_landmarks(m: ms.MapState, current_slot,
                   min_found_ratio: float = 0.25,
                   min_visible: int = 8, grace_kfs: int = 2):
    """Invalidate rarely-matched landmarks.

    (reference: LocalMapping::MapPointCulling, src/LocalMapping.cc:360 —
    found/visible ratio < 0.25 or unobserved after a grace period.)
    """
    age = current_slot - m.mp_first_kf
    ratio = (m.mp_found.astype(jnp.float32)
             / jnp.maximum(m.mp_visible.astype(jnp.float32), 1.0))
    bad = (m.mp_valid & (age >= grace_kfs)
           & (m.mp_visible >= min_visible) & (ratio < min_found_ratio))
    return m._replace(mp_valid=m.mp_valid & ~bad)


@partial(jax.jit, static_argnames=("cap",))
def fuse_new_landmarks(m: ms.MapState, slot, cap: int = 512,
                       rel_dist_th: float = 0.02, desc_th: int = 40):
    """Merge landmarks spawned at `slot` that duplicate older ones.

    (reference: LocalMapping::SearchInNeighbors + ORBmatcher::Fuse,
    src/LocalMapping.cc:786 — here: each new landmark searches the nearest
    OLD landmark within a depth-relative radius and descriptor gate; the
    duplicate is invalidated and the keyframe's observation re-pointed.)
    """
    M = m.mp_pos.shape[0]
    new_mask = m.mp_valid & (m.mp_first_kf == slot)
    old_mask = m.mp_valid & (m.mp_first_kf != slot)
    new_ids = jnp.nonzero(new_mask, size=cap, fill_value=M - 1)[0]
    is_real = new_mask[new_ids]

    d3 = jnp.linalg.norm(
        m.mp_pos[new_ids][:, None, :] - m.mp_pos[None, :, :], axis=-1)
    gate = rel_dist_th * jnp.maximum(
        jnp.linalg.norm(m.mp_pos[new_ids], axis=-1), 1.0)[:, None]
    near = (d3 < gate) & old_mask[None, :]
    hd = matcher.hamming_matrix(m.mp_desc[new_ids], m.mp_desc)
    cand = near & (hd < desc_th)
    # nearest admissible old landmark (packed-min argmin)
    bi, bv = matcher.masked_argmin(
        (d3 * 1000.0).astype(jnp.int32), cand)
    dup = is_real & (bv < matcher._INVALID)

    # remap table: dup new id -> old id (non-dup rows write the identity
    # value M-1 -> M-1, a harmless no-op)
    remap = jnp.arange(M, dtype=jnp.int32)
    remap = remap.at[jnp.where(dup, new_ids, M - 1)].set(
        jnp.where(dup, bi, M - 1))

    obs = m.kf_obs[slot]
    obs = jnp.where(obs >= 0, remap[jnp.maximum(obs, 0)], obs)
    killed = jnp.zeros((M,), bool).at[
        jnp.where(dup, new_ids, M - 1)].max(dup)
    return m._replace(kf_obs=m.kf_obs.at[slot].set(obs),
                      mp_valid=m.mp_valid & ~killed)


_CULL_LEVELS = 8      # pyramid-level buckets for the scale condition


@partial(jax.jit, static_argnames=("keep_recent", "max_cull",
                                   "inertial", "min_map_kfs"))
def cull_keyframes(m: ms.MapState, current_slot, keep_recent: int = 5,
                   redundancy: float = 0.9, min_other_obs: int = 4,
                   max_cull: int = 2, inertial: bool = False,
                   imu_ok=True, min_map_kfs: int = 21,
                   max_gap_s: float = 3.0,
                   recent_gap_s: float = 0.5):
    """Invalidate redundant keyframes.

    (reference: LocalMapping::KeyFrameCulling, src/LocalMapping.cc:974 —
    a keyframe is culled when >90% of its landmarks are co-observed by
    >3 OTHER keyframes at the SAME-OR-FINER pyramid scale. Inertial maps
    additionally require >Nd=21 keyframes in the map and refuse culls
    that would open a temporal gap in the preintegration chain: allowed
    only when the gap stays < 0.5 s, or < 3 s for keyframes older than
    the Nd-keyframe optimizable window once the IMU is initialized,
    LocalMapping.cc:1110-1120.)

    Dense formulation: per-landmark observation counts are bucketed by
    pyramid level ([M, L] scatter-add + a level cumsum), so "observers at
    level <= l+1" is one gather per observation — the scale condition
    without per-point loops. Up to `max_cull` keyframes are removed per
    call, greedily by redundancy, never two temporally-adjacent slots in
    the same pass (each cull's chain weld needs a surviving neighbor).

    Returns (m, culled [max_cull] i32, -1 padded).
    """
    K, F = m.kf_obs.shape
    M = m.mp_pos.shape[0]
    L = _CULL_LEVELS
    valid_obs = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    mp = jnp.where(valid_obs, m.kf_obs, M)
    lvl = jnp.clip(m.kf_level, 0, L - 1)
    # [M+1, L] observation counts per (landmark, level)
    cnt = jnp.zeros((M + 1, L), jnp.int32).at[
        mp.reshape(-1), lvl.reshape(-1)].add(
            valid_obs.reshape(-1).astype(jnp.int32))
    cnt_le = jnp.cumsum(cnt, axis=1)            # observers at level <= l
    mp_safe = jnp.minimum(mp, M - 1)
    # observers of this landmark at same-or-finer scale than THIS
    # observation (scaleLevel <= scaleLevel_i + 1 in the reference),
    # excluding the observation itself
    others = cnt_le[mp_safe, jnp.minimum(lvl + 1, L - 1)] - 1
    well = others >= min_other_obs
    frac = (jnp.sum((valid_obs & well).astype(jnp.int32), axis=1)
            / jnp.maximum(jnp.sum(valid_obs.astype(jnp.int32), axis=1),
                          1))
    idx = jnp.arange(K)
    protected = (idx > current_slot - keep_recent) | (idx <= 1)
    if inertial:
        # gap the cull would open between temporal neighbors; a culled
        # (invalid) neighbor slot carries a stale kf_time that would
        # underestimate the true surviving-neighbor gap, so an invalid
        # neighbor disallows the cull outright (the reference checks the
        # actual surviving mPrevKF/mNextKF, src/LocalMapping.cc:974)
        prev_i = jnp.maximum(idx - 1, 0)
        next_i = jnp.minimum(idx + 1, K - 1)
        t_prev = m.kf_time[prev_i]
        t_next = m.kf_time[next_i]
        gap = t_next - t_prev
        neigh_ok = m.kf_valid[prev_i] & m.kf_valid[next_i]
        old_enough = idx <= current_slot - min_map_kfs
        allowed = neigh_ok & ((gap < recent_gap_s)
                              | (jnp.asarray(imu_ok) & old_enough
                                 & (gap < max_gap_s)))
        protected = (protected | ~allowed
                     | (jnp.sum(m.kf_valid.astype(jnp.int32))
                        <= min_map_kfs))
    cand = m.kf_valid & ~protected & (frac > redundancy) \
        & (jnp.sum(valid_obs, axis=1) > 0)

    score = jnp.where(cand, frac, -1.0)
    kf_valid = m.kf_valid
    kf_obs = m.kf_obs
    culled = []
    for _ in range(max_cull):
        worst = jnp.argmax(score)
        do = score[worst] > 0
        kf_valid = kf_valid.at[worst].set(
            jnp.where(do, False, kf_valid[worst]))
        # clear its observations so landmark statistics stay consistent
        kf_obs = kf_obs.at[worst].set(
            jnp.where(do, jnp.full((F,), -1, jnp.int32),
                      kf_obs[worst]))
        culled.append(jnp.where(do, worst, -1).astype(jnp.int32))
        # mask the slot and its temporal neighbors for this pass
        score = jnp.where(jnp.abs(idx - worst) <= 1, -1.0, score)
    return (m._replace(kf_valid=kf_valid, kf_obs=kf_obs),
            jnp.stack(culled))


@partial(jax.jit, static_argnames=("rig_kind",))
def relocalize_step(m: ms.MapState, feats: extractor.Features, key,
                    rig_kind: int, rig: RigParams):
    """Relocalization: best keyframe by dense descriptor scoring, 2D-3D
    matches to its landmarks, RANSAC PnP on bearings.

    (reference: Tracking::Relocalization, src/Tracking.cc:3543-3700 — KFDB
    candidates + MLPnPsolver RANSAC + PoseOptimization refine.)
    Returns (success, R_wb, t_wb, n_inliers).
    """
    from ..solvers import pnp as pnp_mod

    K, F = m.kf_obs.shape
    # score all keyframes by best-match counts (brute-force matmul)
    dist = matcher.hamming_matrix(
        feats.desc, m.kf_desc.reshape(K * F, 256)).reshape(-1, K, F)
    t_valid = m.kf_feat_valid & (m.kf_obs >= 0) & m.kf_valid[:, None]
    dist = jnp.where(t_valid[None], dist, 1 << 20)
    best_per_kf = jnp.min(dist, axis=2)
    scores = jnp.sum((best_per_kf < matcher.TH_LOW).astype(jnp.int32)
                     & feats.valid[:, None].astype(jnp.int32), axis=0)
    # try the top-3 candidate keyframes in batch (reference iterates all
    # KFDB relocalization candidates, Tracking.cc:3564-3593)
    N_CAND = 3
    _, kf_cand = jax.lax.top_k(scores, N_CAND)

    bearing = cameras.unproject(rig_kind, rig.params[0], feats.xy)
    # express bearings in body frame of camera 0
    bearing_b = jnp.einsum("ji,fj->fi", rig.R_cb[0], bearing)

    def per_cand(kf, k):
        has_mp = (m.kf_obs[kf] >= 0) & m.kf_feat_valid[kf]
        idx, hd = matcher.match_nn(feats.desc, feats.valid,
                                   m.kf_desc[kf], has_mp,
                                   max_dist=matcher.TH_LOW, ratio=0.85,
                                   mutual=True)
        matched = idx >= 0
        safe = jnp.where(matched, idx, 0)
        mp = jnp.where(matched, m.kf_obs[kf][safe], 0)
        valid = matched & m.mp_valid[mp]
        p_w = m.mp_pos[mp]
        # ML weighting: per-keypoint pyramid-level variance whitens the
        # bearing constraints (reference: MLPnPsolver's covariance input)
        return pnp_mod.ransac_pnp(k, p_w, bearing_b, valid,
                                  min_inliers=15, sigma2=feats.sigma2)

    res = jax.vmap(per_cand)(kf_cand, jax.random.split(key, N_CAND))
    b = jnp.argmax(res.n_inliers)
    # R_cw/t_cw are body(cam0-frame)-from-world -> invert to world-from-body
    R_wb = res.R_cw[b].T
    t_wb = -res.R_cw[b].T @ res.t_cw[b]
    return res.success[b], R_wb, t_wb, res.n_inliers[b]


@partial(jax.jit, static_argnames=("rig_kind", "cap_new", "n_refs"))
def spawn_landmarks(m: ms.MapState, slot_new, ref_slots, rig_kind: int,
                    rig: RigParams, cap_new: int, n_refs: int = 4,
                    min_parallax: float = 0.99995):
    """Triangulate new landmarks between a new KF and several recent KFs.

    (reference: LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:395 —
    searches ~10-20 covisible keyframes; here the `n_refs` most recent,
    which doubles as a longer-baseline source under forward motion.)
    `ref_slots`: [n_refs] int32, -1 entries skipped.
    """
    total = jnp.zeros((), jnp.int32)
    for j in range(n_refs):
        m, n = _spawn_pair(m, slot_new, ref_slots[j], rig_kind, rig,
                           cap_new, min_parallax)
        total = total + n
    return ms.update_mp_geometry(m, None), total


@partial(jax.jit, static_argnames=("rig_kind", "window"))
def local_ba_step(m: ms.MapState, newest_slot, rig_kind: int,
                  rig: RigParams, window: int = 8):
    """Window BA over the `window` most recent keyframes.

    (reference: LocalMapping's LocalBundleAdjustment dispatch,
    src/LocalMapping.cc:156-177. The covisible-window + fixed-frontier
    structure is approximated by a temporal window with the two oldest
    members held fixed — exact covisibility windows arrive with the
    keyframe database.)
    """
    K, F = m.kf_obs.shape
    W = window
    # window slots: newest_slot - W + 1 ... newest_slot (clamped >= 0)
    w_ids = jnp.clip(newest_slot - W + 1 + jnp.arange(W), 0, K - 1)
    w_valid = m.kf_valid[w_ids] & (w_ids <= newest_slot)

    kf_local = jnp.repeat(jnp.arange(W), F)
    slots = w_ids[kf_local]
    feat = jnp.tile(jnp.arange(F), W)
    mp = m.kf_obs[slots, feat]
    valid = ((mp >= 0) & m.kf_feat_valid[slots, feat]
             & w_valid[kf_local])
    mp_safe = jnp.where(valid, mp, 0)
    valid = valid & m.mp_valid[mp_safe]

    # --- window-local landmark compaction -------------------------------
    # The BA only touches landmarks observed in the window (<= W*F but
    # typically a few hundred); running the Schur solve over the full
    # map capacity wastes ~2x device time (Hll inverses + the dense
    # pose-landmark coupling scale with M). Compact to ML local slots.
    M = m.mp_pos.shape[0]
    ML = min(M, 1024)
    seen = jnp.zeros((M,), bool).at[mp_safe].max(valid)
    order = jnp.cumsum(seen.astype(jnp.int32)) - 1      # local slot per map id
    keep = seen & (order < ML)
    # inverse table: local slot -> map index (overflow slots parked at ML)
    inv = jnp.zeros((ML + 1,), jnp.int32).at[
        jnp.where(keep, order, ML)].set(jnp.arange(M))[:ML]
    n_local = jnp.minimum(jnp.sum(seen.astype(jnp.int32)), ML)
    used = jnp.arange(ML) < n_local
    valid = valid & keep[mp_safe]
    obs = ba.BAObservations(
        kf=kf_local, mp=jnp.where(valid, order[mp_safe], 0),
        cam=m.kf_cam[slots, feat],
        uv=m.kf_xy[slots, feat], sigma2=m.kf_sigma2[slots, feat],
        valid=valid)

    state0 = ba.BAState(
        R=m.kf_R[w_ids], t=m.kf_t[w_ids], v=m.kf_v[w_ids],
        bg=m.kf_bg[w_ids], ba=m.kf_ba[w_ids], points=m.mp_pos[inv])
    # fix the two oldest valid window members (gauge + frontier)
    fixed = (jnp.arange(W) < 2) | ~w_valid

    state, inlier, chi = ba.bundle_adjust(
        state0, obs, rig, fixed, point_fixed=~used, stages=(5, 10),
        rows_per_kf=F)

    # write back window poses + compacted points; drop gated observations.
    # Unused local slots scatter to index M, which is out of bounds and
    # therefore dropped (default scatter mode) — they must not write, since
    # their inv entries all alias map index 0.
    m = m._replace(
        kf_R=m.kf_R.at[w_ids].set(
            jnp.where(w_valid[:, None, None], state.R, m.kf_R[w_ids])),
        kf_t=m.kf_t.at[w_ids].set(
            jnp.where(w_valid[:, None], state.t, m.kf_t[w_ids])),
        mp_pos=m.mp_pos.at[jnp.where(used, inv, M)].set(state.points),
        kf_obs=m.kf_obs.at[slots, feat].set(
            jnp.where(valid & ~inlier, -1, m.kf_obs[slots, feat])),
    )
    return m, chi


def full_map_observations(m: ms.MapState, cap: int | None = None):
    """Flatten every (keyframe, feature) -> landmark binding of the map
    into BAObservations + the observed-landmark mask. Shared by the
    whole-map solvers (GBA, FullInertialBA, merge welding BA).

    `cap` compacts the table to <= cap VALID rows (cumsum-gather): the
    masked-dense table is K*F rows but only bound features are real
    observations, and the matrix-free solvers' cost is driven by
    gather/scatter row count — without the cap, every whole-map event
    slows linearly with slab CAPACITY (524k rows at max_kf=256) instead
    of map content. Overflow beyond `cap` keeps the lowest (oldest
    keyframe) rows; size the cap above the expected bound count.
    """
    K, F = m.kf_obs.shape
    kf_local = jnp.repeat(jnp.arange(K), F)
    feat = jnp.tile(jnp.arange(F), K)
    mp = m.kf_obs[kf_local, feat]
    valid = ((mp >= 0) & m.kf_feat_valid[kf_local, feat]
             & m.kf_valid[kf_local])
    mp_safe = jnp.where(valid, mp, 0)
    valid = valid & m.mp_valid[mp_safe]
    if cap is not None and cap < K * F:
        order = jnp.cumsum(valid.astype(jnp.int32)) - 1
        keep = valid & (order < cap)
        idx = jnp.zeros((cap + 1,), jnp.int32).at[
            jnp.where(keep, order, cap)].set(
                jnp.arange(K * F, dtype=jnp.int32))[:cap]
        taken = jnp.arange(cap) < jnp.minimum(
            jnp.sum(valid.astype(jnp.int32)), cap)
        kf_local = kf_local[idx]
        feat = feat[idx]
        mp_safe = mp_safe[idx]
        valid = taken & valid[idx]
    obs = ba.BAObservations(
        kf=kf_local, mp=mp_safe, cam=m.kf_cam[kf_local, feat],
        uv=m.kf_xy[kf_local, feat], sigma2=m.kf_sigma2[kf_local, feat],
        valid=valid)
    M = m.mp_pos.shape[0]
    observed = jnp.zeros((M,), bool).at[mp_safe].max(valid)
    return obs, observed, kf_local, feat


def _writeback_gba(m: ms.MapState, state, inlier, chi, observed,
                   kf_local, feat, valid, with_imu: bool):
    """Apply a whole-map BA result back to the slabs; gated on finite
    chi2 so a diverged solve can never corrupt the map."""
    good = jnp.isfinite(chi)
    upd = m.kf_valid & good
    m = m._replace(
        kf_R=jnp.where(upd[:, None, None], state.R, m.kf_R),
        kf_t=jnp.where(upd[:, None], state.t, m.kf_t),
        mp_pos=jnp.where((observed & good)[:, None], state.points,
                         m.mp_pos),
        kf_obs=jnp.where(good, m.kf_obs.at[kf_local, feat].set(
            jnp.where(valid & ~inlier, -1, m.kf_obs[kf_local, feat])),
            m.kf_obs))
    if with_imu:
        m = m._replace(
            kf_v=jnp.where(upd[:, None], state.v, m.kf_v),
            kf_bg=jnp.where(upd[:, None], state.bg, m.kf_bg),
            kf_ba=jnp.where(upd[:, None], state.ba, m.kf_ba))
    return m


@partial(jax.jit, static_argnames=("rig_kind", "stages", "cg_iters",
                                   "obs_cap"))
def global_ba_step(m: ms.MapState, rig_kind: int, rig: RigParams,
                   stages=(5, 8), cg_iters: int = 32,
                   obs_cap: int = 131072):
    """Whole-map bundle adjustment via the matrix-free Schur+PCG path.

    (reference: LoopClosing::RunGlobalBundleAdjustment ->
    Optimizer::GlobalBundleAdjustemnt, src/LoopClosing.cc:2351,
    src/Optimizer.cc:29 — here one jitted program over ALL keyframes and
    landmarks; first two keyframes fix the gauge.)
    """
    from ..optim import global_ba

    obs, observed, kf_local, feat = full_map_observations(m, obs_cap)
    state0 = ba.BAState(R=m.kf_R, t=m.kf_t, v=m.kf_v, bg=m.kf_bg,
                        ba=m.kf_ba, points=m.mp_pos)
    K = m.kf_R.shape[0]
    fixed = (jnp.arange(K) < 2) | ~m.kf_valid
    state, inlier, chi = global_ba.global_bundle_adjust(
        state0, obs, rig, fixed, point_fixed=~observed,
        stages=stages, cg_iters=cg_iters)
    m = _writeback_gba(m, state, inlier, chi, observed, kf_local, feat,
                       obs.valid, with_imu=False)
    return m, chi


def distributed_global_ba_step(m: ms.MapState, rig_kind: int,
                               rig: RigParams, mesh,
                               pre_b=None, edge_valid=None,
                               stages=(4, 6), cg_iters: int = 16,
                               obs_cap: int = 131072):
    """Whole-map (inertial when `pre_b` is given) GBA SHARDED over a
    device mesh — the product-path entry the live System dispatches when
    more than one device is available (System.run_global_ba(mesh=...)).

    The landmark state, Hessian blocks and observation table partition
    across the mesh (parallel/dist_ba.distributed_global_ba_lsharded);
    per CG matvec one [K, D] psum crosses devices. This is the device form
    of the reference's background GBA thread over the whole map
    (src/LoopClosing.cc:2351 RunGlobalBundleAdjustment) scaled past one
    device — the BASELINE.json north-star workload.

    Host-side observation bucketing reads the map once (one d2h); use at
    event cadence (post-loop, post-merge, shutdown), like the reference's
    GBA thread.
    """
    from ..parallel import dist_ba

    obs, observed, kf_local, feat = full_map_observations(m, obs_cap)
    K = m.kf_R.shape[0]
    state0 = ba.BAState(R=m.kf_R, t=m.kf_t, v=m.kf_v, bg=m.kf_bg,
                        ba=m.kf_ba, points=m.mp_pos)
    edges = None
    if pre_b is not None:
        kf_in = m.kf_valid & (jnp.arange(K) < m.n_kf)
        edge_ok = edge_valid & kf_in[1:] & kf_in[:-1]
        bias_k = jnp.concatenate([m.kf_bg, m.kf_ba], axis=-1)[:-1]
        pre2 = jax.vmap(pre_mod.rebias)(pre_b, bias_k)
        edges = ba.InertialEdges(pre=pre2, valid=edge_ok)
        fixed = (jnp.arange(K) < 1) | ~m.kf_valid
    else:
        fixed = (jnp.arange(K) < 2) | ~m.kf_valid
    state, inlier, chi = dist_ba.distributed_global_ba_lsharded(
        mesh, state0, obs, rig, fixed, point_fixed=~observed,
        edges=edges, stages=stages, cg_iters=cg_iters)
    m = _writeback_gba(m, state, inlier, chi, observed, kf_local, feat,
                       obs.valid, with_imu=pre_b is not None)
    return m, chi


@partial(jax.jit, static_argnames=("rig_kind", "obs_cap"))
def welding_ba_step(m: ms.MapState, free_mask, rig_kind: int,
                    rig: RigParams, obs_cap: int = 131072):
    """Weld-window bundle adjustment after an Atlas map merge.

    (reference: the welding LocalBundleAdjustment MergeLocal runs over the
    two maps' frontier keyframes after the Sim3 transform,
    src/Optimizer.cc:3927, called from src/LoopClosing.cc MergeLocal; the
    inertial variant MergeInertialBA src/Optimizer.cc:4365 is covered by
    running global_inertial_ba_step once the preintegration chains are
    welded.)

    free_mask: [K] bool — keyframes allowed to move (typically the
    welded-in map's slots); everything else is the fixed frontier.
    Landmarks move only if observed by at least one free keyframe.
    """
    from ..optim import global_ba

    obs, observed, kf_local, feat = full_map_observations(m, obs_cap)
    M = m.mp_pos.shape[0]
    free_obs = obs.valid & free_mask[obs.kf]
    mp_free = jnp.zeros((M,), bool).at[obs.mp].max(free_obs)
    state0 = ba.BAState(R=m.kf_R, t=m.kf_t, v=m.kf_v, bg=m.kf_bg,
                        ba=m.kf_ba, points=m.mp_pos)
    fixed = ~free_mask | ~m.kf_valid
    state, inlier, chi = global_ba.global_bundle_adjust(
        state0, obs, rig, fixed, point_fixed=~(observed & mp_free),
        stages=(4, 6), cg_iters=24)
    m = _writeback_gba(m, state, inlier, chi, observed & mp_free,
                       kf_local, feat, obs.valid, with_imu=False)
    return m, chi


@partial(jax.jit, static_argnames=("rig_kind", "stages", "cg_iters",
                                   "obs_cap"))
def global_inertial_ba_step(m: ms.MapState, pre_b, edge_valid,
                            rig_kind: int, rig: RigParams,
                            stages=(4, 6), cg_iters: int = 16,
                            obs_cap: int = 131072):
    """Whole-map VISUAL-INERTIAL bundle adjustment: the reference's
    FullInertialBA as invoked by the post-loop GBA thread (reference:
    src/LoopClosing.cc:2366-2368 -> Optimizer::FullInertialBA
    src/Optimizer.cc:368). The temporal chain enters as [K-1]
    preintegrated edges; one keyframe fixes the gauge (gravity + scale
    are observable through the chain, so only the first pose is pinned).

    pre_b: batched Preintegrated for intervals (k -> k+1), k in [0, K-1);
    edge_valid: [K-1] bool.
    """
    from ..optim import global_ba

    obs, observed, kf_local, feat = full_map_observations(m, obs_cap)
    K = m.kf_R.shape[0]
    kf_in = m.kf_valid & (jnp.arange(K) < m.n_kf)
    edge_ok = edge_valid & kf_in[1:] & kf_in[:-1]
    # relinearize each interval at its own keyframe's current bias
    # (first-order Reintegrate analog, reference: src/ImuTypes.cc:152)
    bias_k = jnp.concatenate([m.kf_bg, m.kf_ba], axis=-1)[:-1]
    pre2 = jax.vmap(pre_mod.rebias)(pre_b, bias_k)
    edges = ba.InertialEdges(pre=pre2, valid=edge_ok)
    state0 = ba.BAState(R=m.kf_R, t=m.kf_t, v=m.kf_v, bg=m.kf_bg,
                        ba=m.kf_ba, points=m.mp_pos)
    fixed = (jnp.arange(K) < 1) | ~m.kf_valid
    # sequential-depth budget (see multi_tracking.imu_init_step): the
    # matrix-free matvec is latency-bound, so CG depth is the cost
    state, inlier, chi = global_ba.global_bundle_adjust(
        state0, obs, rig, fixed, point_fixed=~observed, edges=edges,
        stages=stages, cg_iters=cg_iters)
    m = _writeback_gba(m, state, inlier, chi, observed, kf_local, feat,
                       obs.valid, with_imu=True)
    return m, chi


def recycle_map_slots(m: ms.MapState, trajectory, map_id: int):
    """Re-base trajectory entries off culled reference keyframes, then
    compact the keyframe and landmark slabs so culled slots are reusable.

    This is what makes the fixed-capacity slabs an UNBOUNDED-sequence map:
    the reference deletes keyframes (LocalMapping::KeyFrameCulling,
    src/LocalMapping.cc:974) and lets the pointer graph shrink; here the
    equivalent is compaction + slot reuse.
    Returns (m', trajectory', old_of_new, new_of_old, n_mp).
    """
    kf_valid = np.asarray(m.kf_valid)
    kf_R = np.asarray(m.kf_R)
    kf_t = np.asarray(m.kf_t)
    K = kf_valid.shape[0]
    # nearest preceding valid slot per slot (numpy mirror of the device
    # new_of_old computation, needed to re-express relative poses)
    order = np.cumsum(kf_valid.astype(np.int64)) - 1
    prev_valid = np.full((K,), 0, np.int64)
    last = 0
    for k in range(K):
        if kf_valid[k]:
            last = k
        prev_valid[k] = last

    traj2 = []
    for (tm, mid, ref, R_rel, t_rel) in trajectory:
        if mid == map_id and not kf_valid[ref]:
            ref2 = int(prev_valid[ref])
            R_w = kf_R[ref] @ R_rel
            t_w = kf_t[ref] + kf_R[ref] @ t_rel
            R_rel = kf_R[ref2].T @ R_w
            t_rel = kf_R[ref2].T @ (t_w - kf_t[ref2])
            ref = ref2
        traj2.append((tm, mid, ref, R_rel, t_rel))

    m, old_of_new, new_of_old = ms.compact_keyframes(m)
    new_of_old_np = np.asarray(new_of_old)
    traj3 = [(tm, mid, int(new_of_old_np[ref]) if mid == map_id else ref,
              R_rel, t_rel)
             for (tm, mid, ref, R_rel, t_rel) in traj2]
    m, n_mp = ms.compact_landmarks(m)
    return m, traj3, np.asarray(old_of_new), new_of_old_np, int(n_mp)


# ---------------------------------------------------------------------------
# host-side tracker
# ---------------------------------------------------------------------------

@dataclass
class TrackerConfig:
    img_w: int = 640
    img_h: int = 480
    orb: extractor.OrbConfig = field(default_factory=extractor.OrbConfig)
    max_kf: int = 64
    max_mp: int = 8192
    match_radius: float = 15.0
    relost_radius: float = 30.0
    min_inliers_track: int = 20
    local_map_window: Optional[int] = None  # None = whole-map tracking
    # fuse extraction+tracking into one device program. Fewer dispatches,
    # but the mega-program compiles slowly; measure per deployment.
    fused_frontend: bool = False
    kf_min_inlier_frac: float = 0.75   # new KF if tracked < frac * ref
    kf_min_inliers_abs: int = 60       # ... or tracked below this count
    new_mp_cap: int = 256
    ba_window: int = 8
    # window used to settle the map after a loop closure (the GBA analog;
    # reference spawns a RunGlobalBundleAdjustment thread, LoopClosing.cc:1372)
    gba_window: Optional[int] = 24
    init_min_matches: int = 80
    # frames to coast in LOST (relocalization attempts) before abandoning
    # the map and spawning a fresh one in the Atlas (reference:
    # CreateMapInAtlas on persistent loss, src/Tracking.cc:1953-1968)
    max_lost_frames: int = 20


class Tracker:
    """Single-camera (monocular) tracker. State machine mirrors
    Tracking::Track (reference: src/Tracking.cc:1781-2230)."""

    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2

    def __init__(self, rig: RigParams, cfg: TrackerConfig,
                 seed: int = 0, loop_closer=None, atlas=None, dist=None):
        self.rig = rig
        self.cfg = cfg
        # optional [C, 4] radtan distortion of a distorted-pinhole rig;
        # keypoints are undistorted right after extraction (reference:
        # Frame::UndistortKeyPoints)
        self.dist = None if dist is None else jnp.asarray(dist)
        self.loop_closer = loop_closer   # optional LoopCloser hook
        self.atlas = atlas               # optional multi-map Atlas
        self.state = self.NOT_INITIALIZED
        if atlas is not None:
            if not atlas.maps:
                atlas.create_map(cfg.max_kf, cfg.orb.n_features,
                                 cfg.max_mp)
            self.map = atlas.current_map
            self.map_id = atlas.current
        else:
            self.map = ms.allocate(cfg.max_kf, cfg.orb.n_features,
                                   cfg.max_mp)
            self.map_id = 0
        self.lost_frames = 0
        # localization-only: track, never extend the map
        # (reference: ActivateLocalizationMode, System.h:132)
        self.localization_only = False
        self.key = jax.random.PRNGKey(seed)
        self._init_feats = None
        self._init_img_time = None
        self.R = jnp.eye(3)
        self.t = jnp.zeros(3)
        self.R_prev = jnp.eye(3)
        self.t_prev = jnp.zeros(3)
        self.vel_R = jnp.eye(3)      # motion model: T_k = T_{k-1} * vel
        self.vel_t = jnp.zeros(3)
        self.last_kf_slot = -1
        self.ref_kf_inliers = 0
        # (time, ref_kf, R_rel, t_rel) per frame — relative to the latest
        # keyframe so map corrections retro-fix the trajectory (reference:
        # mlRelativeFramePoses + SaveTrajectoryEuRoC, src/System.cc:717)
        self.trajectory = []
        self.n_kf = 0
        def _ext(im, dist=self.dist, rig_p=rig.params):
            feats = extractor.extract(im, cfg.orb)
            if dist is not None:
                feats = extractor.undistort_features(feats, rig_p[0], dist[0])
            return feats
        self._ext = jax.jit(_ext)

    # -- helpers -----------------------------------------------------------
    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _bearing_z1(self, feats):
        """Normalized z=1 coords of features through camera 0."""
        ray = cameras.unproject(self.rig.kind, self.rig.params[0], feats.xy)
        z = jnp.maximum(ray[:, 2], 1e-6)
        return ray[:, :2] / z[:, None]

    # -- initialization ----------------------------------------------------
    def _try_initialize(self, feats, time):
        cfg = self.cfg
        if self._init_feats is None:
            self._init_feats = feats
            self._init_time = time
            return False
        f0 = self._init_feats
        idx, hdist = matcher.match_nn(
            feats.desc, feats.valid, f0.desc, f0.valid,
            max_dist=matcher.TH_LOW, ratio=0.9, mutual=True)
        n_matches = int((idx >= 0).sum())
        if n_matches < cfg.init_min_matches:
            self._init_feats = feats   # slide the reference forward
            self._init_time = time
            return False

        x1 = self._bearing_z1(f0)
        x2 = self._bearing_z1(feats)
        matched = idx >= 0
        safe = jnp.where(matched, idx, 0)
        res = two_view.reconstruct(
            self._next_key(), x1[safe], x2, matched,
            focal=float(self.rig.params[0, 0]))
        if not bool(res.success):
            return False

        # scale so median depth = 1 (reference: MonocularInitialization)
        good = np.asarray(res.is_good)
        depths = np.asarray(res.points)[:, 2]
        med = np.median(depths[good]) if good.any() else 1.0
        scale = 1.0 / max(med, 1e-6)
        pts_c0 = res.points * scale            # in first-frame camera
        R01, t01 = res.R, res.t * scale        # cam1-from-cam0 (p1 = R p0+t)

        # world = first body frame. KF0 at identity; KF1 pose:
        # T_w_c1 = inv(T_c1_w) with T_c1_w = (R01, t01)
        R_w1 = R01.T
        t_w1 = -R01.T @ t01

        m = self.map
        F = cfg.orb.n_features
        M = cfg.max_mp
        n_new = int(good.sum())
        # observation wiring: feature i of frame1 matches f0 feature idx[i]
        order = np.cumsum(good) - 1
        slot_np = np.where(good, order, -1).astype(np.int32)
        obs1 = jnp.asarray(np.where(good, slot_np, -1))
        obs0 = np.full((F,), -1, np.int32)
        idx_np = np.asarray(idx)
        sel = good & (idx_np >= 0)
        obs0[idx_np[sel]] = slot_np[sel]
        obs0 = jnp.asarray(obs0)

        pts_w = jnp.asarray(pts_c0)            # world == cam0 frame
        write = jnp.asarray(good) & (jnp.asarray(order) < M)
        tgt = jnp.where(write, jnp.asarray(slot_np), M)
        mp_pos = jnp.zeros((M + 1, 3)).at[tgt].set(pts_w)[:M]
        mp_desc = jnp.zeros((M + 1, 256), jnp.int8).at[tgt].set(
            feats.desc)[:M]
        newly = jnp.zeros((M + 1,), bool).at[tgt].set(write)[:M]
        m = m._replace(
            mp_pos=jnp.where(newly[:, None], mp_pos, m.mp_pos),
            mp_desc=jnp.where(newly[:, None], mp_desc, m.mp_desc),
            mp_valid=newly, n_mp=jnp.asarray(n_new, jnp.int32))

        z3 = jnp.zeros(3)
        m = ms.insert_keyframe(
            m, 0, jnp.eye(3), z3, z3, z3, z3, self._init_time,
            f0.xy, f0.desc, f0.level, f0.sigma2,
            jnp.zeros((F,), jnp.int32), f0.valid, obs0)
        m = ms.insert_keyframe(
            m, 1, R_w1, t_w1, z3, z3, z3, time,
            feats.xy, feats.desc, feats.level, feats.sigma2,
            jnp.zeros((F,), jnp.int32), feats.valid, obs1)
        m = ms.update_mp_geometry(m, None)
        self.map, _ = local_ba_step(m, jnp.asarray(1), self.rig.kind,
                                    self.rig, window=2)
        self.R, self.t = R_w1, t_w1
        self.R_prev, self.t_prev = jnp.eye(3), jnp.zeros(3)
        self.last_kf_slot = 1
        self.n_kf = 2
        self.ref_kf_inliers = n_new
        self.state = self.OK
        return True

    # -- RGB-D -------------------------------------------------------------
    def _depth_at(self, feats, depth):
        """Sample the frame's depth map at feature locations."""
        from ..frontend import depth as depth_mod
        return depth_mod.sample_depth(jnp.asarray(depth), feats.xy)

    def _initialize_rgbd(self, feats, depth, time):
        """Immediate metric initialization from one depth frame.

        (reference: Tracking::StereoInitialization, src/Tracking.cc:2232 —
        stereo/RGBD spawns the first keyframe and its landmarks directly
        from measured depth; no parallax wait, metric scale from frame 0.)
        """
        from ..frontend import depth as depth_mod
        cfg = self.cfg
        d, ok = self._depth_at(feats, depth)
        if int((ok & feats.valid).sum()) < cfg.init_min_matches:
            return False
        z3 = jnp.zeros(3)
        F = cfg.orb.n_features
        m = ms.insert_keyframe(
            self.map, 0, jnp.eye(3), z3, z3, z3, z3, time,
            feats.xy, feats.desc, feats.level, feats.sigma2,
            jnp.zeros((F,), jnp.int32), feats.valid,
            jnp.full((F,), -1, jnp.int32))
        m, n_new = depth_mod.spawn_from_depth(
            m, jnp.asarray(0), self.rig.kind, self.rig.params[0],
            self.rig.R_cb[0], self.rig.t_cb[0], d, ok & feats.valid,
            cap_new=F)
        self.map = m
        self.R, self.t = jnp.eye(3), jnp.zeros(3)
        self.last_kf_slot = 0
        self.n_kf = 1
        self.ref_kf_inliers = int(n_new)
        self.state = self.OK
        return True

    # -- main entry --------------------------------------------------------
    def process_frame(self, img: jnp.ndarray, time: float, depth=None):
        cfg = self.cfg
        self._frame_depth = depth

        if self.state == self.NOT_INITIALIZED:
            feats = self._ext(img)
            if depth is not None:
                ok = self._initialize_rgbd(feats, depth, time)
            else:
                ok = self._try_initialize(feats, time)
            self._record(time)
            return ok

        if self.state == self.LOST:
            # relocalization attempt (reference: Tracking.cc:3543)
            feats = self._ext(img)
            ok_r, R_r, t_r, n_r = relocalize_step(
                self.map, feats, self._next_key(), self.rig.kind,
                self.rig)
            if bool(ok_r):
                self.R, self.t = R_r, t_r
                self.vel_R = jnp.eye(3)
                self.vel_t = jnp.zeros(3)
                self.lost_frames = 0
                self.state = self.OK
            else:
                self.lost_frames += 1
                if (self.atlas is not None
                        and self.lost_frames > cfg.max_lost_frames
                        and self.n_kf >= 2):
                    # abandon the map: park it in the Atlas and start a
                    # fresh one; merge detection re-joins them later
                    # (reference: CreateMapInAtlas, Tracking.cc:1953-1968)
                    self._spawn_new_map()
                self._record(time)
                return False

        # motion-model prediction (reference: Tracking.cc mVelocity)
        R_pred = self.R @ self.vel_R
        t_pred = self.t + self.R @ self.vel_t

        min_last = (-1 if cfg.local_map_window is None
                    else self.last_kf_slot - cfg.local_map_window)
        if cfg.fused_frontend:
            R, t, feat_mp, n_in, vis, keep, feats = frame_step(
                self.map, img, R_pred, t_pred, self.rig.kind, self.rig,
                cfg.orb, float(cfg.img_w), float(cfg.img_h),
                cfg.match_radius, min_last,
                None if self.dist is None else self.dist[0])
        else:
            feats = self._ext(img)
            R, t, feat_mp, n_in, vis, keep = track_step(
                self.map, feats, R_pred, t_pred, self.rig.kind, self.rig,
                float(cfg.img_w), float(cfg.img_h), cfg.match_radius,
                min_last)
        n_in = int(n_in)
        if n_in < cfg.min_inliers_track:
            # wider search from the last pose against the WHOLE map
            # (RECENTLY_LOST coast + implicit relocalization)
            R, t, feat_mp, n_in, vis, keep = track_step(
                self.map, feats, self.R, self.t, self.rig.kind, self.rig,
                float(cfg.img_w), float(cfg.img_h), cfg.relost_radius)
            n_in = int(n_in)
            if n_in < cfg.min_inliers_track:
                self.state = self.LOST
                self._record(time)
                return False

        # update motion model: vel = T_{k-1}^{-1} T_k (body frame)
        self.vel_R = self.R.T @ R
        self.vel_t = self.R.T @ (t - self.t)
        self.R_prev, self.t_prev = self.R, self.t
        self.R, self.t = R, t
        self.state = self.OK
        self.lost_frames = 0

        # landmark statistics
        m = self.map
        self.map = m._replace(
            mp_visible=m.mp_visible + vis.astype(jnp.int32),
            mp_found=m.mp_found + keep.astype(jnp.int32))

        # keyframe decision (reference: NeedNewKeyFrame, simplified: track
        # ratio vs reference KF)
        need_kf = (n_in < cfg.kf_min_inlier_frac
                   * max(self.ref_kf_inliers, 1)
                   or n_in < cfg.kf_min_inliers_abs)
        if need_kf and not self.localization_only:
            if self.n_kf >= cfg.max_kf:
                self._recycle_slots()
            if self.n_kf < cfg.max_kf:
                self._insert_keyframe(feats, time, feat_mp, n_in)

        self._record(time)
        return True

    def _record(self, time):
        ref = max(self.last_kf_slot, 0)
        R_ref = np.asarray(self.map.kf_R[ref])
        t_ref = np.asarray(self.map.kf_t[ref])
        R_rel = R_ref.T @ np.asarray(self.R)
        t_rel = R_ref.T @ (np.asarray(self.t) - t_ref)
        self.trajectory.append((time, self.map_id, ref, R_rel, t_rel))

    def get_trajectory(self):
        """(times, R [T,3,3], t [T,3]) replayed against the FINAL map(s)."""
        maps = self.atlas.maps if self.atlas is not None else [self.map]
        if self.atlas is not None:
            self._sync_atlas()
        kf_R = [np.asarray(m.kf_R) for m in maps]
        kf_t = [np.asarray(m.kf_t) for m in maps]
        times, Rs, ts = [], [], []
        for (tm, mid, ref, R_rel, t_rel) in self.trajectory:
            times.append(tm)
            Rs.append(kf_R[mid][ref] @ R_rel)
            ts.append(kf_t[mid][ref] + kf_R[mid][ref] @ t_rel)
        return np.asarray(times), np.stack(Rs), np.stack(ts)

    # -- Atlas bookkeeping ---------------------------------------------------
    def _sync_atlas(self):
        if self.atlas is not None:
            self.atlas.maps[self.map_id] = self.map

    def _spawn_new_map(self):
        """Park the current map and start tracking into a fresh one."""
        cfg = self.cfg
        self._sync_atlas()
        self.map_id = self.atlas.create_map(
            cfg.max_kf, cfg.orb.n_features, cfg.max_mp)
        self.map = self.atlas.current_map
        self.state = self.NOT_INITIALIZED
        self._init_feats = None
        self.R = jnp.eye(3)
        self.t = jnp.zeros(3)
        self.vel_R = jnp.eye(3)
        self.vel_t = jnp.zeros(3)
        self.last_kf_slot = -1
        self.n_kf = 0
        self.ref_kf_inliers = 0
        self.lost_frames = 0

    def _remap_after_merge(self, old_map_id, new_map_id, kf_off):
        """Fix trajectory references after the current map was welded into
        an older map (slots shifted by kf_off; maps after the dropped one
        shifted down by one)."""
        fixed = []
        for (tm, mid, ref, R_rel, t_rel) in self.trajectory:
            if mid == old_map_id:
                fixed.append((tm, new_map_id, ref + kf_off, R_rel, t_rel))
            else:
                mid2 = mid - 1 if mid > old_map_id else mid
                fixed.append((tm, mid2, ref, R_rel, t_rel))
        self.trajectory = fixed

    def _recycle_slots(self):
        """Free keyframe/landmark slots when the slab is full: compact the
        culled slots out; if culling never freed anything, temporally
        decimate the old half of the map first (long-term map thinning).
        Keeps the fixed-capacity slabs usable on unbounded sequences
        (reference deletes KFs outright: src/LocalMapping.cc:974)."""
        m = self.map
        if int(m.kf_valid.sum()) >= self.cfg.max_kf:
            m, _ = ms.decimate_keyframes(m, self.n_kf - 1)
            self.map = m
        self.map, self.trajectory, _, new_of_old, _ = recycle_map_slots(
            self.map, self.trajectory, self.map_id)
        if self.last_kf_slot >= 0:
            self.last_kf_slot = int(new_of_old[self.last_kf_slot])
        self.n_kf = int(self.map.n_kf)
        self._sync_atlas()

    def _insert_keyframe(self, feats, time, feat_mp, n_in):
        cfg = self.cfg
        slot = self.n_kf
        z3 = jnp.zeros(3)
        F = cfg.orb.n_features
        self.map = ms.insert_keyframe(
            self.map, slot, self.R, self.t, z3, z3, z3, time,
            feats.xy, feats.desc, feats.level, feats.sigma2,
            jnp.zeros((F,), jnp.int32), feats.valid, feat_mp)
        if getattr(self, "_frame_depth", None) is not None:
            # RGB-D: spawn close landmarks directly from measured depth
            # (reference: CreateNewKeyFrame depth-sorted creation,
            # src/Tracking.cc:3159)
            from ..frontend import depth as depth_mod
            d, ok = self._depth_at(feats, self._frame_depth)
            self.map, _ = depth_mod.spawn_from_depth(
                self.map, jnp.asarray(slot), self.rig.kind,
                self.rig.params[0], self.rig.R_cb[0], self.rig.t_cb[0],
                d, ok & feats.valid, cap_new=cfg.new_mp_cap)
        refs = jnp.asarray([slot - 1 - j for j in range(4)],
                           dtype=jnp.int32)
        self.map, n_new = spawn_landmarks(
            self.map, jnp.asarray(slot), refs,
            self.rig.kind, self.rig, cfg.new_mp_cap)
        min_last = (-1 if cfg.local_map_window is None
                    else slot - cfg.local_map_window)
        self.map = bind_landmarks(
            self.map, jnp.asarray(slot), self.rig.kind, self.rig,
            float(cfg.img_w), float(cfg.img_h), min_last_kf=min_last)
        self.map = fuse_new_landmarks(self.map, jnp.asarray(slot),
                                      cap=cfg.new_mp_cap)
        self.map = cull_landmarks(self.map, jnp.asarray(slot))
        self.map, _ = cull_keyframes(self.map, jnp.asarray(slot))
        self.map, _ = local_ba_step(
            self.map, jnp.asarray(slot), self.rig.kind, self.rig,
            window=cfg.ba_window)
        self.last_kf_slot = slot
        self.n_kf += 1
        self.ref_kf_inliers = max(n_in, 1)
        if self.loop_closer is not None:
            self.map, closed = self.loop_closer.on_keyframe(self.map, slot)
            if closed:
                # wide BA to settle the welded map (GBA analog)
                self.map, _ = local_ba_step(
                    self.map, jnp.asarray(slot), self.rig.kind, self.rig,
                    window=(cfg.gba_window or cfg.ba_window))
            # cross-map merge detection (reference: LoopClosing merge path
            # MergeLocal, src/LoopClosing.cc:1381)
            if self.atlas is not None and len(self.atlas.maps) > 1:
                self._sync_atlas()
                old_id = self.map_id
                hit = self.loop_closer.detect_merge(self.atlas, slot)
                if hit is not None:
                    new_id, kf_off, _ = hit
                    self.map = self.atlas.current_map
                    self._remap_after_merge(old_id, new_id, kf_off)
                    self.map_id = new_id
                    slot = slot + kf_off
                    self.last_kf_slot = slot
                    self.n_kf = int(self.map.n_kf)
                    # welding BA over the junction (reference: MergeLocal's
                    # welding bundle adjustment)
                    self.map, _ = local_ba_step(
                        self.map, jnp.asarray(slot), self.rig.kind,
                        self.rig, window=(cfg.gba_window or cfg.ba_window))
                    self._sync_atlas()
        # refresh current pose from the (possibly corrected) map
        self.R = self.map.kf_R[slot]
        self.t = self.map.kf_t[slot]
