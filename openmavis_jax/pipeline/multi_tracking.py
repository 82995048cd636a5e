"""Multi-camera visual-inertial tracking — the flagship MAVIS pipeline.

JAX rebuild of the reference's IMU_MULTI mode (reference:
System::TrackMulti src/System.cc:311; Tracking::GrabImageMulti
src/Tracking.cc:1410; the multi Frame ctor src/Frame.cc:1767-1949 with
4-camera feature banding; Tracking::MultiInitialization src/Tracking.cc:2339;
PreintegrateIMU src/Tracking.cc:1625; PredictStateIMU src/Tracking.cc:1723;
LocalMapping's staged IMU init src/LocalMapping.cc:1255).

Structure: per-frame features from all C cameras are one contiguous bank of
C*F slots (band c occupies [c*F, (c+1)*F)) — the reference's
Nleft/Nright/Nsideleft/Nsideright banding as an array layout. All per-camera
work is a static Python loop over C inside one jitted step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..frontend import depth as depth_mod
from ..frontend import extractor, matcher
from ..geometry import cameras, lie, triangulation
from ..imu import preintegration as pre_mod
from ..optim import ba, inertial_init, pose_opt
from ..optim.reprojection import RigParams
from ..slam_map import map_state as ms
from . import tracking as mono


def concat_bands(feats: extractor.Features) -> dict:
    """[C, F, ...] camera-batched features -> single bank [C*F, ...]."""
    C, F = feats.valid.shape
    cam = jnp.repeat(jnp.arange(C, dtype=jnp.int32), F)
    return dict(
        xy=feats.xy.reshape(C * F, 2),
        desc=feats.desc.reshape(C * F, 256),
        level=feats.level.reshape(C * F),
        sigma2=feats.sigma2.reshape(C * F),
        cam=cam,
        valid=feats.valid.reshape(C * F),
    )


@partial(jax.jit, static_argnames=("rig_kind", "n_cams", "orb_cfg"))
def frame_step_multi(m: ms.MapState, images, R_pred, t_pred,
                     rig_kind: int, n_cams: int, rig: RigParams, orb_cfg,
                     img_w: float, img_h: float, radius, min_last_kf=-1,
                     dist=None):
    """Fused per-frame step: multi-camera extraction + banding + tracking
    in one device program (one dispatch per frame)."""
    feats = extractor.extract_multicam(images, orb_cfg)
    if dist is not None:
        feats = extractor.undistort_features(feats, rig.params, dist)
    bank = concat_bands(feats)
    out = track_step_multi(m, bank, R_pred, t_pred, rig_kind, n_cams,
                           rig, img_w, img_h, radius, min_last_kf)
    return out + (bank,)


def _match_bank(m: ms.MapState, bank, R_pred, t_pred, rig_kind: int,
                n_cams: int, rig: RigParams, img_w: float, img_h: float,
                radius, min_last_kf):
    """Project every landmark into every camera band and match.

    Returns (idx [M] bank-global feature id or -1, matched [M] bool) —
    the multi-camera analog of ORBmatcher::SearchByProjection over the
    Nleft/Nright/NSL/NSR bands (reference: src/ORBmatcher.cc:99-331).
    """
    CF = bank["xy"].shape[0]
    F = CF // n_cams

    all_idx = []
    all_dist = []
    for c in range(n_cams):
        uv_proj, lvl, vis_c, dist = mono.project_landmarks(
            m, R_pred, t_pred, rig_kind, rig.params[c], rig.R_cb[c],
            rig.t_cb[c], img_w, img_h)
        vis_c = vis_c & (m.mp_last_kf >= min_last_kf)
        sl = slice(c * F, (c + 1) * F)
        idx_c, dist_c = matcher.match_projection(
            uv_proj, lvl, radius, m.mp_desc, vis_c,
            bank["xy"][sl], bank["level"][sl], bank["desc"][sl],
            bank["valid"][sl], max_dist=matcher.TH_HIGH, ratio=0.9)
        idx_c = matcher.dedup_targets(idx_c, dist_c, F)
        # to bank-global feature ids
        all_idx.append(jnp.where(idx_c >= 0, idx_c + c * F, -1))
        all_dist.append(dist_c)

    # landmark may match in several cameras; keep the best one
    idx_sc = jnp.stack(all_idx, axis=1)       # [M, C]
    dist_sc = jnp.stack(all_dist, axis=1)
    best_c = jnp.argmin(jnp.where(idx_sc >= 0, dist_sc, 1 << 20), axis=1)
    idx = jnp.take_along_axis(idx_sc, best_c[:, None], axis=1)[:, 0]
    return idx, idx >= 0


def _feat_mp_from(idx, keep, CF, M):
    feat_mp = jnp.full((CF,), -1, jnp.int32)
    return feat_mp.at[jnp.where(keep, idx, CF - 1)].max(
        jnp.where(keep, jnp.arange(M, dtype=jnp.int32), -1))


def _compact_matches(matched, cap: int):
    """Exact-capacity compaction of the matched-landmark rows.

    The sequential pose-opt LM (4 rounds x 7 iters) evaluates residuals/
    Jacobians once per iteration; running it over the full M-landmark slab
    made per-frame tracking cost O(slab capacity). Matches are injective
    into each camera's F-feature band, so their count is bounded by C*F —
    compacting once to `cap`=C*F rows cuts EVERY one of the ~28 sequential
    evaluations by M/cap (8x at the flagship 16k slab) for the price of a
    single cumsum-gather.

    Returns (rows [cap] landmark ids, taken [cap] bool).
    """
    M = matched.shape[0]
    order = jnp.cumsum(matched.astype(jnp.int32)) - 1
    keep = matched & (order < cap)
    rows = jnp.zeros((cap + 1,), jnp.int32).at[
        jnp.where(keep, order, cap)].set(
        jnp.arange(M, dtype=jnp.int32))[:cap]
    taken = jnp.arange(cap) < jnp.minimum(
        jnp.sum(matched.astype(jnp.int32)), cap)
    return rows, taken


def _local_map_compact(m: ms.MapState, min_last_kf, cap: int):
    """Gather the <= `cap` most-recently-observed visible landmarks into
    a compact sub-map for per-frame tracking.

    The reference tracks against the LOCAL map — the points of the
    covisible keyframe set (Tracking::UpdateLocalPoints,
    src/Tracking.cc:3462) — never the whole atlas. The masked-dense
    equivalent costs O(M) per frame in the projection, Hamming match and
    every LM residual evaluation, i.e. per-frame time grows with slab
    CAPACITY. One
    top_k by last-observing keyframe + gather fixes the cost at O(cap)
    regardless of map size; landmark ids are mapped back to the full
    slab afterwards.

    Returns (sub_map, inv [cap] global ids, used [cap] mask).
    """
    sel = m.mp_valid & (m.mp_last_kf >= min_last_kf)
    score = jnp.where(sel, m.mp_last_kf, -1)
    _, inv = jax.lax.top_k(score, cap)
    used = score[inv] >= 0
    sub = m._replace(
        mp_pos=m.mp_pos[inv], mp_desc=m.mp_desc[inv],
        mp_normal=m.mp_normal[inv], mp_dmin=m.mp_dmin[inv],
        mp_dmax=m.mp_dmax[inv], mp_valid=used,
        mp_last_kf=m.mp_last_kf[inv], mp_first_kf=m.mp_first_kf[inv],
        mp_visible=m.mp_visible[inv], mp_found=m.mp_found[inv])
    return sub, inv, used


@partial(jax.jit, static_argnames=("rig_kind", "n_cams", "map_cap",
                                   "po_rounds", "po_iters"))
def track_step_multi(m: ms.MapState, bank, R_pred, t_pred,
                     rig_kind: int, n_cams: int, rig: RigParams,
                     img_w: float, img_h: float, radius,
                     min_last_kf=-1, map_cap: int = 0,
                     po_rounds: int = 4, po_iters: int = 7):
    """Local-map projection tracking across all camera bands + pose opt.

    `map_cap` > 0 compacts the tracked landmark set to the cap (see
    _local_map_compact) — per-frame cost O(cap) instead of O(M).
    Returns (R, t, feat_mp [C*F], n_in, vis [M], keep [M]).
    """
    CF = bank["xy"].shape[0]
    M = m.mp_pos.shape[0]
    compact = bool(map_cap) and map_cap < M
    if compact:
        mt_, inv, used = _local_map_compact(m, min_last_kf, map_cap)
        Mt = map_cap
    else:
        mt_, used, Mt = m, m.mp_valid, M
    idx, matched = _match_bank(mt_, bank, R_pred, t_pred, rig_kind,
                               n_cams, rig, img_w, img_h, radius,
                               min_last_kf)
    safe_idx = jnp.where(matched, idx, 0)

    uv_obs = bank["xy"][safe_idx]
    sigma2 = bank["sigma2"][safe_idx]
    cam_idx = bank["cam"][safe_idx]
    # compact matched rows to C*F before the sequential LM (see
    # _compact_matches); inliers scatter back to the M-row mask after
    rows, taken = _compact_matches(matched & used, CF)
    R, t, inlier_c, n_in = pose_opt.pose_optimization(
        R_pred, t_pred, mt_.mp_pos[rows], cam_idx[rows], uv_obs[rows],
        sigma2[rows], taken, rig, rounds=po_rounds,
        iters_per_round=po_iters)
    inlier = jnp.zeros_like(matched).at[rows].max(inlier_c & taken)

    keep = matched & inlier
    feat_mp = _feat_mp_from(idx, keep, CF, Mt)
    vis = matched  # proxy for statistics
    if compact:
        feat_mp = jnp.where(feat_mp >= 0,
                            inv[jnp.maximum(feat_mp, 0)], -1)
        vis = jnp.zeros((M,), bool).at[inv].max(vis & used)
        keep = jnp.zeros((M,), bool).at[inv].max(keep & used)
    return R, t, feat_mp, n_in, vis, keep


@partial(jax.jit, static_argnames=("rig_kind", "n_cams", "map_cap",
                                   "po_rounds", "po_iters"))
def track_step_multi_vi(m: ms.MapState, bank, anchor, state_pred, pre,
                        rig_kind: int, n_cams: int, rig: RigParams,
                        img_w: float, img_h: float, radius,
                        min_last_kf=-1, map_cap: int = 0,
                        po_rounds: int = 4, po_iters: int = 7):
    """VI local-map tracking: match from the IMU-predicted pose, then
    optimize the FULL 15-dof state against visual matches + the
    preintegrated edge to the anchor (last frame) + bias random walk.

    (reference: TrackLocalMap's PoseInertialOptimizationLastFrame,
    src/Optimizer.cc:5580 — the core accuracy mechanism of MAVIS: IMU
    information constrains the per-frame pose, not just its prediction.)
    `map_cap` as in track_step_multi.
    Returns (state: pose_opt.InertialState, feat_mp, n_in, vis, keep).
    """
    CF = bank["xy"].shape[0]
    M = m.mp_pos.shape[0]
    compact = bool(map_cap) and map_cap < M
    if compact:
        mt_, inv, used = _local_map_compact(m, min_last_kf, map_cap)
        Mt = map_cap
    else:
        mt_, used, Mt = m, m.mp_valid, M
    idx, matched = _match_bank(mt_, bank, state_pred.R, state_pred.p,
                               rig_kind, n_cams, rig, img_w, img_h,
                               radius, min_last_kf)
    safe_idx = jnp.where(matched, idx, 0)
    uv_obs = bank["xy"][safe_idx]
    sigma2 = bank["sigma2"][safe_idx]
    cam_idx = bank["cam"][safe_idx]

    # compact matched rows to C*F before the sequential LM (see
    # _compact_matches); inliers scatter back to the M-row mask after
    rows, taken = _compact_matches(matched & used, CF)
    state, inlier_c, n_in = pose_opt.pose_inertial_optimization(
        state_pred, anchor, pre, mt_.mp_pos[rows], cam_idx[rows],
        uv_obs[rows], sigma2[rows], taken, rig, rounds=po_rounds,
        iters_per_round=po_iters)
    inlier = jnp.zeros_like(matched).at[rows].max(inlier_c & taken)

    keep = matched & inlier
    feat_mp = _feat_mp_from(idx, keep, CF, Mt)
    vis = matched
    if compact:
        feat_mp = jnp.where(feat_mp >= 0,
                            inv[jnp.maximum(feat_mp, 0)], -1)
        vis = jnp.zeros((M,), bool).at[inv].max(vis & used)
        keep = jnp.zeros((M,), bool).at[inv].max(keep & used)
    return state, feat_mp, n_in, vis, keep


def _lap(cfg, cam: int):
    """Static (colBegin, colEnd) lapping area of camera `cam`, or None
    when the config declares none (full-width overlap)."""
    if not getattr(cfg, "lapping", ()):
        return None
    return tuple(cfg.lapping[cam])


@partial(jax.jit, static_argnames=("rig_kind", "pair", "n_cams",
                                   "cap_new", "max_depth", "lap1",
                                   "lap2"))
def stereo_spawn(m: ms.MapState, slot, rig_kind: int, n_cams: int,
                 rig: RigParams, pair: tuple, cap_new: int = 512,
                 max_depth: float = 40.0,
                 lap1: tuple | None = None, lap2: tuple | None = None):
    """Triangulate landmarks from one intra-rig camera pair of keyframe
    `slot` (reference: Frame::ComputeMultiFishEyeMatches + KannalaBrandt8::
    TriangulateMatches, src/Frame.cc:1461-1527; the metric-scale source of
    the multi-camera pipeline).

    lap1/lap2: optional (colBegin, colEnd) LAPPING AREAS — only keypoints
    inside the overlapping column range of each camera are stereo
    candidates (reference: the vLapping interval returned by
    ORBextractor::operator() and mvLappingArea in
    KannalaBrandt8.h:96 / Frame.cc:1461-1475 — fisheye pairs overlap
    only partially, and out-of-lap matches are geometry-free).
    """
    c1, c2 = pair
    CF = m.kf_xy.shape[1]
    F = CF // n_cams
    s1 = slice(c1 * F, (c1 + 1) * F)
    s2 = slice(c2 * F, (c2 + 1) * F)

    d1 = m.kf_desc[slot][s1]
    d2 = m.kf_desc[slot][s2]
    un1 = ((m.kf_obs[slot] < 0) & m.kf_feat_valid[slot])[s1]
    un2 = ((m.kf_obs[slot] < 0) & m.kf_feat_valid[slot])[s2]
    if lap1 is not None:
        x1 = m.kf_xy[slot][s1][:, 0]
        un1 = un1 & (x1 >= lap1[0]) & (x1 <= lap1[1])
    if lap2 is not None:
        x2 = m.kf_xy[slot][s2][:, 0]
        un2 = un2 & (x2 >= lap2[0]) & (x2 <= lap2[1])
    idx, hdist = matcher.match_nn(d1, un1, d2, un2, max_dist=64,
                                  ratio=0.85, mutual=True)
    idx = matcher.dedup_targets(idx, hdist, F)
    matched = idx >= 0
    safe = jnp.where(matched, idx, 0)

    # relative pose cam1 <- cam2 from rig extrinsics:
    # p_c1 = R_cb1 R_cb2^T (p_c2 - t_... ) : T_c1c2 = T_c1b * T_bc2
    R_c1b, t_c1b = rig.R_cb[c1], rig.t_cb[c1]
    R_c2b, t_c2b = rig.R_cb[c2], rig.t_cb[c2]
    R12 = R_c1b @ R_c2b.T
    t12 = t_c1b - R12 @ t_c2b

    uv1 = m.kf_xy[slot][s1]
    uv2 = m.kf_xy[slot][s2][safe]
    p1 = jnp.broadcast_to(rig.params[c1], (F, 8))
    p2 = jnp.broadcast_to(rig.params[c2], (F, 8))
    X_c1, depth, tri_ok = triangulation.triangulate_matches(
        rig_kind, p1, p2, jnp.broadcast_to(R12, (F, 3, 3)),
        jnp.broadcast_to(t12, (F, 3)), uv1, uv2,
        sigma_level1=m.kf_sigma2[slot][s1],
        sigma_level2=m.kf_sigma2[slot][s2][safe],
        min_cos_parallax=1.0)   # rig baseline is known-good; skip gate
    good = matched & tri_ok & (depth > 0.05) & (depth < max_depth)

    # cam1 -> world: T_wb * T_bc1
    R_wb, t_wb = m.kf_R[slot], m.kf_t[slot]
    R_wc1 = R_wb @ R_c1b.T
    t_wc1 = t_wb + R_wb @ (-R_c1b.T @ t_c1b)
    X_w = jnp.einsum("ij,fj->fi", R_wc1, X_c1) + t_wc1

    order = jnp.cumsum(good.astype(jnp.int32)) - 1
    M = m.mp_pos.shape[0]
    slot_mp = m.n_mp + order
    write = good & (order < cap_new) & (slot_mp < M)
    tgt = jnp.where(write, slot_mp, M)

    mp_pos = jnp.zeros((M + 1, 3), m.mp_pos.dtype).at[tgt].set(X_w)[:M]
    mp_desc = jnp.zeros((M + 1, 256), jnp.int8).at[tgt].set(d1)[:M]
    newly = jnp.zeros((M + 1,), bool).at[tgt].set(write)[:M]

    # wire observations in both bands
    obs = m.kf_obs[slot]
    obs = obs.at[c1 * F + jnp.arange(F)].set(
        jnp.where(write, slot_mp, obs[s1]))
    obs = obs.at[c2 * F + safe].max(jnp.where(write, slot_mp, -1))
    return m._replace(
        mp_pos=jnp.where(newly[:, None], mp_pos, m.mp_pos),
        mp_desc=jnp.where(newly[:, None], mp_desc, m.mp_desc),
        mp_valid=m.mp_valid | newly,
        mp_first_kf=jnp.where(newly, slot, m.mp_first_kf),
        mp_last_kf=jnp.where(newly, slot, m.mp_last_kf),
        n_mp=m.n_mp + jnp.sum(write.astype(jnp.int32)),
        kf_obs=m.kf_obs.at[slot].set(obs),
    ), jnp.sum(write.astype(jnp.int32))


def _spawn_pair_band(m: ms.MapState, slot_new, slot_ref, cam: int,
                     n_cams: int, rig: RigParams, rig_kind: int,
                     cap_new: int, min_parallax: float = 0.99995,
                     max_depth: float = 60.0):
    """Triangulate new landmarks between the `cam` band of a new KF and the
    same band of one reference KF (temporal baseline).

    (reference: LocalMapping::CreateNewMapPoints searches covisible KFs per
    camera pair — the same-camera pairs across time,
    src/LocalMapping.cc:395-786.)
    """
    CF = m.kf_xy.shape[1]
    F = CF // n_cams
    sl = slice(cam * F, (cam + 1) * F)
    ref_ok = (slot_ref >= 0) & (slot_ref != slot_new)
    slot_ref = jnp.maximum(slot_ref, 0)
    ref_ok = ref_ok & m.kf_valid[slot_ref]

    d1 = m.kf_desc[slot_new][sl]
    d2 = m.kf_desc[slot_ref][sl]
    un1 = ((m.kf_obs[slot_new] < 0) & m.kf_feat_valid[slot_new])[sl]
    un2 = (((m.kf_obs[slot_ref] < 0) & m.kf_feat_valid[slot_ref])[sl]
           & ref_ok)
    idx, hdist = matcher.match_nn(d1, un1, d2, un2, max_dist=64,
                                  ratio=0.9, mutual=True)
    idx = matcher.dedup_targets(idx, hdist, F)
    matched = idx >= 0
    safe = jnp.where(matched, idx, 0)

    # camera `cam` world poses at the two keyframes
    R_cb, t_cb = rig.R_cb[cam], rig.t_cb[cam]
    def cam_pose(slot):
        R_wc = m.kf_R[slot] @ R_cb.T
        t_wc = m.kf_t[slot] + m.kf_R[slot] @ (-R_cb.T @ t_cb)
        return R_wc, t_wc
    R1, t1 = cam_pose(slot_new)
    R2, t2 = cam_pose(slot_ref)
    R12 = R1.T @ R2
    t12 = R1.T @ (t2 - t1)

    uv1 = m.kf_xy[slot_new][sl]
    uv2 = m.kf_xy[slot_ref][sl][safe]
    params = jnp.broadcast_to(rig.params[cam], (F, 8))
    X_c1, depth, tri_ok = triangulation.triangulate_matches(
        rig_kind, params, params,
        jnp.broadcast_to(R12, (F, 3, 3)), jnp.broadcast_to(t12, (F, 3)),
        uv1, uv2,
        sigma_level1=m.kf_sigma2[slot_new][sl],
        sigma_level2=m.kf_sigma2[slot_ref][sl][safe],
        min_cos_parallax=min_parallax)
    good = matched & tri_ok & (depth > 0.05) & (depth < max_depth)

    order = jnp.cumsum(good.astype(jnp.int32)) - 1
    M = m.mp_pos.shape[0]
    slot = m.n_mp + order
    write = good & (order < cap_new) & (slot < M)
    tgt = jnp.where(write, slot, M)

    X_w = jnp.einsum("ij,fj->fi", R1, X_c1) + t1
    mp_pos = jnp.zeros((M + 1, 3), m.mp_pos.dtype).at[tgt].set(X_w)[:M]
    mp_desc = jnp.zeros((M + 1, 256), jnp.int8).at[tgt].set(d1)[:M]
    newly = jnp.zeros((M + 1,), bool).at[tgt].set(write)[:M]

    band = cam * F
    return m._replace(
        mp_pos=jnp.where(newly[:, None], mp_pos, m.mp_pos),
        mp_desc=jnp.where(newly[:, None], mp_desc, m.mp_desc),
        mp_valid=m.mp_valid | newly,
        mp_first_kf=jnp.where(newly, slot_new, m.mp_first_kf),
        mp_last_kf=jnp.where(newly, slot_new, m.mp_last_kf),
        n_mp=m.n_mp + jnp.sum(write.astype(jnp.int32)),
        kf_obs=m.kf_obs
            .at[slot_new, band + jnp.arange(F)].set(
                jnp.where(write, slot, m.kf_obs[slot_new][sl]))
            .at[slot_ref, band + safe].max(jnp.where(write, slot, -1)),
    ), jnp.sum(write.astype(jnp.int32))


@partial(jax.jit, static_argnames=("rig_kind", "n_cams", "cap_new",
                                   "n_refs"))
def temporal_spawn_multi(m: ms.MapState, slot_new, ref_slots,
                         rig_kind: int, n_cams: int, rig: RigParams,
                         cap_new: int, n_refs: int = 2):
    """Temporal triangulation for every camera band against recent KFs
    (reference: LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:395).
    """
    total = jnp.zeros((), jnp.int32)
    for c in range(n_cams):
        for j in range(n_refs):
            m, n = _spawn_pair_band(m, slot_new, ref_slots[j], c, n_cams,
                                    rig, rig_kind, cap_new)
            total = total + n
    # NOTE: callers (kf_insert / the host-policy tracker) run a full
    # update_mp_geometry after the whole spawn/bind/fuse/cull chain —
    # refreshing here too would double the costliest whole-slab scatter
    # pass per keyframe (stereo_spawn likewise defers geometry refresh)
    return m, total


@partial(jax.jit, static_argnames=("rig_kind", "n_cams"))
def bind_landmarks_multi(m: ms.MapState, slot, rig_kind: int, n_cams: int,
                         rig: RigParams, img_w: float, img_h: float,
                         radius: float = 10.0, min_last_kf=-1):
    """Associate the new KF's unbound features (all bands) with existing
    landmarks by per-camera projection search (reference:
    LocalMapping::SearchInNeighbors / ORBmatcher::Fuse,
    src/LocalMapping.cc:786).
    """
    CF = m.kf_xy.shape[1]
    F = CF // n_cams
    M = m.mp_pos.shape[0]
    bound = jnp.zeros((M,), bool).at[
        jnp.where(m.kf_obs[slot] >= 0, m.kf_obs[slot], 0)].max(
        m.kf_obs[slot] >= 0)
    obs = m.kf_obs[slot]
    found = jnp.zeros((M,), jnp.int32)
    touched = jnp.zeros((M,), bool)
    for c in range(n_cams):
        sl = slice(c * F, (c + 1) * F)
        uv_proj, lvl, vis, dist = mono.project_landmarks(
            m, m.kf_R[slot], m.kf_t[slot], rig_kind, rig.params[c],
            rig.R_cb[c], rig.t_cb[c], img_w, img_h)
        vis = vis & (m.mp_last_kf >= min_last_kf) & ~bound
        unbound = (obs[sl] < 0) & m.kf_feat_valid[slot][sl]
        idx, hdist = matcher.match_projection(
            uv_proj, lvl, radius, m.mp_desc, vis,
            m.kf_xy[slot][sl], m.kf_level[slot][sl],
            m.kf_desc[slot][sl], unbound,
            max_dist=matcher.TH_LOW, ratio=0.9)
        idx = matcher.dedup_targets(idx, hdist, F)
        keep = idx >= 0
        band_obs = obs[sl].at[jnp.where(keep, idx, F - 1)].max(
            jnp.where(keep, jnp.arange(M, dtype=jnp.int32), -1))
        obs = obs.at[c * F + jnp.arange(F)].set(band_obs)
        tgt = jnp.where(keep, jnp.arange(M), M)
        found = found + jnp.zeros((M + 1,), jnp.int32).at[tgt].add(1)[:M]
        touched = touched | jnp.zeros((M + 1,), bool).at[tgt].set(keep)[:M]
        bound = bound | jnp.zeros((M,), bool).at[
            jnp.where(keep, jnp.arange(M), 0)].max(keep)
    return m._replace(kf_obs=m.kf_obs.at[slot].set(obs),
                      mp_found=m.mp_found + found,
                      mp_last_kf=jnp.where(touched, slot, m.mp_last_kf))


@partial(jax.jit, static_argnames=("rig_kind", "stages"))
def vi_window_ba_step(m: ms.MapState, ids, kf_in, pre_b, edge_ok,
                      last, rig_kind: int, rig: RigParams,
                      stages=(4, 6)):
    """VI window BA over a fixed-size keyframe window with the temporal
    inertial chain, as one device program (reference: LocalInertialBA,
    src/Optimizer.cc:4763).

    Args:
      ids [W]: window keyframe slots (padded entries repeat the newest);
      kf_in [W]: padded-entry mask;
      pre_b: batched Preintegrated [W-1] (identity for padded edges);
      edge_ok [W-1]: edge mask; last: index of the newest window entry.
    Returns (m', bias' [6]).
    """
    from ..optim import global_ba

    K, CF = m.kf_obs.shape
    W = ids.shape[0]
    edges = ba.InertialEdges(pre=pre_b, valid=edge_ok)
    kf_local = jnp.repeat(jnp.arange(W), CF)
    slots = ids[kf_local]
    featix = jnp.tile(jnp.arange(CF), W)
    mp = m.kf_obs[slots, featix]
    valid = ((mp >= 0) & m.kf_feat_valid[slots, featix]
             & kf_in[kf_local])
    mp_safe = jnp.where(valid, mp, 0)
    valid = valid & m.mp_valid[mp_safe]
    # --- window-local landmark compaction (same pattern as the mono
    # local_ba_step): the dense Schur coupling scales with the landmark
    # capacity — over the FULL map (M=16384 at flagship) it materializes a
    # [W*M, 6, 3] (170 MB) Hpl by scatter-add per LM iteration. Compacting to the <= ML window-observed
    # landmarks keeps the EXACT dense solve (a matrix-free PCG variant
    # measurably under-converges on weakly-conditioned mono-inertial
    # windows) at a fraction of the tensors.
    M = m.mp_pos.shape[0]
    ML = min(M, 4096)
    seen = jnp.zeros((M,), bool).at[mp_safe].max(valid)
    order = jnp.cumsum(seen.astype(jnp.int32)) - 1
    keep = seen & (order < ML)
    inv = jnp.zeros((ML + 1,), jnp.int32).at[
        jnp.where(keep, order, ML)].set(jnp.arange(M))[:ML]
    n_local = jnp.minimum(jnp.sum(seen.astype(jnp.int32)), ML)
    used = jnp.arange(ML) < n_local
    valid = valid & keep[mp_safe]
    obs = ba.BAObservations(
        kf=kf_local, mp=jnp.where(valid, order[mp_safe], 0),
        cam=m.kf_cam[slots, featix],
        uv=m.kf_xy[slots, featix], sigma2=m.kf_sigma2[slots, featix],
        valid=valid)
    state0 = ba.BAState(
        R=m.kf_R[ids], t=m.kf_t[ids], v=m.kf_v[ids],
        bg=m.kf_bg[ids], ba=m.kf_ba[ids], points=m.mp_pos[inv])
    fixed = (jnp.arange(W) < 1) | ~kf_in
    state, inlier, chi = ba.bundle_adjust(
        state0, obs, rig, fixed, point_fixed=~used,
        edges=edges, stages=stages, rows_per_kf=CF)
    good = jnp.isfinite(chi)
    # dump-slot scatter: padded window entries (duplicate ids) write to
    # the K-th row of an extended slab and are sliced away, so they can
    # never race the real update of the newest slot
    ids_w = jnp.where(kf_in & good, ids, K)

    def wr(slab, vals):
        ext = jnp.concatenate([slab, slab[:1]], axis=0)
        return ext.at[ids_w].set(vals)[:K]

    m = m._replace(
        kf_R=wr(m.kf_R, state.R), kf_t=wr(m.kf_t, state.t),
        kf_v=wr(m.kf_v, state.v), kf_bg=wr(m.kf_bg, state.bg),
        kf_ba=wr(m.kf_ba, state.ba),
        # compacted points scatter back through inv; unused local slots
        # target index M (out of bounds -> dropped by the default scatter)
        mp_pos=m.mp_pos.at[jnp.where(used & good, inv, M)].set(
            state.points),
        kf_obs=jnp.concatenate([m.kf_obs, m.kf_obs[:1]], axis=0).at[
            jnp.where(kf_in[kf_local] & good, slots, K), featix].set(
            jnp.where(valid & ~inlier, -1,
                      m.kf_obs[slots, featix]))[:K],
    )
    bias = jnp.where(good,
                     jnp.concatenate([state.bg[last], state.ba[last]]),
                     jnp.concatenate([state0.bg[last], state0.ba[last]]))
    return m, bias


@partial(jax.jit, static_argnames=("rig_kind", "fix_scale", "obs_cap"))
def imu_init_step(m: ms.MapState, pre_b, edge_valid, bias, first,
                  prior_g, prior_a, rig_kind: int, fix_scale: bool,
                  rig: RigParams, obs_cap: int = 131072):
    """One stage of the staged IMU initialization as ONE device program:
    InertialOptimization (scale/gravity/bias/velocities, poses fixed) ->
    gravity-align + scale the map -> whole-map FullInertialBA, gated on
    the solve being sane.

    (reference: LocalMapping::InitializeIMU src/LocalMapping.cc:1255 with
    the decaying-prior VIBA schedule at 203-265; Map::ApplyScaledRotation
    src/LocalMapping.cc:1367; Optimizer::FullInertialBA
    src/Optimizer.cc:368.)

    Operates on the FULL keyframe slab with `edge_valid` masking so every
    stage of every tracker reuses one compiled program.
    Args: pre_b [K-1] batched Preintegrated; first: warm-start switch
    (True only on the initial stage); prior_g/prior_a: traced priors.
    Returns (m', bias' [6], ok).
    """
    from ..optim import global_ba

    K, CF = m.kf_obs.shape
    warm_v, warm_Rwg = inertial_init.initial_gravity_velocity(
        m.kf_R, m.kf_t, pre_b, edge_valid)
    v0 = jnp.where(first, warm_v, m.kf_v)
    R_wg0 = jnp.where(first, warm_Rwg, jnp.eye(3))
    bias0 = jnp.where(first, jnp.zeros(6), bias)
    res = inertial_init.inertial_optimization(
        m.kf_R, m.kf_t, v0, pre_b, edge_valid, fix_scale=fix_scale,
        prior_g=prior_g, prior_a=prior_a, R_wg0=R_wg0, bias0=bias0)
    ok = jnp.isfinite(res.chi2) & (res.scale > 0.1)

    def apply(m, bias):
        R_gw = res.R_wg.T
        Rn, pn, _, ptn = inertial_init.apply_scaled_rotation(
            m.kf_R, m.kf_t, m.kf_v, m.mp_pos, R_gw, res.scale)
        vn = jnp.einsum("ij,kj->ki", R_gw, res.v)
        kf_in = m.kf_valid
        m = m._replace(
            kf_R=jnp.where(kf_in[:, None, None], Rn, m.kf_R),
            kf_t=jnp.where(kf_in[:, None], pn, m.kf_t),
            kf_v=jnp.where(kf_in[:, None], vn, m.kf_v),
            mp_pos=jnp.where(m.mp_valid[:, None], ptn, m.mp_pos),
            kf_bg=jnp.tile(res.bg, (K, 1)),
            kf_ba=jnp.tile(res.ba, (K, 1)))
        bias_new = jnp.concatenate([res.bg, res.ba])

        # whole-map FullInertialBA (matrix-free Schur+PCG); the
        # observation table is compacted to valid rows so the event cost
        # follows map CONTENT, not slab capacity (see
        # tracking.full_map_observations)
        obs, observed, kf_local, feat = mono.full_map_observations(
            m, obs_cap)
        valid = obs.valid
        mp_safe = obs.mp
        # re-linearize the chain at the refreshed bias (first-order
        # Reintegrate analog)
        pre2 = jax.vmap(pre_mod.rebias, in_axes=(0, None))(pre_b,
                                                           bias_new)
        edges = ba.InertialEdges(pre=pre2, valid=edge_valid)
        state0 = ba.BAState(
            R=m.kf_R, t=m.kf_t, v=m.kf_v, bg=m.kf_bg, ba=m.kf_ba,
            points=m.mp_pos)
        fixed = (jnp.arange(K) < 1) | ~m.kf_valid
        # sequential-depth budget: each LM iteration costs cg_iters
        # latency-bound CG matvecs (the scatter/gather ops of the
        # matrix-free operator); (6,8)x32 = 448 sequential steps made the
        # init a multi-second event. (3,4)x12 converges
        # within the staged-init tolerance — the VIBA1/VIBA2 refinement
        # stages re-solve with better linearization anyway (reference
        # schedule: LocalMapping.cc:224-265).
        state, inlier, chi = global_ba.global_bundle_adjust(
            state0, obs, rig, fixed, point_fixed=~observed,
            edges=edges, stages=(3, 4), cg_iters=12)
        good = jnp.isfinite(chi)
        upd = m.kf_valid & good
        m = m._replace(
            kf_R=jnp.where(upd[:, None, None], state.R, m.kf_R),
            kf_t=jnp.where(upd[:, None], state.t, m.kf_t),
            kf_v=jnp.where(upd[:, None], state.v, m.kf_v),
            kf_bg=jnp.where(upd[:, None], state.bg, m.kf_bg),
            kf_ba=jnp.where(upd[:, None], state.ba, m.kf_ba),
            mp_pos=jnp.where((observed & good)[:, None], state.points,
                             m.mp_pos),
            kf_obs=jnp.where(good, m.kf_obs.at[kf_local, feat].set(
                jnp.where(valid & ~inlier, -1,
                          m.kf_obs[kf_local, feat])), m.kf_obs))
        m = ms.update_mp_geometry(m, None)
        return m, bias_new

    m, bias = jax.lax.cond(ok, apply, lambda m, b: (m, b), m, bias)
    return m, bias, ok


@dataclass
class MultiTrackerConfig:
    img_w: int = 640
    img_h: int = 480
    n_cams: int = 4
    stereo_pairs: tuple = ((0, 1),)    # overlapping rig pairs
    # per-camera (colBegin, colEnd) stereo lapping areas; () = full width
    # (reference: CameraN.overlappingBegin/End, mvLappingArea)
    lapping: tuple = ()
    orb: extractor.OrbConfig = field(default_factory=extractor.OrbConfig)
    max_kf: int = 64
    max_mp: int = 16384
    match_radius: float = 15.0
    relost_radius: float = 30.0
    # frames to keep the wide search window after recovering from LOST
    # (reference: doubled search th when recently relocalized,
    # src/Tracking.cc:2020-2060)
    reentry_boost_frames: int = 5
    min_inliers_track: int = 30
    local_map_window: Optional[int] = None
    fused_frontend: bool = False
    kf_min_inlier_frac: float = 0.75
    kf_min_inliers_abs: int = 120
    kf_max_interval_s: float = 0.5     # inertial KF cadence (Tracking.cc:3003)
    new_mp_cap: int = 384
    ba_window: int = 8
    imu_freq: float = 200.0
    imu_buf: int = 256                 # max samples between keyframes
    imu_init_kfs: int = 8              # KFs before IMU initialization
    use_imu: bool = True
    # VIBA refinement schedule, seconds after the first keyframe
    # (reference: VIBA1 at mTinit>5s, VIBA2 at >15s, LocalMapping.cc:224-265)
    viba1_time: float = 5.0
    viba2_time: float = 15.0
    # mono-inertial two-view initialization thresholds
    init_min_matches: int = 80
    init_min_inliers: int = 50
    # temporal triangulation: reference KFs per camera band
    temporal_refs: int = 2
    # frames to coast in LOST before abandoning the map and spawning a
    # fresh one in the Atlas (reference: CreateMapInAtlas,
    # src/Tracking.cc:1953-1968)
    max_lost_frames: int = 20
    # external per-camera depth priors (reference: depth maps sampled at
    # undistorted keypoints into pseudo-stereo, src/Frame.cc:1659-1765):
    # process_frame takes a [C, H, W] z-depth stack; unbound keyframe
    # features spawn metric landmarks from it (frontend/depth.py)
    use_depth: bool = False
    depth_cap: int = 256
    depth_max: float = 25.0
    depth_pin: tuple = ()     # per-cam virtual pinhole; () = raw frame

    @property
    def metric_scale(self) -> bool:
        """True when the rig baseline provides metric scale (any stereo
        pair) or depth priors do; mono-inertial estimates scale in the
        IMU init instead."""
        return len(self.stereo_pairs) > 0 or self.use_depth


class MultiTracker:
    """Multi-camera (optionally inertial) tracker."""

    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2

    def __init__(self, rig: RigParams, cfg: MultiTrackerConfig,
                 noise: pre_mod.ImuNoise | None = None, seed: int = 0,
                 loop_closer=None, atlas=None, dist=None):
        self.rig = rig
        self.cfg = cfg
        # optional [C, 4] radtan distortion of a distorted-pinhole rig
        # (reference: Frame::UndistortKeyPoints)
        self.dist = None if dist is None else jnp.asarray(dist)
        self.noise = noise or pre_mod.ImuNoise.from_sigmas(
            1.7e-4, 2e-3, 1.9e-5, 3e-3, cfg.imu_freq)
        self.loop_closer = loop_closer
        self.atlas = atlas
        self.state = self.NOT_INITIALIZED
        CF = cfg.n_cams * cfg.orb.n_features
        if atlas is not None:
            if not atlas.maps:
                atlas.create_map(cfg.max_kf, CF, cfg.max_mp)
            self.map = atlas.current_map
            self.map_id = atlas.current
        else:
            self.map = ms.allocate(cfg.max_kf, CF, cfg.max_mp)
            self.map_id = 0
        self.lost_frames = 0
        # localization-only: track, never extend the map
        # (reference: ActivateLocalizationMode, System.h:132)
        self.localization_only = False
        # preintegration chains of parked maps, keyed by atlas map index
        self._parked_pre = {}
        self.key = jax.random.PRNGKey(seed)
        self.R = jnp.eye(3)
        self.t = jnp.zeros(3)
        self.v = jnp.zeros(3)
        self.bias = jnp.zeros(6)
        self.vel_R = jnp.eye(3)
        self.vel_t = jnp.zeros(3)
        self.imu_initialized = False
        self._reentry_boost = 0
        # staged init bookkeeping: 0 = not initialized, 1 = initial stage
        # done, 2 = VIBA1 done, 3 = VIBA2 done (reference schedule at
        # src/LocalMapping.cc:224-265)
        self.viba_stage = 0
        self.first_kf_time = None
        self.last_kf_slot = -1
        self.last_kf_time = None
        self.last_time = None
        self.ref_kf_inliers = 0
        self.n_kf = 0
        self.trajectory = []
        self._init_bank = None          # mono-inertial two-view reference
        self._init_time = None
        # IMU queues (host): samples since last frame and since last KF
        self._imu_frame = []
        self._imu_kf = []
        # per-KF preintegrations (list of Preintegrated, index = KF slot)
        self.kf_pre = []
        def _ext(im, dist=self.dist, rig_p=rig.params):
            feats = extractor.extract_multicam(im, cfg.orb)
            if dist is not None:
                feats = extractor.undistort_features(feats, rig_p, dist)
            return feats
        self._ext = jax.jit(_ext)

    # -- IMU ---------------------------------------------------------------
    def feed_imu(self, w, a, t):
        """Queue one IMU sample (gyro rad/s, accel m/s^2, timestamp)."""
        self._imu_frame.append((np.asarray(w, np.float32),
                                np.asarray(a, np.float32), float(t)))
        self._imu_kf.append(self._imu_frame[-1])

    def _integrate(self, queue, t_end, t_start):
        n = self.cfg.imu_buf
        ws = np.zeros((n, 3), np.float32)
        accs = np.zeros((n, 3), np.float32)
        dts = np.zeros((n,), np.float32)
        prev_t = t_start
        j = 0
        for (w, a, t) in queue:
            if t <= t_start or j >= n:
                continue
            dt = min(t, t_end) - prev_t
            if dt <= 0:
                continue
            ws[j], accs[j], dts[j] = w, a, dt
            prev_t = min(t, t_end)
            j += 1
        if j < n and prev_t < t_end and j > 0:
            ws[j], accs[j] = ws[j - 1], accs[j - 1]
            dts[j] = t_end - prev_t
        return pre_mod.integrate(jnp.asarray(ws), jnp.asarray(accs),
                                 jnp.asarray(dts), self.bias, self.noise)

    # -- main --------------------------------------------------------------
    def process_frame(self, images: jnp.ndarray, time: float,
                      depth=None):
        """images: [C, H, W] float32; depth: [C, H, W] z-depth stack
        (cfg.use_depth rigs only)."""
        cfg = self.cfg
        if cfg.use_depth:
            if depth is None:
                raise ValueError("cfg.use_depth=True but process_frame "
                                 "got no depth stack")
            self._depth_cur = jnp.asarray(depth)

        if self.state == self.NOT_INITIALIZED:
            bank = concat_bands(self._ext(images))
            ok = self._initialize(bank, time)
            self._record(time)
            self.last_time = time
            self._imu_frame = []
            return ok

        # frame-interval preintegration (always, when inertial — needed
        # both for prediction and for the VI pose optimization edge)
        pre_f = None
        if cfg.use_imu and self._imu_frame and self.last_time is not None:
            pre_f = self._integrate(self._imu_frame, time, self.last_time)
        self._imu_frame = []

        # pose prediction: IMU if available+initialized, else const velocity
        if self.imu_initialized and pre_f is not None:
            R_pred, t_pred, v_pred = pre_mod.predict_state(
                self.R, self.t, self.v, pre_f, self.bias)
        else:
            R_pred = self.R @ self.vel_R
            t_pred = self.t + self.R @ self.vel_t
            v_pred = self.v

        # relocalization attempt when LOST (reference: Tracking.cc:3543)
        if self.state == self.LOST and self.n_kf >= 2:
            bank0 = concat_bands(self._ext(images))
            self.key, sub = jax.random.split(self.key)
            ok_r, R_r, t_r, n_r = mono.relocalize_step(
                self.map, self._band0_feats(bank0), sub, self.rig.kind,
                self.rig)
            if bool(ok_r):
                R_pred, t_pred = R_r, t_r
                self.vel_R = jnp.eye(3)
                self.vel_t = jnp.zeros(3)
        else:
            bank0 = None

        min_last = (-1 if cfg.local_map_window is None
                    else self.last_kf_slot - cfg.local_map_window)
        # post-recovery boost: after a LOST episode the pose/velocity are
        # only roughly re-anchored, so search with the wide window for a
        # few frames (reference: Tracking::TrackWithMotionModel doubles th
        # when recently relocalized, src/Tracking.cc:2020-2060)
        radius = (cfg.relost_radius if self._reentry_boost > 0
                  else cfg.match_radius)
        use_vi = self.imu_initialized and pre_f is not None
        if use_vi:
            bank = bank0 if bank0 is not None else concat_bands(
                self._ext(images))
            anchor = pose_opt.InertialState(
                R=self.R, p=self.t, v=self.v,
                bg=self.bias[:3], ba=self.bias[3:])
            pred = pose_opt.InertialState(
                R=R_pred, p=t_pred, v=v_pred,
                bg=self.bias[:3], ba=self.bias[3:])
            st, feat_mp, n_in, vis, keep = track_step_multi_vi(
                self.map, bank, anchor, pred, pre_f, self.rig.kind,
                cfg.n_cams, self.rig, float(cfg.img_w), float(cfg.img_h),
                cfg.match_radius, min_last)
            R, t = st.R, st.p
        elif cfg.fused_frontend:
            R, t, feat_mp, n_in, vis, keep, bank = frame_step_multi(
                self.map, images, R_pred, t_pred, self.rig.kind,
                cfg.n_cams, self.rig, cfg.orb, float(cfg.img_w),
                float(cfg.img_h), radius, min_last, self.dist)
        else:
            bank = bank0 if bank0 is not None else concat_bands(
                self._ext(images))
            R, t, feat_mp, n_in, vis, keep = track_step_multi(
                self.map, bank, R_pred, t_pred, self.rig.kind,
                cfg.n_cams, self.rig, float(cfg.img_w),
                float(cfg.img_h), radius, min_last)
        n_in = int(n_in)
        if n_in < cfg.min_inliers_track:
            # wide visual retry from the last confirmed pose
            R, t, feat_mp, n_in, vis, keep = track_step_multi(
                self.map, bank, self.R, self.t, self.rig.kind, cfg.n_cams,
                self.rig, float(cfg.img_w), float(cfg.img_h),
                cfg.relost_radius)
            n_in = int(n_in)
            if n_in >= cfg.min_inliers_track:
                self._reentry_boost = cfg.reentry_boost_frames
            if n_in < cfg.min_inliers_track:
                self.state = self.LOST
                self.lost_frames += 1
                if self.imu_initialized and pre_f is not None:
                    # RECENTLY_LOST: coast on the IMU prediction so the
                    # pose stays usable for relocalization / re-entry
                    # (reference: Tracking.cc:1929-1940)
                    self.R, self.t, self.v = R_pred, t_pred, v_pred
                if (self.atlas is not None
                        and self.lost_frames > cfg.max_lost_frames
                        and self.n_kf >= 2):
                    # park the map and start fresh (reference:
                    # CreateMapInAtlas, src/Tracking.cc:1953-1968)
                    self._spawn_new_map()
                self._record(time)
                self.last_time = time
                return False
            use_vi = False

        dt = max(time - (self.last_time if self.last_time is not None
                         else time - 1e-3), 1e-3)
        self.vel_R = self.R.T @ R
        self.vel_t = self.R.T @ (t - self.t)
        if use_vi:
            self.v = st.v
            self.bias = jnp.concatenate([st.bg, st.ba])
        else:
            self.v = (t - self.t) / dt
        self.R, self.t = R, t
        if self.state == self.LOST:
            self._reentry_boost = cfg.reentry_boost_frames
        elif self._reentry_boost > 0:
            self._reentry_boost -= 1
        self.state = self.OK
        self.lost_frames = 0

        need_kf = (n_in < cfg.kf_min_inlier_frac
                   * max(self.ref_kf_inliers, 1)
                   or n_in < cfg.kf_min_inliers_abs
                   or (cfg.use_imu and self.last_kf_time is not None
                       and time - self.last_kf_time > cfg.kf_max_interval_s))
        if need_kf and not self.localization_only:
            if self.n_kf >= cfg.max_kf:
                self._recycle_slots()
            if self.n_kf < cfg.max_kf:
                self._insert_keyframe(bank, time, feat_mp, n_in)

        self._record(time)
        self.last_time = time
        return True

    def _record(self, time):
        # store frame pose RELATIVE to the latest keyframe so later map
        # corrections (IMU-init rotation, loop closure, GBA) retroactively
        # fix the whole trajectory (reference: Tracking keeps
        # mlRelativeFramePoses and System::SaveTrajectoryEuRoC replays them
        # against final KF poses, src/System.cc:717-1090)
        ref = max(self.last_kf_slot, 0)
        R_ref = np.asarray(self.map.kf_R[ref])
        t_ref = np.asarray(self.map.kf_t[ref])
        R_rel = R_ref.T @ np.asarray(self.R)
        t_rel = R_ref.T @ (np.asarray(self.t) - t_ref)
        self.trajectory.append((time, self.map_id, ref, R_rel, t_rel))

    def get_trajectory(self):
        """Reconstruct (times, R [T,3,3], t [T,3]) vs the FINAL map(s)."""
        maps = self.atlas.maps if self.atlas is not None else [self.map]
        if self.atlas is not None:
            self._sync_atlas()
        kf_R = [np.asarray(m.kf_R) for m in maps]
        kf_t = [np.asarray(m.kf_t) for m in maps]
        times, Rs, ts = [], [], []
        for (tm, mid, ref, R_rel, t_rel) in self.trajectory:
            R = kf_R[mid][ref] @ R_rel
            t = kf_t[mid][ref] + kf_R[mid][ref] @ t_rel
            times.append(tm)
            Rs.append(R)
            ts.append(t)
        return np.asarray(times), np.stack(Rs), np.stack(ts)

    # -- Atlas bookkeeping ---------------------------------------------------
    def _sync_atlas(self):
        if self.atlas is not None:
            self.atlas.maps[self.map_id] = self.map

    def _spawn_new_map(self):
        """Park the current map + its preintegration chain; start fresh.
        IMU re-initializes in the new map (the reference resets its
        IMU-init flags in CreateMapInAtlas); the current bias estimate is
        kept as the starting guess."""
        cfg = self.cfg
        self._sync_atlas()
        self._parked_pre[self.map_id] = self.kf_pre
        CF = cfg.n_cams * cfg.orb.n_features
        self.map_id = self.atlas.create_map(cfg.max_kf, CF, cfg.max_mp)
        self.map = self.atlas.current_map
        self.state = self.NOT_INITIALIZED
        self.R = jnp.eye(3)
        self.t = jnp.zeros(3)
        self.v = jnp.zeros(3)
        self.vel_R = jnp.eye(3)
        self.vel_t = jnp.zeros(3)
        self.imu_initialized = False
        self.last_kf_slot = -1
        self.last_kf_time = None
        self.n_kf = 0
        self.ref_kf_inliers = 0
        self.lost_frames = 0
        self.kf_pre = []
        self._imu_kf = []

    def _remap_after_merge(self, old_map_id, new_map_id, kf_off):
        fixed = []
        for (tm, mid, ref, R_rel, t_rel) in self.trajectory:
            if mid == old_map_id:
                fixed.append((tm, new_map_id, ref + kf_off, R_rel, t_rel))
            else:
                mid2 = mid - 1 if mid > old_map_id else mid
                fixed.append((tm, mid2, ref, R_rel, t_rel))
        self.trajectory = fixed
        # weld preintegration chains: the parked (older) map's chain fills
        # slots [0, kf_off); this map's chain follows (reference:
        # MergeLocal2 keeps both temporal chains, src/LoopClosing.cc:1956)
        parked = dict(self._parked_pre)
        self._parked_pre = {}
        for mid, pres in parked.items():
            mid2 = mid - 1 if mid > old_map_id else mid
            if mid2 == new_map_id:
                chain = list(pres) + [None] * (kf_off - len(pres))
                self.kf_pre = chain[:kf_off] + self.kf_pre
            elif mid != old_map_id:
                self._parked_pre[mid2] = pres
        # MergeInertialBA analog (reference: src/Optimizer.cc:4365, run by
        # MergeLocal2 after the weld): with the chains welded, optimize the
        # merged map with the full inertial edge set. The seam interval
        # (last parked KF -> first welded KF) has no preintegration — its
        # edge simply stays invalid, exactly the reference's broken-chain
        # handling across sessions.
        if self.imu_initialized:
            pre_b, cvalid = self._kf_pre_batch(self.cfg.max_kf)
            cvalid = cvalid & (jnp.arange(1, self.cfg.max_kf)
                               < self.map.n_kf)
            self.map, _ = mono.global_inertial_ba_step(
                self.map, pre_b, cvalid, self.rig.kind, self.rig)
            self._sync_atlas()

    def _recycle_slots(self):
        """Compact the keyframe/landmark slabs when full (see
        Tracker._recycle_slots), additionally welding the temporal
        preintegration chain across dropped keyframes — the reference's
        IMU::Preintegrated::MergePrevious (src/ImuTypes.cc:241-263),
        realized as closed-form composition of the adjoining intervals."""
        m = self.map
        if int(m.kf_valid.sum()) >= self.cfg.max_kf:
            m, _ = ms.decimate_keyframes(m, self.n_kf - 1)
            self.map = m
        kf_valid = np.asarray(self.map.kf_valid)
        self.map, self.trajectory, old_of_new, new_of_old, _ = \
            mono.recycle_map_slots(self.map, self.trajectory, self.map_id)
        # weld the preintegration chain: new interval k covers everything
        # between consecutive SURVIVING keyframes, i.e. the composition of
        # all old intervals in (old_of_new[k-1], old_of_new[k]].
        old_pre = self.kf_pre
        n_new = int(self.map.n_kf)
        new_pre: list = [None] * n_new
        prev_old = -1
        for k in range(n_new):
            cur_old = int(old_of_new[k])
            acc = None
            for j in range(prev_old + 1, cur_old + 1):
                p = old_pre[j] if j < len(old_pre) else None
                if p is None:
                    continue
                acc = p if acc is None else pre_mod.compose(acc, p)
            new_pre[k] = acc
            prev_old = cur_old
        self.kf_pre = new_pre
        if self.last_kf_slot >= 0 and kf_valid[self.last_kf_slot]:
            self.last_kf_slot = int(new_of_old[self.last_kf_slot])
        else:
            self.last_kf_slot = n_new - 1
        self.n_kf = n_new
        self._sync_atlas()

    def _band0_feats(self, bank) -> extractor.Features:
        """View of a bank's camera-0 band as single-camera Features."""
        F = self.cfg.orb.n_features
        sl = slice(0, F)
        return extractor.Features(
            xy=bank["xy"][sl], response=jnp.zeros((F,)),
            angle=jnp.zeros((F,)), level=bank["level"][sl],
            sigma2=bank["sigma2"][sl], desc=bank["desc"][sl],
            valid=bank["valid"][sl])

    def _initialize(self, bank, time):
        """Initialization dispatch: rigs with overlapping pairs triangulate
        the first frame directly (metric); mono-inertial runs two-view
        reconstruction and recovers scale later in the IMU init."""
        if not self.cfg.stereo_pairs and not self.cfg.use_depth:
            return self._initialize_mono(bank, time)
        return self._initialize_rig(bank, time)

    def _initialize_mono(self, bank, time):
        """Two-view monocular init on the camera-0 band (reference:
        Tracking::MonocularInitialization, src/Tracking.cc:2411 — the
        IMU_MONOCULAR entry; scale comes later from InertialOptimization
        with fix_scale=False)."""
        from ..solvers import two_view
        cfg = self.cfg
        F = cfg.orb.n_features
        if self._init_bank is None:
            self._init_bank, self._init_time = bank, time
            return False
        b0 = self._init_bank
        idx, hdist = matcher.match_nn(
            bank["desc"][:F], bank["valid"][:F],
            b0["desc"][:F], b0["valid"][:F],
            max_dist=matcher.TH_LOW, ratio=0.9, mutual=True)
        if int((idx >= 0).sum()) < cfg.init_min_matches:
            self._init_bank, self._init_time = bank, time
            return False

        def bearing_z1(b):
            ray = cameras.unproject(self.rig.kind, self.rig.params[0],
                                    b["xy"][:F])
            z = jnp.maximum(ray[:, 2], 1e-6)
            return ray[:, :2] / z[:, None]

        matched = idx >= 0
        safe = jnp.where(matched, idx, 0)
        self.key, sub = jax.random.split(self.key)
        res = two_view.reconstruct(
            sub, bearing_z1(b0)[safe], bearing_z1(bank), matched,
            focal=float(self.rig.params[0, 0]),
            min_inliers=cfg.init_min_inliers)
        if not bool(res.success):
            return False
        good = np.asarray(res.is_good)
        depths = np.asarray(res.points)[:, 2]
        med = float(np.median(depths[good])) if good.any() else 1.0
        scale = 1.0 / max(med, 1e-6)
        pts_c0 = np.asarray(res.points) * scale
        R01 = np.asarray(res.R)
        t01 = np.asarray(res.t) * scale
        R_w1, t_w1 = R01.T, -R01.T @ t01

        CF = bank["xy"].shape[0]
        M = cfg.max_mp
        order = np.cumsum(good) - 1
        slot_np = np.where(good, order, -1).astype(np.int32)
        obs1 = np.full((CF,), -1, np.int32)
        obs1[:F] = slot_np
        obs0 = np.full((CF,), -1, np.int32)
        idx_np = np.asarray(idx)
        sel = good & (idx_np >= 0)
        obs0[idx_np[sel]] = slot_np[sel]
        n_new = int(good.sum())

        m = self.map
        write = jnp.asarray(good) & (jnp.asarray(order) < M)
        tgt = jnp.where(write, jnp.asarray(slot_np), M)
        mp_pos = jnp.zeros((M + 1, 3)).at[tgt].set(
            jnp.asarray(pts_c0))[:M]
        mp_desc = jnp.zeros((M + 1, 256), jnp.int8).at[tgt].set(
            bank["desc"][:F])[:M]
        newly = jnp.zeros((M + 1,), bool).at[tgt].set(write)[:M]
        m = m._replace(
            mp_pos=jnp.where(newly[:, None], mp_pos, m.mp_pos),
            mp_desc=jnp.where(newly[:, None], mp_desc, m.mp_desc),
            mp_valid=newly, n_mp=jnp.asarray(n_new, jnp.int32))
        z3 = jnp.zeros(3)
        m = ms.insert_keyframe(
            m, 0, jnp.eye(3), z3, z3, z3, z3, self._init_time,
            b0["xy"], b0["desc"], b0["level"], b0["sigma2"], b0["cam"],
            b0["valid"], jnp.asarray(obs0))
        m = ms.insert_keyframe(
            m, 1, jnp.asarray(R_w1), jnp.asarray(t_w1), z3, z3, z3, time,
            bank["xy"], bank["desc"], bank["level"], bank["sigma2"],
            bank["cam"], bank["valid"], jnp.asarray(obs1))
        m = ms.update_mp_geometry(m, None)
        self.map, _ = mono.local_ba_step(m, jnp.asarray(1), self.rig.kind,
                                         self.rig, window=2)
        self.R = jnp.asarray(R_w1)
        self.t = jnp.asarray(t_w1)
        self.last_kf_slot = 1
        self.last_kf_time = time
        self.first_kf_time = self._init_time
        self.n_kf = 2
        self.ref_kf_inliers = n_new
        # KF0 has no preceding interval; KF0->KF1 covers the init gap
        if cfg.use_imu and self._imu_kf and self._init_time is not None:
            self.kf_pre = [None, self._integrate(self._imu_kf, time,
                                                 self._init_time)]
        else:
            self.kf_pre = [None, None]
        self._imu_kf = []
        self._init_bank = None
        self.state = self.OK
        return True

    def _initialize_rig(self, bank, time):
        """Multi-camera init: stereo-triangulate the first frame directly
        (reference: MultiInitialization, Tracking.cc:2339 — metric scale
        from the rig baseline, no two-view RANSAC needed)."""
        cfg = self.cfg
        z3 = jnp.zeros(3)
        CF = bank["xy"].shape[0]
        m = ms.insert_keyframe(
            self.map, 0, jnp.eye(3), z3, z3, z3, z3, time,
            bank["xy"], bank["desc"], bank["level"], bank["sigma2"],
            bank["cam"], bank["valid"],
            jnp.full((CF,), -1, jnp.int32))
        total = 0
        if cfg.use_depth:
            m, n_new = depth_mod.spawn_from_depth_multi(
                m, jnp.asarray(0), self.rig.kind, cfg.n_cams, self.rig,
                self._depth_cur, pin_params=cfg.depth_pin or None,
                cap_new=cfg.depth_cap, max_spawn_depth=cfg.depth_max)
            total += int(n_new)
        for pair in cfg.stereo_pairs:
            m, n_new = stereo_spawn(m, jnp.asarray(0), self.rig.kind,
                                    cfg.n_cams, self.rig, pair,
                                    lap1=_lap(cfg, pair[0]),
                                    lap2=_lap(cfg, pair[1]))
            total += int(n_new)
        if total < 50:
            self.map = ms.allocate(cfg.max_kf, CF, cfg.max_mp)
            return False
        self.map = ms.update_mp_geometry(m, None)
        self.last_kf_slot = 0
        self.last_kf_time = time
        self.first_kf_time = time
        self.n_kf = 1
        self.ref_kf_inliers = total
        self.kf_pre = [None]
        self._imu_kf = []
        self.state = self.OK
        return True

    def _insert_keyframe(self, bank, time, feat_mp, n_in):
        cfg = self.cfg
        slot = self.n_kf
        z3 = jnp.zeros(3)
        self.map = ms.insert_keyframe(
            self.map, slot, self.R, self.t, self.v, self.bias[:3],
            self.bias[3:], time, bank["xy"], bank["desc"], bank["level"],
            bank["sigma2"], bank["cam"], bank["valid"], feat_mp)
        # depth-prior points first: measured metric depth needs no
        # parallax (reference: Frame.cc:1916-1922)
        if cfg.use_depth:
            self.map, _ = depth_mod.spawn_from_depth_multi(
                self.map, jnp.asarray(slot), self.rig.kind, cfg.n_cams,
                self.rig, self._depth_cur,
                pin_params=cfg.depth_pin or None,
                cap_new=cfg.depth_cap, max_spawn_depth=cfg.depth_max)
        # intra-rig stereo points (metric) ...
        for pair in cfg.stereo_pairs:
            self.map, _ = stereo_spawn(
                self.map, jnp.asarray(slot), self.rig.kind, cfg.n_cams,
                self.rig, pair, cap_new=cfg.new_mp_cap,
                lap1=_lap(cfg, pair[0]), lap2=_lap(cfg, pair[1]))
        # ... plus temporal points per camera band against recent KFs
        # (reference: CreateNewMapPoints, src/LocalMapping.cc:395)
        refs = jnp.asarray([slot - 1 - j for j in range(cfg.temporal_refs)],
                           dtype=jnp.int32)
        self.map, _ = temporal_spawn_multi(
            self.map, jnp.asarray(slot), refs, self.rig.kind, cfg.n_cams,
            self.rig, cfg.new_mp_cap, n_refs=cfg.temporal_refs)
        self.map = bind_landmarks_multi(
            self.map, jnp.asarray(slot), self.rig.kind, cfg.n_cams,
            self.rig, float(cfg.img_w), float(cfg.img_h))
        self.map = mono.fuse_new_landmarks(self.map, jnp.asarray(slot),
                                           cap=cfg.new_mp_cap)
        self.map = mono.cull_landmarks(self.map, jnp.asarray(slot))
        self.map = ms.update_mp_geometry(self.map, None)

        # preintegration for this KF interval
        if cfg.use_imu and self._imu_kf and self.last_kf_time is not None:
            pre = self._integrate(self._imu_kf, time, self.last_kf_time)
            self.kf_pre.append(pre)
        else:
            self.kf_pre.append(None)
        self._imu_kf = []

        # window BA (visual for now; VI once IMU is initialized)
        if self.imu_initialized:
            self._vi_local_ba(slot)
        else:
            self.map, _ = mono.local_ba_step(
                self.map, jnp.asarray(slot), self.rig.kind, self.rig,
                window=cfg.ba_window)

        # redundant-keyframe culling with preintegration chain merge
        # (reference: KeyFrameCulling + MergePrevious,
        # src/LocalMapping.cc:974, src/ImuTypes.cc:241)
        self.map, culled = mono.cull_keyframes(
            self.map, jnp.asarray(slot), inertial=self.cfg.use_imu,
            imu_ok=bool(self.imu_initialized))
        for ck in [int(x) for x in np.asarray(culled)]:
            if ck >= 0 and ck + 1 < len(self.kf_pre):
                a = self.kf_pre[ck]
                b = self.kf_pre[ck + 1]
                if a is not None and b is not None:
                    self.kf_pre[ck + 1] = pre_mod.compose(a, b)
                elif a is not None:
                    self.kf_pre[ck + 1] = a
                self.kf_pre[ck] = None

        self.last_kf_slot = slot
        self.last_kf_time = time
        self.n_kf += 1
        self.ref_kf_inliers = max(n_in, 1)

        # staged IMU initialization + VIBA refinement schedule
        # (reference: InitializeIMU at LocalMapping.cc:203-265 — initial
        # stage priors 1e2/1e5(stereo)|1e10(mono), VIBA1 at 5 s with
        # 1.0/1e5, VIBA2 at 15 s with 0/0, each followed by FullInertialBA)
        if cfg.use_imu:
            tinit = (time - self.first_kf_time
                     if self.first_kf_time is not None else 0.0)
            if self.viba_stage == 0 and self.n_kf >= cfg.imu_init_kfs:
                pa = 1e5 if cfg.metric_scale else 1e10
                if self._imu_init_stage(1e2, pa, first=True):
                    self.viba_stage = 1
            elif self.viba_stage == 1 and tinit > cfg.viba1_time:
                if self._imu_init_stage(1.0, 1e5, first=False):
                    self.viba_stage = 2
            elif self.viba_stage == 2 and tinit > cfg.viba2_time:
                if self._imu_init_stage(0.0, 0.0, first=False):
                    self.viba_stage = 3

        if self.loop_closer is not None:
            lc_kw = {}
            if self.imu_initialized:
                pre_b, cvalid = self._kf_pre_batch(self.cfg.max_kf)
                ident = pre_mod.init_preintegrated(self.bias)
                chain = jax.tree.map(
                    lambda i, p: jnp.concatenate([i[None], p]),
                    ident, pre_b)
                lc_kw = dict(chain=chain,
                             chain_valid=jnp.concatenate(
                                 [jnp.zeros((1,), bool), cvalid]))
            self.map, closed = self.loop_closer.on_keyframe(
                self.map, slot, **lc_kw)
            # cross-map merge detection (reference: merge path of
            # LoopClosing -> MergeLocal2 for inertial maps)
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
                    # welding BA over the junction
                    if self.imu_initialized:
                        self._vi_local_ba(slot)
                    else:
                        self.map, _ = mono.local_ba_step(
                            self.map, jnp.asarray(slot), self.rig.kind,
                            self.rig, window=cfg.ba_window)
                    self._sync_atlas()

        self.R = self.map.kf_R[slot]
        self.t = self.map.kf_t[slot]
        self.v = self.map.kf_v[slot]

    def _kf_pre_batch(self, K):
        """Stack the temporal preintegration chain [1, K) into one batched
        Preintegrated + validity mask (None entries become the identity
        interval with valid=False)."""
        ident = pre_mod.init_preintegrated(self.bias)
        pres, valid = [], []
        for k in range(1, K):
            p = self.kf_pre[k] if k < len(self.kf_pre) else None
            pres.append(p if p is not None else ident)
            valid.append(p is not None)
        pre_b = jax.tree.map(lambda *xs: jnp.stack(xs), *pres)
        return pre_b, jnp.asarray(valid)

    def _imu_init_stage(self, prior_g, prior_a, first: bool) -> bool:
        """One stage of the staged IMU initialization, delegated to the
        shared device program `imu_init_step` (InertialOptimization ->
        gravity-align -> FullInertialBA; reference:
        LocalMapping::InitializeIMU src/LocalMapping.cc:1255, priors per
        the VIBA schedule at 203-265)."""
        cfg = self.cfg
        if self.n_kf < 3:
            return False
        K = cfg.max_kf
        pre_b, edge_valid = self._kf_pre_batch(K)
        edge_valid = edge_valid & (jnp.arange(1, K) < self.n_kf)
        if int(edge_valid.sum()) < self.n_kf - 2:
            return False
        m2, bias2, ok = imu_init_step(
            self.map, pre_b, edge_valid, self.bias,
            jnp.asarray(bool(first)), jnp.asarray(max(prior_g, 0.0)),
            jnp.asarray(max(prior_a, 0.0)), self.rig.kind,
            cfg.metric_scale, self.rig)
        if not bool(ok):
            return False
        self.map = m2
        self.R = self.map.kf_R[self.last_kf_slot]
        self.t = self.map.kf_t[self.last_kf_slot]
        self.v = self.map.kf_v[self.last_kf_slot]
        self.bias = jnp.concatenate(
            [self.map.kf_bg[self.last_kf_slot],
             self.map.kf_ba[self.last_kf_slot]])
        self.imu_initialized = True
        return True

    def _vi_local_ba(self, newest):
        """VI window BA using the stored preintegration chain.

        The window is PADDED to the constant cfg.ba_window size with
        invalid slots and the whole update runs as ONE jitted program
        (vi_window_ba_step), so every keyframe insert reuses one compiled
        XLA program regardless of how full the window is."""
        cfg = self.cfg
        W = cfg.ba_window
        if newest < 1:
            return
        lo = max(newest - W + 1, 0)
        w_ids = list(range(lo, newest + 1))
        have_pre = all(k < len(self.kf_pre) and self.kf_pre[k] is not None
                       for k in w_ids[1:])
        if not have_pre:
            self.map, _ = mono.local_ba_step(
                self.map, jnp.asarray(newest), self.rig.kind, self.rig,
                window=W)
            return
        n_w = len(w_ids)
        ident = pre_mod.init_preintegrated(self.bias)
        pres = [self.kf_pre[k] for k in w_ids[1:]]
        pres += [ident] * (W - 1 - len(pres))
        edge_ok = [True] * (n_w - 1) + [False] * (W - n_w)
        ids = jnp.asarray(w_ids + [newest] * (W - n_w))
        kf_in = jnp.asarray([True] * n_w + [False] * (W - n_w))
        pre_b = jax.tree.map(lambda *xs: jnp.stack(xs), *pres)
        self.map, self.bias = vi_window_ba_step(
            self.map, ids, kf_in, pre_b, jnp.asarray(edge_ok),
            jnp.asarray(n_w - 1), self.rig.kind, self.rig)
