"""Loop closing: place recognition -> Sim3 verification -> graph correction.

JAX rebuild of the reference's LoopClosing thread (reference:
src/LoopClosing.cc:98 Run; 401 NewDetectCommonRegions; 695
DetectCommonRegionsFromBoW — BoW candidates, Sim3Solver RANSAC, projection
verification; 1108 CorrectLoop — covisibility-propagated Sim3 correction +
essential-graph optimization). The detection math is jitted device kernels;
the accept/reject policy is host Python, synchronous after keyframe
insertion (the reference's thread becomes a pipeline stage).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from functools import partial

from ..frontend import matcher
from ..geometry import cameras, lie
from ..optim import pose_graph
from ..slam_map import keyframe_db as kdb
from ..slam_map import map_state as ms
from ..slam_map import vocabulary as voc


@dataclass
class LoopConfig:
    candidate_source: str = "descriptor"  # "descriptor" | "spatial"
    min_desc_matches: int = 60    # direct-descriptor score floor
    spatial_radius: float = 1.0   # candidate gate (estimate units)
    recent_exclude: int = 8       # skip this many latest keyframes
    covis_exclude: int = 15       # shared-point threshold for exclusion
    min_sim3_inliers: int = 20
    covis_edge_threshold: int = 30
    loop_edge_weight: float = 5.0
    # covisible-group projection verification: the hypothesized Sim3 must
    # re-find this many of the candidate's local landmarks in the current
    # keyframe (reference: nProjMatches gating in
    # DetectCommonRegionsFromBoW, src/LoopClosing.cc:944-994)
    min_group_matches: int = 25
    # temporal consistency: this many CONSECUTIVE keyframes must verify
    # the same candidate before the map is corrected (reference:
    # mnLoopNumCoincidences / DetectCommonRegionsFromLastKF,
    # src/LoopClosing.cc:440-520, 1019)
    temporal_consistency: int = 2
    # train a session vocabulary + switch retrieval to the word-sparse
    # KFDB inverted scores once the map has this many keyframes; dense
    # descriptor scoring stays the small-map fast path (it is O(K^2 F^2),
    # capped by construction to maps below this size)
    vocab_train_kf: int = 40
    vocab_train_samples: int = 20000
    # k=10, L=4 -> 10,000 words (reference ORBvoc is k=10 L=6; DBoW2
    # TemplatedVocabulary.h) — the word-sparse database stores top-W
    # (word, weight) pairs per keyframe, so memory is independent of
    # vocabulary size (src/KeyFrameDatabase.cc:581 inverted file)
    vocab_levels: int = 4
    bow_top_w: int = 512
    # run whole-map GBA after a verified loop correction (reference:
    # CorrectLoop spawns RunGlobalBundleAdjustment, src/LoopClosing.cc:
    # 1372; FullInertialBA for inertial maps, 2366-2368)
    run_gba: bool = True
    # gravity-direction gate for inertial maps ("BAD LOOP" branch,
    # reference: src/LoopClosing.cc:307-335 gates |phi_xy| < 0.008 and
    # |phi_z| < 0.349; tilt_max defaults wider because this estimator's
    # measured tilt drift on long streams is 0.02-0.06 rad)
    tilt_max: float = 0.08
    yaw_max: float = 0.349


class MatchedPairs(NamedTuple):
    p_a: jnp.ndarray        # [F,3] landmark in body frame of KF a
    p_b: jnp.ndarray        # [F,3] ... of KF b
    uv_a: jnp.ndarray       # [F,2] observed keypoint in KF a
    uv_b: jnp.ndarray       # [F,2]
    sigma2_a: jnp.ndarray   # [F]
    sigma2_b: jnp.ndarray   # [F]
    cam_a: jnp.ndarray      # [F] camera band of the observation
    cam_b: jnp.ndarray      # [F]
    valid: jnp.ndarray      # [F] bool


def _pairs_from_tables(kfa, kfb, slot_a, slot_b):
    """kfa/kfb: per-map (R, t, xy, desc, sigma2, cam, feat_valid, obs,
    mp_pos, mp_valid) tuples. Shared by same-map and cross-map variants."""
    (Ra, ta, xya, desca, s2a, cama, fva, obsa, posa, mpva) = kfa
    (Rb, tb, xyb, descb, s2b, camb, fvb, obsb, posb, mpvb) = kfb
    F = xya.shape[1]
    has_a = (obsa[slot_a] >= 0) & fva[slot_a]
    has_b = (obsb[slot_b] >= 0) & fvb[slot_b]
    idx, hd = matcher.match_nn(desca[slot_a], has_a,
                               descb[slot_b], has_b,
                               max_dist=64, ratio=0.9,
                               mutual=True)
    idx = matcher.dedup_targets(idx, hd, F)
    okm = idx >= 0
    safe = jnp.where(okm, idx, 0)
    mp_a = jnp.where(okm, obsa[slot_a], 0)
    mp_b = jnp.where(okm, obsb[slot_b][safe], 0)
    valid = okm & mpva[mp_a] & mpvb[mp_b]
    p_a = jnp.einsum("ji,fj->fi", Ra[slot_a], posa[mp_a] - ta[slot_a])
    p_b = jnp.einsum("ji,fj->fi", Rb[slot_b], posb[mp_b] - tb[slot_b])
    return MatchedPairs(
        p_a=p_a, p_b=p_b,
        uv_a=xya[slot_a], uv_b=xyb[slot_b][safe],
        sigma2_a=s2a[slot_a], sigma2_b=s2b[slot_b][safe],
        cam_a=cama[slot_a], cam_b=camb[slot_b][safe],
        valid=valid)


def _tables(m: ms.MapState):
    return (m.kf_R, m.kf_t, m.kf_xy, m.kf_desc, m.kf_sigma2, m.kf_cam,
            m.kf_feat_valid, m.kf_obs, m.mp_pos, m.mp_valid)


def pairs_by_projection(m: ms.MapState, slot, cand, rig_kind: int,
                        n_cams: int, rig, img_w: float, img_h: float,
                        radius: float = 40.0):
    """Projection-GUIDED Sim3 pairs: project the candidate keyframe's
    bound landmarks into the current keyframe's cameras from the CURRENT
    (drifted) poses and match descriptors within `radius` px.

    Pure descriptor NN across two full keyframes (`_pairs_from_tables`)
    degrades under perceptual aliasing — most of its matches connect
    unrelated structure, starving the Sim3 RANSAC of inliers (measured:
    <=10 true pairs of ~60 on the flagship bench). The reference never
    relies on raw NN alone either: loop hypotheses are refined by
    SearchByProjection around the predicted geometry
    (src/LoopClosing.cc:888, src/ORBmatcher.cc:99-331). At loop time the
    relative drift is small compared to a 40 px gate, so projecting
    through the current poses recovers dense TRUE pairs; the RANSAC
    still validates geometry independently. Combine with NN pairs (which
    need no pose prior) for the large-drift fallback.

    Returns MatchedPairs padded to [C*F] (keyed by current-KF feature).
    """
    from . import tracking as mono

    CF = m.kf_obs.shape[1]
    F = CF // n_cams
    M = m.mp_pos.shape[0]
    # candidate's bound-landmark set
    obs_c = m.kf_obs[cand]
    has_c = (obs_c >= 0) & m.kf_feat_valid[cand]
    sel_b = jnp.zeros((M,), bool).at[
        jnp.where(has_c, obs_c, 0)].max(has_c) & m.mp_valid

    idx_all, dist_all = [], []
    for c in range(n_cams):
        uv_proj, lvl, vis_c, _ = mono.project_landmarks(
            m, m.kf_R[slot], m.kf_t[slot], rig_kind, rig.params[c],
            rig.R_cb[c], rig.t_cb[c], img_w, img_h)
        sl = slice(c * F, (c + 1) * F)
        feat_ok = (m.kf_feat_valid[slot][sl]
                   & (m.kf_obs[slot][sl] >= 0))
        idx_c, dist_c = matcher.match_projection(
            uv_proj, lvl, radius, m.mp_desc, vis_c & sel_b,
            m.kf_xy[slot][sl], m.kf_level[slot][sl],
            m.kf_desc[slot][sl], feat_ok,
            max_dist=matcher.TH_LOW, ratio=0.9)
        idx_c = matcher.dedup_targets(idx_c, dist_c, F)
        idx_all.append(jnp.where(idx_c >= 0, idx_c + c * F, -1))
        dist_all.append(dist_c)

    idx_sc = jnp.stack(idx_all, axis=1)          # [M, C]
    dist_sc = jnp.stack(dist_all, axis=1)
    best_c = jnp.argmin(jnp.where(idx_sc >= 0, dist_sc, 1 << 20),
                        axis=1)
    feat = jnp.take_along_axis(idx_sc, best_c[:, None], axis=1)[:, 0]
    matched = feat >= 0                          # [M] landmark -> feat

    # scatter to per-feature rows: feature f pairs with landmark b
    lm_of_feat = jnp.full((CF,), -1, jnp.int32).at[
        jnp.where(matched, feat, CF - 1)].max(
        jnp.where(matched, jnp.arange(M, dtype=jnp.int32), -1))
    okf = lm_of_feat >= 0
    mp_b = jnp.where(okf, lm_of_feat, 0)
    mp_a = jnp.where(okf, m.kf_obs[slot], 0)
    valid = (okf & (m.kf_obs[slot] >= 0) & m.mp_valid[mp_a]
             & m.mp_valid[mp_b])
    p_a = jnp.einsum("ji,fj->fi", m.kf_R[slot],
                     m.mp_pos[mp_a] - m.kf_t[slot])
    p_b = jnp.einsum("ji,fj->fi", m.kf_R[cand],
                     m.mp_pos[mp_b] - m.kf_t[cand])
    # image observation of the landmark in the CANDIDATE keyframe: the
    # feature of cand bound to mp_b (scatter cand's bound features by
    # landmark id)
    feat_of_lm = jnp.full((M,), -1, jnp.int32).at[
        jnp.where(has_c, obs_c, 0)].max(
        jnp.where(has_c, jnp.arange(CF, dtype=jnp.int32), -1))
    fb = feat_of_lm[mp_b]
    valid = valid & (fb >= 0)
    fb = jnp.where(fb >= 0, fb, 0)
    return MatchedPairs(
        p_a=p_a, p_b=p_b,
        uv_a=m.kf_xy[slot], uv_b=m.kf_xy[cand][fb],
        sigma2_a=m.kf_sigma2[slot], sigma2_b=m.kf_sigma2[cand][fb],
        cam_a=m.kf_cam[slot], cam_b=m.kf_cam[cand][fb],
        valid=valid)


@jax.jit
def _matched_pairs_body(m: ms.MapState, slot_a, slot_b) -> MatchedPairs:
    """Match features of two keyframes of ONE map; landmark positions in
    each keyframe's BODY frame plus the image observations.

    (reference: loop detection matches via SearchByBoW then feeds matched
    MapPoint pairs to Sim3Solver, LoopClosing.cc:781-832)
    """
    return _pairs_from_tables(_tables(m), _tables(m), slot_a, slot_b)


@jax.jit
def _matched_pairs_cross(m_a: ms.MapState, slot_a,
                         m_b: ms.MapState, slot_b) -> MatchedPairs:
    """Cross-map variant: KF a lives in map m_a, KF b in map m_b
    (merge detection, reference: LoopClosing.cc merge candidates in
    another Atlas map, 176-204)."""
    return _pairs_from_tables(_tables(m_a), _tables(m_b), slot_a, slot_b)


@jax.jit
def cross_place_scores(desc_q, valid_q, m_b: ms.MapState):
    """Place-recognition scores of a query descriptor bank against every
    keyframe of ANOTHER map (merge candidate retrieval). Returns [K]."""
    K, F = m_b.kf_obs.shape
    dist = matcher.hamming_matrix(
        desc_q, m_b.kf_desc.reshape(K * F, 256)).reshape(-1, K, F)
    t_valid = m_b.kf_feat_valid & m_b.kf_valid[:, None]
    dist = jnp.where(t_valid[None] & valid_q[:, None, None],
                     dist, 1 << 20)
    best = jnp.min(dist, axis=2)
    return jnp.sum((best < matcher.TH_LOW).astype(jnp.int32), axis=0)


@partial(jax.jit, static_argnames=("rig_kind", "n_cams"))
def group_projection_score(m: ms.MapState, slot, cand, cov_row,
                           s, R, t, rig_kind: int, n_cams: int, rig,
                           img_w: float, img_h: float,
                           radius: float = 8.0,
                           cov_threshold: int = 15):
    """Count matches when projecting the candidate's covisible-group
    landmarks into the current keyframe through the hypothesized Sim3.

    (reference: the projection-verification step of
    DetectCommonRegionsFromBoW — project the MapPoints of the candidate's
    covisible window into the current KF and require nProjMatches,
    src/LoopClosing.cc:944-994.)

    s, R, t: body(slot) -> body(cand) Sim3 (p_cand = s R p_slot + t).
    Returns n_matches (int32).
    """
    K, CF = m.kf_obs.shape
    F = CF // n_cams
    M = m.mp_pos.shape[0]
    # the loop-local landmark set: seen by cand or its strong covisibles
    group_kf = ((cov_row >= cov_threshold).at[cand].set(True)
                & m.kf_valid)
    sel = group_kf[:, None] & (m.kf_obs >= 0)
    group = (jnp.zeros((M,), bool)
             .at[jnp.where(sel, m.kf_obs, 0)].max(sel)) & m.mp_valid

    # landmarks -> candidate body frame -> hypothesized slot body frame
    p_bc = jnp.einsum("ji,mj->mi", m.kf_R[cand], m.mp_pos - m.kf_t[cand])
    p_bs = jnp.einsum("ji,mj->mi", R, p_bc - t) / s

    n = jnp.zeros((), jnp.int32)
    for c in range(n_cams):
        p_c = jnp.einsum("ij,mj->mi", rig.R_cb[c], p_bs) + rig.t_cb[c]
        uv = cameras.project(rig_kind, rig.params[c], p_c)
        vis = (group & (p_c[:, 2] > 0.1)
               & (uv[:, 0] >= 0) & (uv[:, 0] < img_w)
               & (uv[:, 1] >= 0) & (uv[:, 1] < img_h))
        sl = slice(c * F, (c + 1) * F)
        lvl = ms.predict_scale_level(
            jnp.linalg.norm(p_c, axis=-1), m.mp_dmax)
        idx, _ = matcher.match_projection(
            uv, lvl, radius, m.mp_desc, vis,
            m.kf_xy[slot][sl], m.kf_level[slot][sl],
            m.kf_desc[slot][sl], m.kf_feat_valid[slot][sl],
            max_dist=matcher.TH_LOW)
        n = n + jnp.sum((idx >= 0).astype(jnp.int32))
    return n


def group_projection_score_cross(m_cur: ms.MapState, slot,
                                 m_cand: ms.MapState, cand, cov_row,
                                 s, R, t, rig_kind: int, n_cams: int,
                                 rig, img_w: float, img_h: float,
                                 radius: float = 8.0,
                                 cov_threshold: int = 15):
    """Cross-MAP form of `group_projection_score`: the candidate keyframe
    and its covisible-group landmarks live in `m_cand` (another Atlas
    map); the current keyframe's features live in `m_cur`. Used by merge
    detection (reference: the same nProjMatches verification run on
    merge candidates from other maps, src/LoopClosing.cc:695-994).

    s, R, t: body(slot in m_cur) -> body(cand in m_cand) Sim3.
    """
    K2, CF = m_cand.kf_obs.shape
    F = CF // n_cams
    M2 = m_cand.mp_pos.shape[0]
    group_kf = ((cov_row >= cov_threshold).at[cand].set(True)
                & m_cand.kf_valid)
    sel = group_kf[:, None] & (m_cand.kf_obs >= 0)
    group = (jnp.zeros((M2,), bool)
             .at[jnp.where(sel, m_cand.kf_obs, 0)].max(sel)) \
        & m_cand.mp_valid

    p_bc = jnp.einsum("ji,mj->mi", m_cand.kf_R[cand],
                      m_cand.mp_pos - m_cand.kf_t[cand])
    p_bs = jnp.einsum("ji,mj->mi", R, p_bc - t) / s

    n = jnp.zeros((), jnp.int32)
    for c in range(n_cams):
        p_c = jnp.einsum("ij,mj->mi", rig.R_cb[c], p_bs) + rig.t_cb[c]
        uv = cameras.project(rig_kind, rig.params[c], p_c)
        vis = (group & (p_c[:, 2] > 0.1)
               & (uv[:, 0] >= 0) & (uv[:, 0] < img_w)
               & (uv[:, 1] >= 0) & (uv[:, 1] < img_h))
        sl = slice(c * F, (c + 1) * F)
        lvl = ms.predict_scale_level(
            jnp.linalg.norm(p_c, axis=-1), m_cand.mp_dmax)
        idx, _ = matcher.match_projection(
            uv, lvl, radius, m_cand.mp_desc, vis,
            m_cur.kf_xy[slot][sl], m_cur.kf_level[slot][sl],
            m_cur.kf_desc[slot][sl], m_cur.kf_feat_valid[slot][sl],
            max_dist=matcher.TH_LOW)
        n = n + jnp.sum((idx >= 0).astype(jnp.int32))
    return n


@jax.jit
def _correct_map(m: ms.MapState, s_new, R_new, t_new):
    """Apply optimized world->keyframe Sim3s back to the map.

    Keyframe poses absorb the scale; each landmark is corrected through its
    reference keyframe's old->new Sim3 (reference: CorrectLoop's
    CorrectedSim3 propagation + RunGlobalBundleAdjustment's spanning-tree
    point correction, LoopClosing.cc:2410-2470).
    """
    # old world->kf Sim3 per keyframe
    R_old_cw = jnp.swapaxes(m.kf_R, -1, -2)
    t_old_cw = -jnp.einsum("kij,kj->ki", R_old_cw, m.kf_t)
    s_old = jnp.ones(m.kf_R.shape[0], m.kf_t.dtype)

    # new keyframe poses: world-from-kf of (s, R, t): x_kf = s R x_w + t
    R_wk = jnp.swapaxes(R_new, -1, -2)
    t_wk = -jnp.einsum("kij,kj->ki", R_wk, t_new) / s_new[:, None]

    # landmark correction via reference KF r: p' = S_new_r^{-1}(S_old_r(p))
    r_kf = jnp.clip(m.mp_first_kf, 0, m.kf_R.shape[0] - 1)
    p_kf = (jnp.einsum("mij,mj->mi", R_old_cw[r_kf],
                       m.mp_pos - m.kf_t[r_kf]))
    si, Ri, ti = lie.sim3_inverse(s_new[r_kf], R_new[r_kf], t_new[r_kf])
    p_new = lie.sim3_apply(si, Ri, ti, p_kf)
    return m._replace(
        kf_R=lie.normalize_rotation(R_wk),
        kf_t=t_wk,
        mp_pos=jnp.where(m.mp_valid[:, None], p_new, m.mp_pos))


class LoopCloser:
    def __init__(self, vocab: voc.Vocabulary | None, max_kf: int,
                 cfg: LoopConfig = LoopConfig(), seed: int = 100,
                 rig=None, inertial: bool = False,
                 img_w: float = 640.0, img_h: float = 480.0):
        self.vocab = vocab            # optional BoW path
        self.cfg = cfg
        self.max_kf = max_kf
        self.db = (kdb.allocate_sparse(max_kf, cfg.bow_top_w)
                   if vocab is not None else None)
        self.key = jax.random.PRNGKey(seed)
        self.n_loops = 0
        self.n_merges = 0
        # rig enables reprojection verification (OptimizeSim3 analog);
        # inertial switches correction to the 4DoF essential graph and
        # locks scale (reference: bFixScale, LoopClosing.cc:1329)
        self.rig = rig
        self.inertial = inertial
        self.img_w = float(img_w)
        self.img_h = float(img_h)
        # temporal-consistency hypothesis: {cand, slot, s, R, t, count}
        # (reference: mnLoopNumCoincidences + the Scw carried between
        # keyframes, src/LoopClosing.cc:440-520)
        self.pending: dict | None = None

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _verify_sim3(self, pairs: MatchedPairs, res):
        """Projection verification + refinement of a RANSAC Sim3
        (reference: SearchByProjection + OptimizeSim3 + 'verify vs
        covisibles' acceptance, LoopClosing.cc:888-994). Returns the
        refined Sim3Result-compatible tuple (s, R, t, n_inliers) or None
        when the rig is unknown (RANSAC inliers stand alone)."""
        if self.rig is None:
            return None
        from ..optim import sim3_refine
        rig = self.rig
        cam_a = jnp.clip(pairs.cam_a, 0, rig.params.shape[0] - 1)
        cam_b = jnp.clip(pairs.cam_b, 0, rig.params.shape[0] - 1)
        out = sim3_refine.refine_sim3(
            res.s, res.R, res.t, pairs.p_a, pairs.p_b,
            pairs.uv_a, pairs.uv_b, pairs.sigma2_a, pairs.sigma2_b,
            pairs.valid & res.inlier, rig.kind,
            rig.params[cam_a], rig.params[cam_b],
            rig.R_cb[cam_a], rig.t_cb[cam_a],
            rig.R_cb[cam_b], rig.t_cb[cam_b],
            fix_scale=self.inertial)
        return out

    # -- retrieval ---------------------------------------------------------
    def _maybe_train_vocab(self, m: ms.MapState):
        """Train a session vocabulary from the map's own descriptors and
        backfill the keyframe database once the map outgrows dense scoring
        (reference analog: the pre-trained ORBvoc + KeyFrameDatabase,
        src/KeyFrameDatabase.cc:581; here the vocabulary is learned from
        the session because descriptors are self-consistent in-framework).
        """
        cfg = self.cfg
        if self.vocab is not None or int(m.n_kf) < cfg.vocab_train_kf:
            return
        kf_valid = np.asarray(m.kf_valid)
        desc = np.asarray(m.kf_desc[kf_valid])
        fv = np.asarray(m.kf_feat_valid[kf_valid])
        flat = desc.reshape(-1, 256)[fv.reshape(-1)]
        if len(flat) < 1000:
            return
        rng = np.random.default_rng(0)
        take = min(cfg.vocab_train_samples, len(flat))
        flat = flat[rng.permutation(len(flat))[:take]]
        self.vocab = voc.train(flat, k=10, levels=cfg.vocab_levels)
        # backfill the word-sparse database for every existing keyframe
        words, wts = jax.vmap(
            voc.transform_sparse, in_axes=(None, 0, 0, None))(
            self.vocab, m.kf_desc, m.kf_feat_valid, cfg.bow_top_w)
        self.db = kdb.SparseKeyframeDB(
            word=jnp.where(m.kf_valid[:, None], words, 0),
            wt=jnp.where(m.kf_valid[:, None], wts, 0.0),
            valid=m.kf_valid)

    def _candidates(self, m: ms.MapState, slot: int, cov):
        """Top loop candidates: KFDB inverted scores when the session
        vocabulary exists, dense matmul descriptor scoring otherwise."""
        from . import tracking as trk

        cfg = self.cfg
        recent = (jnp.arange(m.kf_valid.shape[0])
                  > slot - cfg.recent_exclude)
        exclude = (cov[slot] >= cfg.covis_exclude) | recent | ~m.kf_valid

        if cfg.candidate_source == "spatial":
            d = jnp.linalg.norm(m.kf_t - m.kf_t[slot], axis=-1)
            scores = jnp.where(exclude | (d > cfg.spatial_radius),
                               -jnp.inf, -d)
            top = jax.lax.top_k(scores, 3)[1]
            ok = jnp.isfinite(scores[top])
        elif self.vocab is not None:
            q_word, q_wt = voc.transform_sparse(
                self.vocab, m.kf_desc[slot], m.kf_feat_valid[slot],
                cfg.bow_top_w)
            self.db = kdb.add_sparse(self.db, slot, q_word, q_wt)
            nw = self.vocab.n_words
            min_score = kdb.min_covisible_score_sparse(
                self.db, q_word, q_wt, cov[slot], nw,
                cov_threshold=cfg.covis_exclude)
            _, top, ok = kdb.query_sparse(self.db, q_word, q_wt,
                                          exclude, min_score, nw)
        else:
            scores = trk.descriptor_place_scores(m, jnp.asarray(slot))
            scores = jnp.where(exclude, -1, scores)
            top = jax.lax.top_k(scores, 3)[1]
            ok = scores[top] >= cfg.min_desc_matches
        return [int(c) for c, o in zip(np.asarray(top), np.asarray(ok))
                if o]

    def _group_score(self, m, slot, cand, cov, s, R, t) -> int:
        if self.rig is None:
            return 1 << 20   # no rig: the gate degrades to a no-op
        n_cams = int(self.rig.params.shape[0])
        return int(group_projection_score(
            m, jnp.asarray(slot), jnp.asarray(cand), cov[cand],
            s, R, t, self.rig.kind, n_cams, self.rig,
            self.img_w, self.img_h))

    def _solve_pair(self, m, slot: int, cand: int):
        """Matched pairs -> RANSAC Sim3 -> projection refinement.
        Returns the refined result or None."""
        from ..solvers import sim3 as sim3_mod

        cfg = self.cfg
        pairs = _matched_pairs_body(
            m, jnp.asarray(slot), jnp.asarray(cand))
        if int(pairs.valid.sum()) < cfg.min_sim3_inliers:
            return None
        if self.rig is not None:
            # reprojection-gated (Sim3Solver::CheckInliers semantics)
            res = sim3_mod.ransac_sim3_reproj(
                self._next_key(), pairs, self.rig.kind, self.rig,
                fix_scale=self.inertial,
                min_inliers=cfg.min_sim3_inliers)
        else:
            res = sim3_mod.ransac_sim3(
                self._next_key(), pairs.p_a, pairs.p_b, pairs.valid,
                fix_scale=self.inertial,
                min_inliers=cfg.min_sim3_inliers)
        if not bool(res.success):
            return None
        ref = self._verify_sim3(pairs, res)
        if ref is not None:
            if int(ref.n_inliers) < cfg.min_sim3_inliers:
                return None
            res = res._replace(s=ref.s, R=ref.R, t=ref.t,
                               inlier=ref.inlier,
                               n_inliers=ref.n_inliers)
        if self.inertial:
            # gravity-direction gate ("BAD LOOP" branch, reference:
            # src/LoopClosing.cc:307-335): reject hypotheses whose world
            # correction tilts roll/pitch or implies an extreme yaw jump
            from ..geometry import lie as lie_mod
            R_corr = (m.kf_R[cand] @ res.R) @ m.kf_R[slot].T
            phi = np.abs(np.asarray(lie_mod.so3_log(R_corr)))
            if not (phi[0] < cfg.tilt_max and phi[1] < cfg.tilt_max
                    and phi[2] < cfg.yaw_max):
                return None
        return res

    def on_keyframe(self, m: ms.MapState, slot: int, chain=None,
                    chain_valid=None):
        """Detect, temporally confirm, and (if verified) correct a loop.
        Returns (m, closed).

        Acceptance chain (reference: src/LoopClosing.cc:401-1019):
        1. retrieval (KFDB once the session vocabulary is trained, dense
           matmul scoring for small maps);
        2. Sim3 RANSAC on matched landmark pairs + projection refinement;
        3. covisible-group projection verification: the Sim3 must re-find
           the candidate's local landmarks in the current keyframe;
        4. temporal consistency: `temporal_consistency` CONSECUTIVE
           keyframes must re-verify the same hypothesis before
           `_correct_map` runs (a wrong correction is unrecoverable).

        After a correction, cfg.run_gba closes the accuracy loop with a
        whole-map GBA (FullInertialBA when `chain`/`chain_valid` — the
        per-KF preintegration chain, intervals (k-1 -> k) — is given).
        """
        cfg = self.cfg
        self._maybe_train_vocab(m)
        self._chain = (chain, chain_valid)
        cov = ms.covisibility_matrix(m)

        # -- step 4 first: re-verify a pending hypothesis from this KF --
        if self.pending is not None:
            p = self.pending
            if slot <= p["slot"]:
                self.pending = None
            else:
                # compose: S'(new->cand) = S(old->cand) o T(old<-new)
                R_o, t_o = m.kf_R[p["slot"]], m.kf_t[p["slot"]]
                R_n, t_n = m.kf_R[slot], m.kf_t[slot]
                R2 = p["R"] @ R_o.T @ R_n
                t2 = p["s"] * (p["R"] @ (R_o.T @ (t_n - t_o))) + p["t"]
                score = self._group_score(m, slot, p["cand"], cov,
                                          p["s"], R2, t2)
                if score >= cfg.min_group_matches:
                    p.update(slot=slot, R=R2, t=t2,
                             count=p["count"] + 1)
                    if p["count"] >= cfg.temporal_consistency:
                        res = self._solve_pair(m, slot, p["cand"])
                        self.pending = None
                        if res is not None:
                            m = self._correct(m, slot, p["cand"], res,
                                              cov)
                            self.n_loops += 1
                            return m, True
                    else:
                        return m, False
                else:
                    self.pending = None

        # -- steps 1-3: fresh detection ---------------------------------
        for cand in self._candidates(m, slot, cov):
            res = self._solve_pair(m, slot, cand)
            if res is None:
                continue
            score = self._group_score(m, slot, cand, cov,
                                      res.s, res.R, res.t)
            if score < cfg.min_group_matches:
                continue
            if cfg.temporal_consistency <= 1:
                m = self._correct(m, slot, cand, res, cov)
                self.n_loops += 1
                return m, True
            self.pending = dict(cand=cand, slot=slot, s=res.s,
                                R=res.R, t=res.t, count=1)
            return m, False
        return m, False

    def _correct(self, m: ms.MapState, slot: int, cand: int, res, cov):
        """Essential-graph correction with the verified loop constraint."""
        cfg = self.cfg
        K = m.kf_R.shape[0]
        n_kf = int(m.n_kf)

        # nodes: current poses as world->kf Sim3 (scale 1)
        R_cw = jnp.swapaxes(m.kf_R, -1, -2)
        t_cw = -jnp.einsum("kij,kj->ki", R_cw, m.kf_t)
        s0 = jnp.ones((K,))

        edges = pose_graph.sequential_edges(s0, R_cw, t_cw,
                                            jnp.asarray(n_kf), K)
        # covisibility edges (reference: essential graph includes high-
        # covisibility edges, Optimizer.cc OptimizeEssentialGraph)
        cov_np = np.asarray(cov)
        ii, jj = np.nonzero(np.triu(cov_np, 2)
                            >= cfg.covis_edge_threshold)
        keep = (ii < n_kf) & (jj < n_kf)
        ii, jj = ii[keep], jj[keep]
        # cap the edge set at the HIGHEST-covisibility 128 (the essential
        # graph keeps all high-covisibility edges; when capacity forces a
        # cap, weight order preserves its semantics —
        # reference: src/Optimizer.cc:1826 OptimizeEssentialGraph)
        if len(ii) > 128:
            order = np.argsort(-cov_np[ii, jj], kind="stable")[:128]
            dropped = len(ii) - 128
            ii, jj = ii[order], jj[order]
            print(f"[loop_closing] covisibility edge cap: kept top 128 "
                  f"of {len(order) + dropped} by weight "
                  f"({dropped} dropped)")
        if len(ii) > 0:
            i_j = jnp.asarray(ii, jnp.int32)
            j_j = jnp.asarray(jj, jnp.int32)
            si_, Ri_, ti_ = lie.sim3_inverse(s0[i_j], R_cw[i_j],
                                             t_cw[i_j])
            se, Re, te = lie.sim3_compose(s0[j_j], R_cw[j_j], t_cw[j_j],
                                          si_, Ri_, ti_)
            cov_edges = pose_graph.PoseGraphEdges(
                i=i_j, j=j_j, s=se, R=Re, t=te,
                weight=jnp.ones((len(ii),)),
                valid=jnp.ones((len(ii),), bool))
            edges = jax.tree.map(lambda a, b: jnp.concatenate([a, b]),
                                 edges, cov_edges)

        # loop edge: measured S_{slot<-cand} from the Sim3 solver result.
        # res maps body(slot) -> body(cand): p_cand = s R p_slot + t.
        # In world->kf terms: S_slot' = S_res^{-1} ... edge measures
        # S_ji with i=cand, j=slot: S_slot * S_cand^{-1} = S_res^{-1}
        si_r, Ri_r, ti_r = lie.sim3_inverse(res.s, res.R, res.t)
        loop_edge = pose_graph.PoseGraphEdges(
            i=jnp.asarray([cand], jnp.int32),
            j=jnp.asarray([slot], jnp.int32),
            s=si_r[None], R=Ri_r[None], t=ti_r[None],
            weight=jnp.asarray([cfg.loop_edge_weight]),
            valid=jnp.asarray([True]))
        edges = jax.tree.map(lambda a, b: jnp.concatenate([a, b]),
                             edges, loop_edge)
        # persistent edges from earlier loops/merges, re-measured from the
        # current poses (reference: mspLoopEdges consumed by every
        # OptimizeEssentialGraph solve, src/Optimizer.cc:1826)
        lv = (m.loop_valid & (m.loop_i >= 0) & (m.loop_j >= 0)
              & m.kf_valid[jnp.clip(m.loop_i, 0, K - 1)]
              & m.kf_valid[jnp.clip(m.loop_j, 0, K - 1)])
        if bool(jnp.any(lv)):
            li = jnp.clip(m.loop_i, 0, K - 1)
            lj = jnp.clip(m.loop_j, 0, K - 1)
            sli, Rli, tli = lie.sim3_inverse(s0[li], R_cw[li], t_cw[li])
            sle, Rle, tle = lie.sim3_compose(
                s0[lj], R_cw[lj], t_cw[lj], sli, Rli, tli)
            stored_e = pose_graph.PoseGraphEdges(
                i=li, j=lj, s=sle, R=Rle, t=tle,
                weight=jnp.full(li.shape, cfg.loop_edge_weight),
                valid=lv)
            edges = jax.tree.map(lambda a, b: jnp.concatenate([a, b]),
                                 edges, stored_e)
        m = ms.add_loop_edge(m, cand, slot)

        fixed = jnp.zeros((K,), bool).at[cand].set(True)
        node_valid = m.kf_valid
        if self.inertial:
            # inertial maps: gravity direction is observable — correct
            # yaw + translation only (reference: OptimizeEssentialGraph4DoF
            # dispatch for IMU maps, src/LoopClosing.cc:1329)
            edges3 = pose_graph.PoseGraphEdgesSE3(
                i=edges.i, j=edges.j, R=edges.R, t=edges.t,
                weight=edges.weight, valid=edges.valid)
            R_o, t_o, chi = pose_graph.optimize_pose_graph_4dof(
                R_cw, t_cw, edges3, fixed, node_valid)
            s_o = jnp.ones((K,))
        else:
            s_o, R_o, t_o, chi = pose_graph.optimize_pose_graph(
                s0, R_cw, t_cw, edges, fixed, node_valid)
        m = _correct_map(m, s_o, R_o, t_o)
        return self._post_loop_gba(m)

    def _post_loop_gba(self, m: ms.MapState):
        """Whole-map GBA after loop correction — the reference's
        RunGlobalBundleAdjustment semantics (src/LoopClosing.cc:1372,
        2351-2470; FullInertialBA for inertial maps, 2366-2368). The
        spanning-tree propagation step of the reference is unnecessary
        here: the solve covers EVERY keyframe/landmark in the slabs in one
        program, so there are no not-yet-corrected children to propagate
        to."""
        if not self.cfg.run_gba or self.rig is None:
            return m
        from . import tracking as trk

        chain, chain_valid = getattr(self, "_chain", (None, None))
        if chain is not None and chain_valid is not None:
            pre_b = jax.tree.map(lambda x: x[1:], chain)
            m, chi = trk.global_inertial_ba_step(
                m, pre_b, chain_valid[1:], self.rig.kind, self.rig)
        else:
            m, chi = trk.global_ba_step(m, self.rig.kind, self.rig)
        return m

    # -- Atlas merge detection (reference: LoopClosing merge path,
    # src/LoopClosing.cc:176-204 scale sanity + MergeLocal/MergeLocal2) --
    def detect_merge(self, atlas, slot: int):
        """Try to weld the CURRENT atlas map into an older map via a
        verified cross-map Sim3.

        On success the merged map replaces the older map, the current map
        is dropped from the atlas, and (map_index, kf_offset, mp_offset)
        is returned so the caller can remap its bookkeeping (the reference
        migrates pointers in MergeLocal; slabs shift indices instead).
        Returns None when no merge happened.
        """
        from ..slam_map import atlas as atlas_mod
        from ..solvers import sim3 as sim3_mod

        cfg = self.cfg
        cur_id = atlas.current
        m_cur = atlas.maps[cur_id]
        q_desc = m_cur.kf_desc[slot]
        q_valid = m_cur.kf_feat_valid[slot]
        for other_id in range(len(atlas.maps)):
            if other_id == cur_id:
                continue
            m_old = atlas.maps[other_id]
            if int(m_old.n_kf) < 2:
                continue
            scores = cross_place_scores(q_desc, q_valid, m_old)
            top = jax.lax.top_k(scores, 2)[1]
            ok = scores[top] >= cfg.min_desc_matches
            for cand, o in zip(np.asarray(top), np.asarray(ok)):
                if not o:
                    continue
                cand = int(cand)
                pairs = _matched_pairs_cross(
                    m_cur, jnp.asarray(slot), m_old, jnp.asarray(cand))
                if int(pairs.valid.sum()) < cfg.min_sim3_inliers:
                    continue
                if self.rig is not None:
                    res = sim3_mod.ransac_sim3_reproj(
                        self._next_key(), pairs, self.rig.kind,
                        self.rig, fix_scale=self.inertial,
                        min_inliers=cfg.min_sim3_inliers)
                else:
                    res = sim3_mod.ransac_sim3(
                        self._next_key(), pairs.p_a, pairs.p_b,
                        pairs.valid, fix_scale=self.inertial,
                        min_inliers=cfg.min_sim3_inliers)
                if not bool(res.success):
                    continue
                ref = self._verify_sim3(pairs, res)
                if ref is not None:
                    if int(ref.n_inliers) < cfg.min_sim3_inliers:
                        continue
                    res = res._replace(s=ref.s, R=ref.R, t=ref.t)
                # scale sanity for inertial merges (reference: 0.9-1.1
                # gate, LoopClosing.cc:176-204)
                if self.inertial and not (0.9 < float(res.s) < 1.1):
                    continue
                # world Sim3 mapping current-map world -> old-map world:
                # S_w = T_wb(cand) o S_ba o T_bw(slot)
                one = jnp.ones(())
                s1, R1, t1 = lie.sim3_compose(
                    one, m_old.kf_R[cand], m_old.kf_t[cand],
                    res.s, res.R, res.t)
                si, Ri, ti = lie.sim3_inverse(
                    one, m_cur.kf_R[slot], m_cur.kf_t[slot])
                s_w, R_w, t_w = lie.sim3_compose(s1, R1, t1, si, Ri, ti)

                kf_off = int(m_old.n_kf)
                mp_off = int(m_old.n_mp)
                merged, ok_m = atlas_mod.merge_maps(
                    m_old, m_cur, s_w, R_w, t_w)
                if not ok_m:
                    continue
                # record the weld as a permanent merge edge (reference:
                # mspMergeEdges, KeyFrame.h:216-243)
                merged = ms.add_loop_edge(merged, cand, slot + kf_off)
                # welding BA over the seam: the welded-in map's keyframes
                # move, the older map anchors the gauge (reference: the
                # welding LocalBundleAdjustment after MergeLocal's Sim3
                # transform, src/Optimizer.cc:3927; the inertial
                # MergeInertialBA src/Optimizer.cc:4365 analog runs in
                # MultiTracker._remap_after_merge once the preintegration
                # chains are welded)
                if self.rig is not None:
                    from . import tracking as trk
                    K = merged.kf_R.shape[0]
                    free = ((jnp.arange(K) >= kf_off)
                            & merged.kf_valid)
                    merged, _ = trk.welding_ba_step(
                        merged, free, self.rig.kind, self.rig)
                atlas.maps[other_id] = merged
                atlas.maps.pop(cur_id)
                atlas.current = (other_id if other_id < cur_id
                                 else other_id - 1)
                self.n_merges += 1
                return atlas.current, kf_off, mp_off
        return None
