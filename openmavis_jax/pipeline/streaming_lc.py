"""Device-side loop closing for the streaming VI pipeline.

The host-policy `loop_closing.LoopCloser` reads device scalars at every
decision point (candidate counts, RANSAC success flags, projection scores)
— a dozen device->host syncs per invocation, each of which stalls the
frame stream.

This module keeps the decision on the device: the ENTIRE acceptance chain —
retrieval, Sim3 RANSAC, projection refinement, covisible-group projection
verification, temporal-consistency bookkeeping, essential-graph (Sim3 or
4DoF) correction, landmark propagation, and (optionally) the post-loop
FullInertialBA — is ONE jitted device program dispatched once per frame
with zero host reads. Non-keyframe frames fall through a `lax.cond` in
microseconds.

Reference parity (citations into /root/reference):
* retrieval                 KeyFrameDatabase::DetectNBestCandidates
                            src/KeyFrameDatabase.cc:581 — realized as a
                            subsampled direct-descriptor matmul score (the
                            vocabulary-trained KFDB stays the host path;
                            on-device the raw Hamming evidence is
                            affordable and strictly stronger per pair)
* Sim3 RANSAC + refine      LoopClosing.cc:812-935, Sim3Solver.cc,
                            Optimizer::OptimizeSim3 src/Optimizer.cc:2460
* group projection verify   DetectCommonRegionsFromBoW projection gate,
                            src/LoopClosing.cc:944-994
* temporal consistency      mnLoopNumCoincidences machinery,
                            src/LoopClosing.cc:440-520
* correction                CorrectLoop -> OptimizeEssentialGraph(4DoF)
                            src/LoopClosing.cc:1108-1372
* post-loop GBA             RunGlobalBundleAdjustment / FullInertialBA,
                            src/LoopClosing.cc:2351-2470
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie
from ..optim import pose_graph, sim3_refine
from ..slam_map import bow
from ..slam_map import map_state as ms
from ..solvers import sim3 as sim3_mod
from . import loop_closing as lc_mod

__all__ = ["LCCarry", "init_lc_carry", "make_lc_step",
           "make_merge_step"]


def _tree_where(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


class LCCarry(NamedTuple):
    """Device-resident loop-closing state (the host LoopCloser's pending-
    hypothesis dict as arrays)."""
    last_slot: jnp.ndarray    # [] i32 newest processed keyframe slot
    cand: jnp.ndarray         # [] i32 pending candidate (-1 = none)
    pend_slot: jnp.ndarray    # [] i32 slot the pending Sim3 refers to
    count: jnp.ndarray        # [] i32 consecutive confirmations
    s: jnp.ndarray            # [] pending Sim3 body(pend_slot)->body(cand)
    R: jnp.ndarray            # [3,3]
    t: jnp.ndarray            # [3]
    n_loops: jnp.ndarray      # [] i32 total corrections applied
    cooldown: jnp.ndarray     # [] i32 keyframes to skip after a loop
    gba_left: jnp.ndarray     # [] i32 amortized post-loop GBA steps left
    max_tilt: jnp.ndarray     # [] f32 max |roll/pitch| of any verified
    #                              hypothesis (gravity-drift telemetry —
    #                              the measured quantity behind tilt_max)
    merged: jnp.ndarray       # [] bool — cross-map weld already fired
    merge_last: jnp.ndarray   # [] i32 newest slot merge detection saw
    n_merges: jnp.ndarray     # [] i32 total welds applied
    kf_off: jnp.ndarray       # [] i32 slot shift applied by the weld
    # stage telemetry (maxima over the run): [best retrieval score,
    # floor at that time, candidate attempts, matched pairs, RANSAC+
    # refine successes, group projection score] — answers "which gate
    # killed detection" without host reads (one snapshot at the end)
    dbg: jnp.ndarray          # [6] f32


def init_lc_carry() -> LCCarry:
    return LCCarry(
        last_slot=jnp.full((), -1, jnp.int32),
        cand=jnp.full((), -1, jnp.int32),
        pend_slot=jnp.full((), -1, jnp.int32),
        count=jnp.zeros((), jnp.int32),
        s=jnp.ones(()), R=jnp.eye(3), t=jnp.zeros(3),
        n_loops=jnp.zeros((), jnp.int32),
        cooldown=jnp.zeros((), jnp.int32),
        gba_left=jnp.zeros((), jnp.int32),
        max_tilt=jnp.zeros(()),
        merged=jnp.asarray(False),
        merge_last=jnp.full((), -1, jnp.int32),
        n_merges=jnp.zeros((), jnp.int32),
        kf_off=jnp.zeros((), jnp.int32),
        dbg=jnp.zeros((6,)))


def _retrieval_scores(m: ms.MapState, slot):
    """[K] BoW min-intersection scores of keyframe `slot` against every
    keyframe (slam_map/bow.py signatures; reference:
    KeyFrameDatabase::DetectLoopCandidates, src/KeyFrameDatabase.cc:581).

    O(K * W) elementwise — flat per-keyframe cost at any map size, unlike
    the earlier dense pairwise-Hamming subsample whose [CF, K*CF/sub]
    distance matrix grew (and whose memory blew up) with K."""
    return bow.scores(m.kf_bow, m.kf_bow[slot])


def _covis_edges(cov, s0, R_cw, t_cw, n_kf, n_edges: int,
                 threshold: int):
    """Top-`n_edges` covisibility edges (upper triangle, offset >= 2) with
    relative Sim3 measured from current poses (jit replacement of the
    host `_correct` numpy edge harvest)."""
    K = cov.shape[0]
    ii = jax.lax.broadcasted_iota(jnp.int32, (K, K), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (K, K), 1)
    ok = ((jj >= ii + 2) & (cov >= threshold)
          & (ii < n_kf) & (jj < n_kf))
    score = jnp.where(ok, cov, -1).reshape(-1)
    _, flat = jax.lax.top_k(score, n_edges)
    ei = (flat // K).astype(jnp.int32)
    ej = (flat % K).astype(jnp.int32)
    valid = score[flat] > 0
    si_, Ri_, ti_ = lie.sim3_inverse(s0[ei], R_cw[ei], t_cw[ei])
    se, Re, te = lie.sim3_compose(s0[ej], R_cw[ej], t_cw[ej],
                                  si_, Ri_, ti_)
    return pose_graph.PoseGraphEdges(
        i=ei, j=ej, s=se, R=Re, t=te,
        weight=jnp.ones((n_edges,)), valid=valid)


def make_lc_step(cfg, rig_kind: int, n_cams: int, inertial: bool,
                 img_w: float, img_h: float,
                 score_min: int = 40, covis_floor: bool = True,
                 min_pairs: int = 20, min_group: int = 25,
                 temporal: int = 2, recent_exclude: int = 8,
                 covis_exclude: int = 15, cov_edge_threshold: int = 30,
                 n_cov_edges: int = 64, cooldown_kf: int = 10,
                 run_gba: bool = False,
                 tilt_max: float = 0.02, yaw_max: float = 0.349,
                 gba_steps: int = 4, gba_cg: int = 8):
    """Build the jitted per-frame loop-closing program.

    Returns step(m, c, lcc, rig) -> (m, c, lcc) where `c` is the
    streaming VIStreamCarry (its pose is re-expressed through its
    reference keyframe when a correction fires, and its preintegration
    chain feeds the post-loop FullInertialBA).

    Post-loop GBA (reference: the BACKGROUND RunGlobalBundleAdjustment
    thread, src/LoopClosing.cc:1372): `run_gba=True` runs the full
    budget inside the correction dispatch (a ~1 s stall); the default is
    the AMORTIZED path — after a correction, the next `gba_steps`
    keyframe dispatches each run ONE reduced FullInertialBA iteration
    (cg depth `gba_cg`) over the whole map, converging across frames
    without stalling the stream. `gba_steps=0` disables.
    """

    def _solve_candidate(m, key, slot, cand, rig):
        """Matched pairs -> RANSAC -> projection refine. Returns
        (ok, n_pairs, s, R, t) with the Sim3 body(slot)->body(cand).

        Pairs come from TWO sources concatenated: descriptor NN across
        the keyframes (pose-free — survives arbitrary drift) and
        projection-guided matches through the current poses (dense TRUE
        pairs when drift is small vs the search gate — the reference's
        SearchByProjection companion, src/LoopClosing.cc:888)."""
        pairs_nn = lc_mod._pairs_from_tables(
            lc_mod._tables(m), lc_mod._tables(m), slot, cand)
        pairs_pr = lc_mod.pairs_by_projection(
            m, slot, cand, rig_kind, n_cams, rig, img_w, img_h)
        pairs = jax.tree.map(lambda a, b: jnp.concatenate([a, b]),
                             pairs_nn, pairs_pr)
        n_pairs = jnp.sum(pairs.valid.astype(jnp.int32))
        # reprojection-gated RANSAC (Sim3Solver::CheckInliers semantics):
        # robust to drift-distorted local geometry, unlike a 3D gate
        res = sim3_mod.ransac_sim3_reproj(
            key, pairs, rig_kind, rig,
            fix_scale=inertial, min_inliers=min_pairs)
        cam_a = jnp.clip(pairs.cam_a, 0, rig.params.shape[0] - 1)
        cam_b = jnp.clip(pairs.cam_b, 0, rig.params.shape[0] - 1)
        ref = sim3_refine.refine_sim3(
            res.s, res.R, res.t, pairs.p_a, pairs.p_b,
            pairs.uv_a, pairs.uv_b, pairs.sigma2_a, pairs.sigma2_b,
            pairs.valid & res.inlier, rig_kind,
            rig.params[cam_a], rig.params[cam_b],
            rig.R_cb[cam_a], rig.t_cb[cam_a],
            rig.R_cb[cam_b], rig.t_cb[cam_b],
            fix_scale=inertial)
        ok = (res.success & (n_pairs >= min_pairs)
              & (ref.n_inliers >= min_pairs)
              & jnp.isfinite(ref.s) & (ref.s > 0.1) & (ref.s < 10.0))
        return ok, n_pairs, ref.s, ref.R, ref.t

    def _correct(m, c, slot, cand, s_m, R_m, t_m, cov, rig):
        """Essential-graph correction + landmark propagation + carry
        re-expression (+ optional FullInertialBA)."""
        K = m.kf_R.shape[0]
        n_kf = m.n_kf
        R_cw = jnp.swapaxes(m.kf_R, -1, -2)
        t_cw = -jnp.einsum("kij,kj->ki", R_cw, m.kf_t)
        s0 = jnp.ones((K,))
        edges = pose_graph.sequential_edges(s0, R_cw, t_cw, n_kf, K)
        cov_e = _covis_edges(cov, s0, R_cw, t_cw, n_kf, n_cov_edges,
                             cov_edge_threshold)
        si_r, Ri_r, ti_r = lie.sim3_inverse(s_m, R_m, t_m)
        loop_e = pose_graph.PoseGraphEdges(
            i=cand[None], j=slot[None],
            s=si_r[None], R=Ri_r[None], t=ti_r[None],
            weight=jnp.asarray([5.0]), valid=jnp.asarray([True]))
        # persistent edges from earlier loops/merges: re-measure from the
        # current (already consistent) poses so each solve keeps every
        # previously closed loop closed (reference: mspLoopEdges in
        # OptimizeEssentialGraph, src/Optimizer.cc:1826)
        lv = (m.loop_valid & (m.loop_i >= 0) & (m.loop_j >= 0)
              & m.kf_valid[jnp.clip(m.loop_i, 0, K - 1)]
              & m.kf_valid[jnp.clip(m.loop_j, 0, K - 1)])
        li = jnp.clip(m.loop_i, 0, K - 1)
        lj = jnp.clip(m.loop_j, 0, K - 1)
        sli, Rli, tli = lie.sim3_inverse(s0[li], R_cw[li], t_cw[li])
        sle, Rle, tle = lie.sim3_compose(s0[lj], R_cw[lj], t_cw[lj],
                                         sli, Rli, tli)
        stored_e = pose_graph.PoseGraphEdges(
            i=li, j=lj, s=sle, R=Rle, t=tle,
            weight=jnp.full(li.shape, 5.0), valid=lv)
        edges = jax.tree.map(lambda *xs: jnp.concatenate(xs),
                             edges, cov_e, loop_e, stored_e)
        m = ms.add_loop_edge(m, cand, slot)
        fixed = jnp.zeros((K,), bool).at[cand].set(True)
        if inertial:
            edges3 = pose_graph.PoseGraphEdgesSE3(
                i=edges.i, j=edges.j, R=edges.R, t=edges.t,
                weight=edges.weight, valid=edges.valid)
            R_o, t_o, _ = pose_graph.optimize_pose_graph_4dof(
                R_cw, t_cw, edges3, fixed, m.kf_valid)
            s_o = jnp.ones((K,))
        else:
            s_o, R_o, t_o, _ = pose_graph.optimize_pose_graph(
                s0, R_cw, t_cw, edges, fixed, m.kf_valid)

        old_R, old_t = m.kf_R, m.kf_t
        m = lc_mod._correct_map(m, s_o, R_o, t_o)

        if run_gba:
            from . import tracking as trk
            if inertial:
                pre_b = jax.tree.map(lambda x: x[1:], c.chain)
                m, _ = trk.global_inertial_ba_step(
                    m, pre_b, c.chain_valid[1:], rig_kind, rig)
            else:
                m, _ = trk.global_ba_step(m, rig_kind, rig)

        # re-express the live tracker pose through its reference keyframe
        ref = jnp.maximum(c.last_kf_slot, 0)
        R_rel = jnp.swapaxes(old_R[ref], -1, -2) @ c.R
        t_rel = jnp.einsum("ji,j->i", old_R[ref], c.p - old_t[ref])
        dR = m.kf_R[ref] @ jnp.swapaxes(old_R[ref], -1, -2)
        c = c._replace(R=m.kf_R[ref] @ R_rel,
                       p=m.kf_t[ref] + m.kf_R[ref] @ t_rel,
                       v=dR @ c.v)
        return m, c

    @jax.jit
    def step(m, c, lcc: LCCarry, rig):
        slot = m.n_kf - 1
        new_kf = (slot != lcc.last_slot) & (slot > 0)

        # amortized post-loop GBA: one reduced FullInertialBA iteration
        # per keyframe dispatch while the budget lasts (uses gba_left
        # from PREVIOUS dispatches; a fresh correction below re-arms it)
        if gba_steps > 0:
            from . import tracking as trk

            obs_cap = int(getattr(cfg, "obs_cap", 131072))

            def gba_one(m):
                if inertial:
                    pre_b = jax.tree.map(lambda x: x[1:], c.chain)
                    m2, _ = trk.global_inertial_ba_step(
                        m, pre_b, c.chain_valid[1:], rig_kind, rig,
                        stages=(1,), cg_iters=gba_cg, obs_cap=obs_cap)
                else:
                    m2, _ = trk.global_ba_step(
                        m, rig_kind, rig, stages=(1,), cg_iters=gba_cg,
                        obs_cap=obs_cap)
                return m2

            do_gba = new_kf & (lcc.gba_left > 0)
            m = jax.lax.cond(do_gba, gba_one, lambda m: m, m)
            lcc = lcc._replace(
                gba_left=jnp.where(do_gba, lcc.gba_left - 1,
                                   lcc.gba_left))

        fresh_kf = (new_kf & (slot >= recent_exclude)
                    & (lcc.cooldown <= 0))
        lcc = lcc._replace(
            last_slot=jnp.where(slot != lcc.last_slot, slot,
                                lcc.last_slot),
            cooldown=jnp.where(slot != lcc.last_slot,
                               jnp.maximum(lcc.cooldown - 1, 0),
                               lcc.cooldown))

        def process(m, c, lcc):
            key, k1 = jax.random.split(c.key)
            c2 = c._replace(key=key)
            K = m.kf_R.shape[0]
            cov = ms.covisibility_matrix(m)

            # ---- retrieval (fresh candidate) -----------------------
            scores = _retrieval_scores(m, slot)
            idx = jnp.arange(K)
            exclude = ((idx > slot - recent_exclude)
                       | (cov[slot] >= covis_exclude)
                       | ~m.kf_valid | (idx >= m.n_kf))
            sc = jnp.where(exclude, -1, scores)
            cand_new = jnp.argmax(sc).astype(jnp.int32)
            # self-calibrating score floor (reference: minScore = the
            # worst BoW score among the query's covisibility neighbors,
            # src/LoopClosing.cc DetectLoop -> DetectLoopCandidates):
            # a candidate must look at least as similar as the weakest
            # currently-connected keyframe, with `score_min` as an
            # absolute lower bound
            if covis_floor:
                neigh = ((cov[slot] >= covis_exclude) & m.kf_valid
                         & (idx < m.n_kf) & (idx != slot))
                min_cov = jnp.min(jnp.where(neigh, scores, 1 << 24))
                floor = jnp.where(jnp.any(neigh),
                                  jnp.maximum(score_min, min_cov),
                                  score_min)
            else:
                floor = score_min
            cand_ok = sc[cand_new] >= floor

            # pending hypothesis takes priority (temporal consistency)
            has_pending = (lcc.cand >= 0) & (slot > lcc.pend_slot)
            cand = jnp.where(has_pending, lcc.cand, cand_new)

            better = sc[cand_new] > lcc.dbg[0]
            lcc = lcc._replace(dbg=lcc.dbg
                               .at[0].max(sc[cand_new].astype(
                                   jnp.float32))
                               .at[1].set(jnp.where(
                                   better, floor, lcc.dbg[1])))

            def attempt(m, c2, lcc):
                """RANSAC + refine + group verify + (maybe) correction —
                only dispatched when retrieval produced a candidate above
                the floor or a pending hypothesis awaits confirmation;
                keyframes without a plausible candidate skip the whole
                chain (reference: LoopClosing::NewDetectCommonRegions
                returns early on empty candidate lists,
                src/LoopClosing.cc:401-447)."""
                ok_s, n_pairs, s_n, R_n, t_n = _solve_candidate(
                    m, k1, slot, cand, rig)
                lcc = lcc._replace(dbg=lcc.dbg
                                   .at[2].add(1.0)
                                   .at[3].max(n_pairs.astype(
                                       jnp.float32))
                                   .at[4].add(ok_s.astype(jnp.float32)))

                # hypothesis to verify: recomposed pending Sim3 when
                # pending, else the fresh solve
                # (S'(slot->cand) = S_p o T(pend<-slot))
                R_o, t_o = m.kf_R[lcc.pend_slot], m.kf_t[lcc.pend_slot]
                R_s, t_s = m.kf_R[slot], m.kf_t[slot]
                R_re = lcc.R @ R_o.T @ R_s
                t_re = (lcc.s * (lcc.R @ (R_o.T @ (t_s - t_o)))
                        + lcc.t)
                s_h = jnp.where(has_pending, lcc.s, s_n)
                R_h = jnp.where(has_pending, R_re, R_n)
                t_h = jnp.where(has_pending, t_re, t_n)

                g_score = lc_mod.group_projection_score(
                    m, slot, cand, cov[cand], s_h, R_h, t_h, rig_kind,
                    n_cams, rig, img_w, img_h)
                lcc = lcc._replace(
                    dbg=lcc.dbg.at[5].max(g_score.astype(jnp.float32)))
                # a fresh hypothesis must pass BOTH the retrieval-score
                # gate and the solve; excluded keyframes (argmax
                # fallback when all scores are -1) can never be verified
                verified = (g_score >= min_group) & (has_pending
                                                     | (cand_ok & ok_s))
                tilt_obs = lcc.max_tilt
                if inertial:
                    # gravity-direction gate: the implied world
                    # correction must not tilt roll/pitch (gravity is
                    # observable), and yaw must stay sane ("BAD LOOP"
                    # branch, reference: src/LoopClosing.cc:307-335 uses
                    # |phi_xy| < 0.008; tilt_max defaults 0.02 — round-5
                    # telemetry (lcc.max_tilt) measures verified-
                    # hypothesis tilt at 0.002-0.012 rad on the flagship
                    # and long benches, so 0.02 covers genuine loops
                    # with ~2x margin while refusing mis-orientations;
                    # the r4 0.08 default predated the telemetry)
                    R_corr = m.kf_R[cand] @ R_h @ m.kf_R[slot].T
                    phi = lie.so3_log(R_corr)
                    tilt = jnp.maximum(jnp.abs(phi[0]),
                                       jnp.abs(phi[1]))
                    # telemetry: the measured tilt of group-verified
                    # hypotheses — the quantity tilt_max must cover
                    tilt_obs = jnp.where(verified,
                                         jnp.maximum(tilt_obs, tilt),
                                         tilt_obs)
                    verified = (verified
                                & (jnp.abs(phi[0]) < tilt_max)
                                & (jnp.abs(phi[1]) < tilt_max)
                                & (jnp.abs(phi[2]) < yaw_max))

                count = jnp.where(
                    verified, jnp.where(has_pending, lcc.count + 1, 1),
                    0)
                # correction Sim3: prefer a fresh solve at the
                # confirming keyframe; fall back to the group-verified
                # recomposed pending hypothesis (the RANSAC hit rate per
                # keyframe is well below 1 — requiring a fresh success
                # at the exact confirm slot would drop most temporally-
                # consistent loops)
                confirm = verified & (count >= temporal)
                s_u = jnp.where(ok_s, s_n, s_h)
                R_u = jnp.where(ok_s, R_n, R_h)
                t_u = jnp.where(ok_s, t_n, t_h)

                def fire(m, c2):
                    return _correct(m, c2, slot, cand, s_u, R_u, t_u,
                                    cov, rig)

                m, c2x = jax.lax.cond(confirm, fire,
                                      lambda m, c2: (m, c2), m, c2)
                lcc2 = lcc._replace(
                    cand=jnp.where(confirm | ~verified, -1, cand),
                    pend_slot=jnp.where(verified & ~confirm, slot,
                                        -1).astype(jnp.int32),
                    count=jnp.where(confirm, 0, count),
                    s=jnp.where(verified & ~has_pending, s_n, s_h),
                    R=jnp.where(verified & ~has_pending, R_n, R_h),
                    t=jnp.where(verified & ~has_pending, t_n, t_h),
                    n_loops=lcc.n_loops + confirm.astype(jnp.int32),
                    cooldown=jnp.where(confirm, cooldown_kf,
                                       lcc.cooldown),
                    gba_left=jnp.where(confirm, gba_steps,
                                       lcc.gba_left),
                    max_tilt=tilt_obs)
                return m, c2x, lcc2

            return jax.lax.cond(cand_ok | has_pending, attempt,
                                lambda m, c2, lcc: (m, c2, lcc),
                                m, c2, lcc)

        return jax.lax.cond(fresh_kf, process,
                            lambda m, c, lcc: (m, c, lcc), m, c, lcc)

    return step


def make_merge_step(cfg, rig_kind: int, n_cams: int, inertial: bool,
                    img_w: float, img_h: float,
                    score_min: int = 40, min_pairs: int = 20,
                    min_group: int = 30, weld_ba: bool = True,
                    scale_lo: float = 0.9, scale_hi: float = 1.1,
                    min_kf: int = 5):
    """Device-side CROSS-MAP merge for the streaming pipeline.

    The reference detects merge candidates in other Atlas maps inside the
    LoopClosing thread and welds the current map into the older one —
    stop mapper -> Sim3 transform -> slab migration -> welding BA
    (MergeLocal2, src/LoopClosing.cc:1956-2130). The host path
    (loop_closing.LoopCloser.detect_merge) reads device scalars back at
    every decision; this step runs the WHOLE
    chain — BoW retrieval against the resident secondary slab, cross-map
    Sim3 RANSAC + refine, group projection verification, scale sanity,
    the traced weld (atlas.merge_maps_device), carry/trajectory slot
    remapping, preintegration-chain shift, and the welding BA — as part
    of the per-frame fused program with zero host reads.

    Returns step(m, c, lcc, m2, rig) -> (m, c, lcc): `m2` is the OLDER
    map (the weld destination — its keyframes anchor the gauge); on a
    confirmed weld the merged slab REPLACES `m` and lcc.merged flips, so
    detection never re-fires. Capacity: m2's free slots must hold m
    (merge_maps_device's `fits`), or the weld is skipped.
    """
    from ..slam_map import atlas as atlas_mod
    from . import tracking as trk

    def _step(m, c, lcc: LCCarry, m2, rig):
        slot = m.n_kf - 1
        # maturity gate: the current map needs structure (and, for
        # inertial rigs, a few keyframes of gravity/scale settling)
        # before a weld is trustworthy — an immature weld freezes early
        # drift into the seam
        fresh = ((slot != lcc.merge_last) & (slot >= min_kf - 1)
                 & ~lcc.merged & (m2.n_kf >= 2))
        lcc = lcc._replace(
            merge_last=jnp.where(slot != lcc.merge_last, slot,
                                 lcc.merge_last))

        def detect(m, c, lcc):
            key, k1 = jax.random.split(c.key)
            c = c._replace(key=key)
            K2 = m2.kf_R.shape[0]
            # retrieval against the secondary map's BoW signatures
            scores = bow.scores(m2.kf_bow, m.kf_bow[slot])
            idx2 = jnp.arange(K2)
            sc = jnp.where(m2.kf_valid & (idx2 < m2.n_kf), scores, -1)
            cand = jnp.argmax(sc).astype(jnp.int32)
            cand_ok = sc[cand] >= score_min

            def attempt(m, c, lcc):
                pairs = lc_mod._pairs_from_tables(
                    lc_mod._tables(m), lc_mod._tables(m2), slot, cand)
                n_pairs = jnp.sum(pairs.valid.astype(jnp.int32))
                res = sim3_mod.ransac_sim3_reproj(
                    k1, pairs, rig_kind, rig,
                    fix_scale=inertial, min_inliers=min_pairs)
                cam_a = jnp.clip(pairs.cam_a, 0,
                                 rig.params.shape[0] - 1)
                cam_b = jnp.clip(pairs.cam_b, 0,
                                 rig.params.shape[0] - 1)
                ref = sim3_refine.refine_sim3(
                    res.s, res.R, res.t, pairs.p_a, pairs.p_b,
                    pairs.uv_a, pairs.uv_b, pairs.sigma2_a,
                    pairs.sigma2_b, pairs.valid & res.inlier, rig_kind,
                    rig.params[cam_a], rig.params[cam_b],
                    rig.R_cb[cam_a], rig.t_cb[cam_a],
                    rig.R_cb[cam_b], rig.t_cb[cam_b],
                    fix_scale=inertial)
                ok = (res.success & (n_pairs >= min_pairs)
                      & (ref.n_inliers >= min_pairs)
                      & jnp.isfinite(ref.s)
                      # inertial merges: scale must be near 1 (gravity
                      # fixes scale in both maps — reference
                      # scale-sanity gate, LoopClosing.cc:176-204)
                      & (ref.s > (scale_lo if inertial else 0.1))
                      & (ref.s < (scale_hi if inertial else 10.0)))
                cov2 = ms.covisibility_matrix(m2)
                g = lc_mod.group_projection_score_cross(
                    m, slot, m2, cand, cov2[cand],
                    ref.s, ref.R, ref.t, rig_kind, n_cams, rig,
                    img_w, img_h)
                confirm = ok & (g >= min_group)

                def weld(m, c, lcc):
                    # world Sim3 current-world -> m2-world:
                    # S_w = T_wb2(cand) o S_ba o T_bw(slot)
                    one = jnp.ones(())
                    s1, R1, t1 = lie.sim3_compose(
                        one, m2.kf_R[cand], m2.kf_t[cand],
                        ref.s, ref.R, ref.t)
                    si, Ri, ti = lie.sim3_inverse(
                        one, m.kf_R[slot], m.kf_t[slot])
                    s_w, R_w, t_w = lie.sim3_compose(s1, R1, t1,
                                                     si, Ri, ti)
                    kf_off = m2.n_kf
                    mp_off = m2.n_mp
                    merged, fits = atlas_mod.merge_maps_device(
                        m2, m, s_w, R_w, t_w)
                    merged = ms.add_loop_edge(merged, cand,
                                              slot + kf_off)

                    # carry into the merged world + shifted slots
                    K = m.kf_R.shape[0]
                    c2 = c._replace(
                        R=lie.normalize_rotation(R_w @ c.R),
                        p=s_w * (R_w @ c.p) + t_w,
                        v=s_w * (R_w @ c.v),
                        last_kf_slot=c.last_kf_slot + kf_off)
                    # every ring entry recorded this session references
                    # a slot of the pre-merge slab (unwritten entries
                    # are overwritten before they are ever read)
                    tr_ = c2.traj._replace(ref=c2.traj.ref + kf_off)
                    ks = jnp.arange(K)
                    tgt = jnp.where(ks < m.n_kf, ks + kf_off, K)

                    def shift_chain(x):
                        ext = jnp.concatenate(
                            [jnp.zeros_like(x),
                             jnp.zeros_like(x[:1])], axis=0)
                        return ext.at[tgt].set(x)[:K]

                    c2 = c2._replace(
                        traj=tr_,
                        chain=jax.tree.map(shift_chain, c.chain),
                        chain_valid=jnp.zeros(
                            (K + 1,), bool).at[tgt].set(
                            c.chain_valid)[:K])

                    if weld_ba:
                        free = ((jnp.arange(K) >= kf_off)
                                & merged.kf_valid)
                        merged, _ = trk.welding_ba_step(
                            merged, free, rig_kind, rig,
                            obs_cap=int(getattr(cfg, "obs_cap",
                                                131072)))
                    lcc2 = lcc._replace(
                        merged=jnp.asarray(True),
                        n_merges=lcc.n_merges + 1,
                        kf_off=kf_off,
                        # loop-closer bookkeeping shifts with the slots
                        last_slot=lcc.last_slot + kf_off,
                        merge_last=lcc.merge_last + kf_off,
                        cand=jnp.full((), -1, jnp.int32),
                        pend_slot=jnp.full((), -1, jnp.int32),
                        count=jnp.zeros((), jnp.int32))
                    out_m = _tree_where(fits, merged, m)
                    out_c = _tree_where(fits, c2, c)
                    out_l = _tree_where(fits, lcc2, lcc)
                    return out_m, out_c, out_l

                return jax.lax.cond(confirm, weld,
                                    lambda m, c, lcc: (m, c, lcc),
                                    m, c, lcc)

            return jax.lax.cond(cand_ok, attempt,
                                lambda m, c, lcc: (m, c, lcc),
                                m, c, lcc)

        return jax.lax.cond(fresh, detect,
                            lambda m, c, lcc: (m, c, lcc), m, c, lcc)

    return _step
