"""Streaming multi-camera visual-inertial tracker — the flagship MAVIS
pipeline as ONE device program per frame.

This is the VI generalization of `streaming.py`: the whole per-frame state
machine — IMU preintegration, prediction, multi-camera projection tracking
with full 15-dof inertial pose optimization, relocalization, the keyframe
decision, the mapper chain (stereo + temporal spawn / bind / fuse / cull /
VI window BA), keyframe-slot recycling with preintegration-chain welding,
and the staged IMU initialization (InertialOptimization -> gravity-align ->
FullInertialBA, with the VIBA1/VIBA2 refinement schedule) — runs inside a
single jit-compiled step under `lax.cond`/`lax.switch`. The host loop only
enqueues `step` once per frame with the image stack and a fixed-capacity
padded IMU sample buffer; there are ZERO device->host reads until
`finalize()`.

Why: the host-policy `multi_tracking.MultiTracker` reads `int(n_in)` and
other decisions back every frame, so each frame waits for the device to
drain before the next one is enqueued. Here the host never waits inside
the stream: frames are enqueued back to back and the device runs ahead.

Reference parity map (all citations into /root/reference):
* per-frame flow            Tracking::GrabImageMulti src/Tracking.cc:1410
* banding                   multi Frame ctor src/Frame.cc:1767-1949
* IMU preintegration        Tracking::PreintegrateIMU src/Tracking.cc:1625
* prediction                Tracking::PredictStateIMU src/Tracking.cc:1723
* VI pose optimization      Optimizer::PoseInertialOptimizationLastFrame
                            src/Optimizer.cc:5580
* keyframe pipeline         LocalMapping::ProcessNewKeyFrame/
                            CreateNewMapPoints src/LocalMapping.cc:395-786
* staged IMU init + VIBA    LocalMapping::InitializeIMU src/LocalMapping.cc
                            :203-265, 1255; Optimizer::FullInertialBA
                            src/Optimizer.cc:368
* KF culling + chain merge  LocalMapping::KeyFrameCulling
                            src/LocalMapping.cc:974 +
                            IMU::Preintegrated::MergePrevious
                            src/ImuTypes.cc:241-263
* mono-inertial init        Tracking::MonocularInitialization
                            src/Tracking.cc:2411 (scale recovered later by
                            the fix_scale=False inertial init)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..frontend import depth as depth_mod
from ..frontend import extractor, matcher
from ..geometry import cameras
from ..imu import preintegration as pre_mod
from ..optim import pose_opt
from ..optim.reprojection import RigParams
from ..slam_map import map_state as ms
from ..solvers import two_view
from . import multi_tracking as mt
from . import tracking as trk
from .streaming import NEED_REF, INIT, OK, LOST, TrajRing, _masked_median

__all__ = ["VIStreamConfig", "VIStreamCarry", "StreamingVITracker",
           "make_step", "init_carry"]


def _tree_where(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


class VIStreamCarry(NamedTuple):
    """Device-resident tracker state (everything the host tracker keeps as
    Python attributes, as arrays)."""
    R: jnp.ndarray            # [3,3] world-from-body
    p: jnp.ndarray            # [3]
    v: jnp.ndarray            # [3]
    bg: jnp.ndarray           # [3] gyro bias
    ba: jnp.ndarray           # [3] accel bias
    vel_R: jnp.ndarray        # [3,3] constant-velocity motion model
    vel_t: jnp.ndarray        # [3]
    mode: jnp.ndarray         # [] i32: NEED_REF/INIT/OK/LOST
    imu_ok: jnp.ndarray       # [] bool — IMU initialized
    viba_stage: jnp.ndarray   # [] i32: 0 none, 1 init, 2 VIBA1, 3 VIBA2
    first_kf_time: jnp.ndarray
    last_kf_time: jnp.ndarray
    last_time: jnp.ndarray
    has_last: jnp.ndarray     # [] bool — last_time is meaningful
    last_kf_slot: jnp.ndarray
    ref_kf_inliers: jnp.ndarray
    lost_frames: jnp.ndarray
    boost: jnp.ndarray        # [] i32 frames of widened search post-LOST
    key: jnp.ndarray
    pre_acc: pre_mod.Preintegrated   # since last keyframe
    chain: pre_mod.Preintegrated     # [K] per-KF interval (k-1 -> k)
    chain_valid: jnp.ndarray         # [K] bool
    ref_bank: dict            # mono two-view init reference bank
    ref_time: jnp.ndarray
    traj: TrajRing


@dataclass(frozen=True)
class VIStreamConfig:
    img_w: int = 640
    img_h: int = 480
    n_cams: int = 4
    stereo_pairs: tuple = ((0, 1),)
    # per-camera (colBegin, colEnd) stereo lapping areas; () = full width
    # (reference: CameraN.overlappingBegin/End, mvLappingArea)
    lapping: tuple = ()
    orb: extractor.OrbConfig = None
    use_imu: bool = True
    imu_freq: float = 200.0
    imu_per_frame: int = 32      # padded IMU samples per step
    max_kf: int = 64
    max_mp: int = 8192
    traj_cap: int = 4096
    match_radius: float = 15.0
    relost_radius: float = 30.0
    local_map_window: int | None = None
    min_inliers_track: int = 20
    kf_min_inlier_frac: float = 0.75
    kf_min_inliers_abs: int = 60
    kf_max_interval_s: float = 0.5
    new_mp_cap: int = 256
    ba_window: int = 8
    # LM stage schedule of the per-KF VI window BA (reference:
    # LocalInertialBA runs 4-10 iterations, src/Optimizer.cc:2740-2746);
    # each iteration is a sequential dense-Schur solve, so the schedule
    # is a direct per-KF cost knob
    ba_stages: tuple = (4, 6)
    temporal_refs: int = 2
    imu_init_kfs: int = 8
    viba1_time: float = 5.0
    viba2_time: float = 15.0
    init_min_matches: int = 80
    init_min_inliers: int = 50
    min_rig_landmarks: int = 40  # rig-init success threshold
    ba_every_kf: bool = True
    # frames per device dispatch: >1 wraps the per-frame step in a
    # lax.scan over the chunk; the host buffers frames and flushes on
    # block()/snapshot(). Latency rises by (chunk-1) frame periods.
    frames_per_dispatch: int = 1
    # motion-only pose-opt LM schedule (reference: 4 rounds x 10 iters
    # with chi2 re-gating between rounds, src/Optimizer.cc:855; the
    # rounds are SEQUENTIAL depth — the dominant per-frame cost — and
    # with an IMU-predicted warm start fewer converge identically)
    po_rounds: int = 4
    po_iters: int = 7
    # whole-map observation-table cap for FullInertialBA / GBA events
    # (tracking.full_map_observations): bound observations beyond the cap
    # drop oldest-keyframe rows silently — size above the expected bound
    # count (snapshot()["n_obs"] reports the live count)
    obs_cap: int = 131072
    # per-frame tracking matches against <= this many landmarks (the
    # most recently observed; multi_tracking._local_map_compact) so
    # frame cost is O(cap), independent of slab capacity. 0 = whole map
    # (at max_mp <= 16k the compaction's random descriptor gathers cost
    # about as much as the Hamming compute they save; enable at larger
    # slabs).
    track_map_cap: int = 0
    # external per-camera depth priors (reference: multi-camera depth
    # maps sampled at undistorted keypoints into pseudo-stereo,
    # src/Frame.cc:1659-1765, 1916-1922): push() takes a [C, H, W]
    # z-depth stack per frame; unbound keyframe features spawn landmarks
    # at measured metric depth — locking scale BEFORE inertial init
    use_depth: bool = False
    depth_cap: int = 256          # new landmarks per KF from depth
    depth_max: float = 25.0       # max spawn depth (m)
    # per-camera virtual-pinhole (fx, fy, cx, cy) the depth maps live in;
    # () = depth maps are in the raw camera frame (undistorted pinholes)
    depth_pin: tuple = ()

    @property
    def metric_scale(self) -> bool:
        return len(self.stereo_pairs) > 0 or self.use_depth


def _empty_bank(C: int, F: int) -> dict:
    CF = C * F
    return dict(
        xy=jnp.zeros((CF, 2)),
        desc=jnp.zeros((CF, 256), jnp.int8),
        level=jnp.zeros((CF,), jnp.int32),
        sigma2=jnp.ones((CF,)),
        cam=jnp.repeat(jnp.arange(C, dtype=jnp.int32), F),
        valid=jnp.zeros((CF,), bool),
    )


def init_carry(cfg: VIStreamConfig, seed: int = 0) -> VIStreamCarry:
    orb_cfg = cfg.orb or extractor.OrbConfig()
    F = orb_cfg.n_features
    K = cfg.max_kf
    cap = cfg.traj_cap
    return VIStreamCarry(
        R=jnp.eye(3), p=jnp.zeros(3), v=jnp.zeros(3),
        bg=jnp.zeros(3), ba=jnp.zeros(3),
        vel_R=jnp.eye(3), vel_t=jnp.zeros(3),
        mode=jnp.asarray(NEED_REF, jnp.int32),
        imu_ok=jnp.asarray(False),
        viba_stage=jnp.zeros((), jnp.int32),
        first_kf_time=jnp.zeros(()),
        last_kf_time=jnp.zeros(()),
        last_time=jnp.zeros(()),
        has_last=jnp.asarray(False),
        last_kf_slot=jnp.full((), -1, jnp.int32),
        ref_kf_inliers=jnp.zeros((), jnp.int32),
        lost_frames=jnp.zeros((), jnp.int32),
        boost=jnp.zeros((), jnp.int32),
        key=jax.random.PRNGKey(seed),
        pre_acc=pre_mod.init_preintegrated(jnp.zeros(6)),
        chain=pre_mod.chain_allocate(K),
        chain_valid=jnp.zeros((K,), bool),
        ref_bank=_empty_bank(cfg.n_cams, F),
        ref_time=jnp.zeros(()),
        traj=TrajRing(
            time=jnp.zeros((cap,)), ref=jnp.zeros((cap,), jnp.int32),
            R_rel=jnp.tile(jnp.eye(3), (cap, 1, 1)),
            t_rel=jnp.zeros((cap, 3)), ok=jnp.zeros((cap,), bool),
            idx=jnp.zeros((), jnp.int32)),
    )


def _record(m: ms.MapState, c: VIStreamCarry, time, ok) -> VIStreamCarry:
    ref = jnp.maximum(c.last_kf_slot, 0)
    R_ref, t_ref = m.kf_R[ref], m.kf_t[ref]
    tr = c.traj
    i = jnp.minimum(tr.idx, tr.time.shape[0] - 1)
    tr = tr._replace(
        time=tr.time.at[i].set(time), ref=tr.ref.at[i].set(ref),
        R_rel=tr.R_rel.at[i].set(R_ref.T @ c.R),
        t_rel=tr.t_rel.at[i].set(R_ref.T @ (c.p - t_ref)),
        ok=tr.ok.at[i].set(ok), idx=tr.idx + 1)
    return c._replace(traj=tr)


_STEP_CACHE: dict = {}


def _bind(jitted, *tail):
    """Fix the trailing traced arguments (rig, noise, dist) of a cached
    jitted step. `.lower` gives the AOT view of the same program."""
    def fn(*args):
        return jitted(*args, *tail)

    fn.lower = lambda *args: jitted.lower(*args, *tail)
    return fn


def make_step(rig: RigParams, cfg: VIStreamConfig, noise: pre_mod.ImuNoise,
              dist=None):
    """Build (or reuse) the jitted streaming VI step for this config:
    step(m, c, images, time, imu_w, imu_a, imu_dt, depth) -> (m, c).

    The cached program takes rig/noise as traced pytrees (rig.kind is
    static), so fresh trackers with different intrinsics share the compile.
    """
    inner = _make_step_inner(cfg, rig.kind, dist is not None)
    return _bind(inner, rig, noise, dist if dist is not None else 0.0)


def _make_step_inner(cfg: VIStreamConfig, rig_kind: int, has_dist: bool):
    key_ = (cfg, rig_kind, has_dist)
    cached = _STEP_CACHE.get(key_)
    if cached is not None:
        return cached

    orb_cfg = cfg.orb or extractor.OrbConfig()
    F = orb_cfg.n_features
    C = cfg.n_cams
    CF = C * F
    W, H = float(cfg.img_w), float(cfg.img_h)
    Kmax = cfg.max_kf
    Wn = cfg.ba_window
    use_imu = cfg.use_imu
    metric = cfg.metric_scale

    # ---------------- shared helpers ----------------
    def extract_bank(images, rig, dist):
        feats = extractor.extract_multicam(images, orb_cfg)
        if has_dist:
            feats = extractor.undistort_features(feats, rig.params, dist)
        return mt.concat_bands(feats)

    def band0_feats(bank) -> extractor.Features:
        sl = slice(0, F)
        return extractor.Features(
            xy=bank["xy"][sl], response=jnp.zeros((F,)),
            angle=jnp.zeros((F,)), level=bank["level"][sl],
            sigma2=bank["sigma2"][sl], desc=bank["desc"][sl],
            valid=bank["valid"][sl])

    def bias_of(c):
        return jnp.concatenate([c.bg, c.ba])

    def min_last_of(c):
        if cfg.local_map_window is None:
            return jnp.full((), -1, jnp.int32)
        return c.last_kf_slot - cfg.local_map_window

    # ------------- chain welding across keyframe compaction -------------
    def weld_chain(chain, chain_valid, kf_valid_old, new_of_old):
        """Re-express the per-KF preintegration chain after compaction:
        the interval into each SURVIVING keyframe is the composition of
        every old interval since the previous survivor (the closed-form
        equivalent of IMU::Preintegrated::MergePrevious,
        src/ImuTypes.cc:241-263)."""
        ident = pre_mod.init_preintegrated(jnp.zeros(6))

        def body(carry, k):
            acc, ok_all = carry
            entry = pre_mod.chain_get(chain, k)
            ev = chain_valid[k]
            composed = pre_mod.compose(acc, pre_mod.rebias(entry, acc.b))
            acc = _tree_where(ev, composed, acc)
            ok_all = ok_all & ev
            emit = (acc, ok_all)
            surv = kf_valid_old[k]
            acc = _tree_where(surv, ident, acc)
            ok_all = jnp.where(surv, True, ok_all)
            return (acc, ok_all), emit

        (_, _), (accs, oks) = jax.lax.scan(
            body, (ident, jnp.asarray(True)), jnp.arange(Kmax))
        tgt = jnp.where(kf_valid_old, new_of_old, Kmax)
        fresh = pre_mod.chain_allocate(Kmax + 1)
        chain2 = jax.tree.map(
            lambda cn, a: cn.at[tgt].set(a)[:Kmax], fresh, accs)
        valid2 = jnp.zeros((Kmax + 1,), bool).at[tgt].set(oks)[:Kmax]
        return chain2, valid2

    def recycle(m, c):
        """Free keyframe + landmark slots when the slab is full: decimate
        if redundancy culling freed nothing, compact, weld the chain, and
        remap the trajectory ring + last_kf_slot."""
        nvalid = jnp.sum(m.kf_valid.astype(jnp.int32))
        m = _tree_where(nvalid >= Kmax,
                        ms.decimate_keyframes(m, m.n_kf - 1)[0], m)
        kf_valid_old = m.kf_valid
        m, old_of_new, new_of_old = ms.compact_keyframes(m)
        chain2, cvalid2 = weld_chain(c.chain, c.chain_valid,
                                     kf_valid_old, new_of_old)
        m, _ = ms.compact_landmarks(m)
        tr = c.traj
        tr = tr._replace(ref=new_of_old[jnp.clip(tr.ref, 0, Kmax - 1)])
        c = c._replace(
            chain=chain2, chain_valid=cvalid2, traj=tr,
            last_kf_slot=new_of_old[
                jnp.clip(c.last_kf_slot, 0, Kmax - 1)])
        return m, c

    # ------------------ staged IMU initialization ------------------
    def imu_init_maybe(m, c, time, rig):
        """InertialOptimization -> ApplyScaledRotation -> FullInertialBA,
        on the VIBA schedule (reference: LocalMapping.cc:203-265, 1255)."""
        if not use_imu:
            return m, c
        n_kf = m.n_kf
        idx = jnp.arange(1, Kmax)
        edge_valid = (c.chain_valid[1:] & m.kf_valid[1:] & m.kf_valid[:-1]
                      & (idx < n_kf))
        enough = jnp.sum(edge_valid.astype(jnp.int32)) >= n_kf - 2
        tinit = time - c.first_kf_time
        st = c.viba_stage
        want = (((st == 0) & (n_kf >= cfg.imu_init_kfs))
                | ((st == 1) & (tinit > cfg.viba1_time))
                | ((st == 2) & (tinit > cfg.viba2_time)))
        do = want & enough & (n_kf >= 3) & (st < 3)

        def run(m, c):
            first = c.viba_stage == 0
            prior_g = jnp.where(first, 1e2,
                                jnp.where(c.viba_stage == 1, 1.0, 0.0))
            pa0 = 1e5 if metric else 1e10
            prior_a = jnp.where(first, pa0,
                                jnp.where(c.viba_stage == 1, 1e5, 0.0))
            pre_b = jax.tree.map(lambda x: x[1:], c.chain)
            m2, bias2, ok = mt.imu_init_step(
                m, pre_b, edge_valid, bias_of(c), first, prior_g,
                prior_a, rig_kind, metric, rig,
                obs_cap=min(cfg.obs_cap,
                            Kmax * C * orb_cfg.n_features))

            def apply(m2, c):
                slot = jnp.maximum(c.last_kf_slot, 0)
                c2 = c._replace(
                    R=m2.kf_R[slot], p=m2.kf_t[slot], v=m2.kf_v[slot],
                    bg=m2.kf_bg[slot], ba=m2.kf_ba[slot],
                    imu_ok=jnp.asarray(True),
                    viba_stage=c.viba_stage + 1)
                return m2, c2

            return jax.lax.cond(ok, apply, lambda m2, c: (m2, c), m2, c)

        return jax.lax.cond(do, run, lambda m, c: (m, c), m, c)

    # ------------------ window BA (visual / VI) ------------------
    def vi_window_ba(m, c, slot, rig):
        """VI window BA over the last `ba_window` keyframes with the
        temporal inertial chain (reference: LocalInertialBA,
        src/Optimizer.cc:4763) — shared device program with the
        host-policy tracker (mt.vi_window_ba_step)."""
        lo = jnp.maximum(slot - Wn + 1, 0)
        ids = lo + jnp.arange(Wn)
        kf_in = (ids <= slot) & m.kf_valid[ids]
        pre_w = jax.tree.map(lambda x: x[ids[1:]], c.chain)
        edge_ok = (c.chain_valid[ids[1:]] & kf_in[1:] & kf_in[:-1]
                   & c.imu_ok)
        m, bias_new = mt.vi_window_ba_step(
            m, ids, kf_in, pre_w, edge_ok, slot - lo, rig_kind, rig,
            stages=cfg.ba_stages)
        c = c._replace(bg=bias_new[:3], ba=bias_new[3:])
        return m, c

    # ------------------ keyframe pipeline ------------------
    def kf_insert(m, c, bank, time, feat_mp, n_in, rig, depth):
        # recycle slots if the slab is full (device-side compaction)
        m, c = jax.lax.cond(m.n_kf >= Kmax, recycle,
                            lambda m, c: (m, c), m, c)
        slot = m.n_kf
        m = ms.insert_keyframe(
            m, slot, c.R, c.p, c.v, c.bg, c.ba, time,
            bank["xy"], bank["desc"], bank["level"], bank["sigma2"],
            bank["cam"], bank["valid"], feat_mp)
        # store the accumulated preintegration as this KF's chain entry
        acc_ok = (c.pre_acc.dT > 0) & (c.last_kf_slot >= 0)
        if use_imu:
            c = c._replace(
                chain=pre_mod.chain_set(c.chain, slot, c.pre_acc),
                chain_valid=c.chain_valid.at[slot].set(acc_ok),
                pre_acc=pre_mod.init_preintegrated(bias_of(c)))

        # depth-prior points first: measured metric depth beats
        # triangulation and needs no parallax (Frame.cc:1916-1922)
        if cfg.use_depth:
            m, _ = depth_mod.spawn_from_depth_multi(
                m, slot, rig_kind, C, rig, depth,
                pin_params=cfg.depth_pin or None,
                cap_new=cfg.depth_cap, max_spawn_depth=cfg.depth_max)
        # intra-rig stereo points (metric)
        for pair in cfg.stereo_pairs:
            m, _ = mt.stereo_spawn(m, slot, rig_kind, C, rig, pair,
                                   cap_new=cfg.new_mp_cap,
                                   lap1=mt._lap(cfg, pair[0]),
                                   lap2=mt._lap(cfg, pair[1]))
        # temporal points per camera band against recent KFs
        if cfg.temporal_refs > 0:
            refs = slot - 1 - jnp.arange(cfg.temporal_refs,
                                         dtype=jnp.int32)
            m, _ = mt.temporal_spawn_multi(m, slot, refs, rig_kind, C,
                                           rig, cfg.new_mp_cap,
                                           n_refs=cfg.temporal_refs)
        # binding honors the same local-map window as tracking: without
        # it, revisited landmarks re-bind globally and silently close
        # loops the loop closer should own (reference: SearchInNeighbors
        # fuses within the covisible neighborhood only,
        # src/LocalMapping.cc:786)
        m = mt.bind_landmarks_multi(m, slot, rig_kind, C, rig, W, H,
                                    min_last_kf=min_last_of(c))
        m = trk.fuse_new_landmarks(m, slot, cap=cfg.new_mp_cap)
        m = trk.cull_landmarks(m, slot)
        m, culled = trk.cull_keyframes(m, slot, inertial=use_imu,
                                       imu_ok=c.imu_ok)
        if use_imu:
            # weld the temporal chain across each culled keyframe
            # (MergePrevious, src/ImuTypes.cc:241); cull_keyframes never
            # removes adjacent slots in one pass, so welds are disjoint
            for k in range(culled.shape[0]):
                ck = culled[k]
                cu = jnp.maximum(ck, 0)
                nxt = jnp.minimum(cu + 1, Kmax - 1)
                a = pre_mod.chain_get(c.chain, cu)
                b = pre_mod.chain_get(c.chain, nxt)
                welded = pre_mod.compose(a, pre_mod.rebias(b, a.b))
                do_weld = (ck >= 0) & (ck + 1 < Kmax)
                new_nxt = _tree_where(do_weld, welded, b)
                chain = pre_mod.chain_set(c.chain, nxt, new_nxt)
                cvalid = c.chain_valid
                ok_w = cvalid[cu] & cvalid[nxt]
                cvalid = cvalid.at[nxt].set(
                    jnp.where(do_weld, ok_w, cvalid[nxt]))
                cvalid = cvalid.at[cu].set(
                    jnp.where(do_weld, False, cvalid[cu]))
                c = c._replace(chain=chain, chain_valid=cvalid)

        m = ms.update_mp_geometry(m, None)
        if cfg.ba_every_kf:
            if use_imu:
                def ba_vi(m, c):
                    return vi_window_ba(m, c, slot, rig)

                def ba_vis(m, c):
                    m2, _ = trk.local_ba_step(m, slot, rig_kind, rig,
                                              window=Wn)
                    return m2, c
                m, c = jax.lax.cond(c.imu_ok, ba_vi, ba_vis, m, c)
            else:
                m, _ = trk.local_ba_step(m, slot, rig_kind, rig,
                                         window=Wn)

        c = c._replace(
            last_kf_slot=slot, last_kf_time=time,
            first_kf_time=jnp.where(c.last_kf_slot < 0, time,
                                    c.first_kf_time),
            ref_kf_inliers=jnp.maximum(n_in, 1),
            R=m.kf_R[slot], p=m.kf_t[slot], v=m.kf_v[slot])
        m, c = imu_init_maybe(m, c, time, rig)
        return m, c

    # ------------------ init branches ------------------
    def rig_init(m, c, bank, time, rig, depth):
        """First-frame metric init from the rig baseline (reference:
        Tracking::MultiInitialization, src/Tracking.cc:2339) and/or
        depth priors (StereoInitialization's depth path,
        src/Tracking.cc:2232)."""
        z3 = jnp.zeros(3)
        m2 = ms.insert_keyframe(
            m, 0, jnp.eye(3), z3, z3, c.bg, c.ba, time,
            bank["xy"], bank["desc"], bank["level"], bank["sigma2"],
            bank["cam"], bank["valid"], jnp.full((CF,), -1, jnp.int32))
        total = jnp.zeros((), jnp.int32)
        if cfg.use_depth:
            m2, n = depth_mod.spawn_from_depth_multi(
                m2, jnp.zeros((), jnp.int32), rig_kind, C, rig, depth,
                pin_params=cfg.depth_pin or None,
                cap_new=cfg.depth_cap, max_spawn_depth=cfg.depth_max)
            total = total + n
        for pair in cfg.stereo_pairs:
            m2, n = mt.stereo_spawn(m2, jnp.zeros((), jnp.int32),
                                    rig_kind, C, rig, pair,
                                    cap_new=cfg.new_mp_cap,
                                    lap1=mt._lap(cfg, pair[0]),
                                    lap2=mt._lap(cfg, pair[1]))
            total = total + n
        m2 = ms.update_mp_geometry(m2, None)
        success = total >= cfg.min_rig_landmarks
        c2 = c._replace(
            R=jnp.eye(3), p=z3,
            mode=jnp.where(success, OK, NEED_REF).astype(jnp.int32),
            last_kf_slot=jnp.where(success, 0, c.last_kf_slot),
            last_kf_time=jnp.where(success, time, c.last_kf_time),
            first_kf_time=jnp.where(success, time, c.first_kf_time),
            ref_kf_inliers=jnp.where(success, total, c.ref_kf_inliers),
            pre_acc=pre_mod.init_preintegrated(bias_of(c)))
        m_out = _tree_where(success, m2, m)
        return m_out, c2

    def mono_need_ref(m, c, bank, time, rig):
        c = c._replace(ref_bank=bank, ref_time=time,
                       mode=jnp.asarray(INIT, jnp.int32),
                       pre_acc=pre_mod.init_preintegrated(bias_of(c)))
        return m, c

    def mono_do_init(m, c, bank, time, idx, matched, rig):
        """Two-view reconstruction on the camera-0 band (reference:
        Tracking::MonocularInitialization, src/Tracking.cc:2411); scale
        stays arbitrary until the fix_scale=False inertial init."""
        b0 = c.ref_bank
        key, sub = jax.random.split(c.key)

        def bearing_z1(b):
            ray = cameras.unproject(rig_kind, rig.params[0],
                                    b["xy"][:F])
            z = jnp.maximum(ray[:, 2], 1e-6)
            return ray[:, :2] / z[:, None]

        safe = jnp.where(matched, idx, 0)
        res = two_view.reconstruct(
            sub, bearing_z1(b0)[safe], bearing_z1(bank), matched,
            focal=rig.params[0, 0], min_inliers=cfg.init_min_inliers)
        good = res.is_good
        med = _masked_median(res.points[:, 2], good)
        scale = 1.0 / jnp.maximum(med, 1e-6)
        pts_c0 = res.points * scale
        R01, t01 = res.R, res.t * scale
        R_w1, t_w1 = R01.T, -R01.T @ t01

        M = m.mp_pos.shape[0]
        order = jnp.cumsum(good.astype(jnp.int32)) - 1
        write = good & (order < M)
        slot_mp = jnp.where(write, order, M)
        obs1 = jnp.full((CF,), -1, jnp.int32).at[jnp.arange(F)].set(
            jnp.where(write, order, -1).astype(jnp.int32))
        obs0 = jnp.full((CF,), -1, jnp.int32).at[
            jnp.where(write & (idx >= 0), idx, CF - 1)].max(
            jnp.where(write & (idx >= 0), order, -1))

        mp_pos = jnp.zeros((M + 1, 3)).at[slot_mp].set(pts_c0)[:M]
        mp_desc = jnp.zeros((M + 1, 256), jnp.int8).at[slot_mp].set(
            bank["desc"][:F])[:M]
        newly = jnp.zeros((M + 1,), bool).at[slot_mp].set(write)[:M]
        n_new = jnp.sum(write.astype(jnp.int32))
        m2 = m._replace(
            mp_pos=jnp.where(newly[:, None], mp_pos, m.mp_pos),
            mp_desc=jnp.where(newly[:, None], mp_desc, m.mp_desc),
            mp_valid=newly, n_mp=n_new)
        z3 = jnp.zeros(3)
        m2 = ms.insert_keyframe(
            m2, 0, jnp.eye(3), z3, z3, c.bg, c.ba, c.ref_time,
            b0["xy"], b0["desc"], b0["level"], b0["sigma2"], b0["cam"],
            b0["valid"], obs0)
        m2 = ms.insert_keyframe(
            m2, 1, R_w1, t_w1, z3, c.bg, c.ba, time,
            bank["xy"], bank["desc"], bank["level"], bank["sigma2"],
            bank["cam"], bank["valid"], obs1)
        m2 = ms.update_mp_geometry(m2, None)
        m2, _ = trk.local_ba_step(m2, jnp.asarray(1), rig_kind, rig,
                                  window=2)
        success = res.success & (n_new >= cfg.init_min_inliers)
        c2 = c._replace(
            R=jnp.where(success, R_w1, c.R),
            p=jnp.where(success, t_w1, c.p),
            mode=jnp.where(success, OK, INIT).astype(jnp.int32),
            last_kf_slot=jnp.where(success, 1, c.last_kf_slot),
            last_kf_time=jnp.where(success, time, c.last_kf_time),
            first_kf_time=jnp.where(success, c.ref_time,
                                    c.first_kf_time),
            ref_kf_inliers=jnp.where(success, n_new, c.ref_kf_inliers),
            key=key,
            ref_bank=_tree_where(success, c.ref_bank, bank),
            ref_time=jnp.where(success, c.ref_time, time))
        if use_imu:
            # KF0->KF1 interval = everything accumulated since the ref
            acc_ok = success & (c.pre_acc.dT > 0)
            c2 = c2._replace(
                chain=pre_mod.chain_set(c2.chain, 1, c.pre_acc),
                chain_valid=c2.chain_valid.at[1].set(acc_ok),
                pre_acc=_tree_where(
                    success, pre_mod.init_preintegrated(bias_of(c)),
                    c.pre_acc))
        m_out = _tree_where(success, m2, m)
        return m_out, c2

    def mono_init(m, c, bank, time, rig):
        b0 = c.ref_bank
        idx, hdist = matcher.match_nn(
            bank["desc"][:F], bank["valid"][:F],
            b0["desc"][:F], b0["valid"][:F],
            max_dist=matcher.TH_LOW, ratio=0.9, mutual=True)
        matched = idx >= 0
        enough = jnp.sum(matched.astype(jnp.int32)) >= cfg.init_min_matches

        def attempt(m, c):
            return mono_do_init(m, c, bank, time, idx, matched, rig)

        def slide(m, c):
            return m, c._replace(
                ref_bank=bank, ref_time=time,
                pre_acc=pre_mod.init_preintegrated(bias_of(c)))

        return jax.lax.cond(enough, attempt, slide, m, c)

    # ------------------ tracking branch ------------------
    def branch_track(m, c, bank, time, pre_f, has_pre, rig, depth):
        key, sub = jax.random.split(c.key)
        c = c._replace(key=key)
        lost = c.mode == LOST

        # prediction: IMU when initialized, else constant velocity;
        # relocalization proposal when LOST (reference: Tracking.cc:1723,
        # 3543)
        use_vi = c.imu_ok & has_pre & use_imu

        def imu_pred(_):
            return pre_mod.predict_state(c.R, c.p, c.v, pre_f, bias_of(c))

        def motion_pred(_):
            return (c.R @ c.vel_R, c.p + c.R @ c.vel_t, c.v)

        R_pred, t_pred, v_pred = jax.lax.cond(use_vi, imu_pred,
                                              motion_pred, None)

        def reloc_pred(_):
            okr, R_r, t_r, n_r = trk.relocalize_step(
                m, band0_feats(bank), sub, rig_kind, rig)
            return (jnp.where(okr, R_r, R_pred),
                    jnp.where(okr, t_r, t_pred))

        R_pred, t_pred = jax.lax.cond(
            lost, reloc_pred, lambda _: (R_pred, t_pred), None)

        min_last = min_last_of(c)
        # post-recovery boost: widened search window for a few frames
        # after a LOST episode (reference: doubled th when recently
        # relocalized, src/Tracking.cc:2020-2060)
        radius = jnp.where(c.boost > 0, cfg.relost_radius,
                           cfg.match_radius)

        def track_vi(_):
            anchor = pose_opt.InertialState(R=c.R, p=c.p, v=c.v,
                                            bg=c.bg, ba=c.ba)
            pred = pose_opt.InertialState(R=R_pred, p=t_pred, v=v_pred,
                                          bg=c.bg, ba=c.ba)
            st, feat_mp, n_in, vis, keep = mt.track_step_multi_vi(
                m, bank, anchor, pred, pre_f, rig_kind, C, rig, W, H,
                radius, min_last, map_cap=cfg.track_map_cap,
                po_rounds=cfg.po_rounds, po_iters=cfg.po_iters)
            return (st.R, st.p, st.v, st.bg, st.ba, feat_mp, n_in, vis,
                    keep)

        def track_vis(_):
            R, t, feat_mp, n_in, vis, keep = mt.track_step_multi(
                m, bank, R_pred, t_pred, rig_kind, C, rig, W, H,
                radius, min_last, map_cap=cfg.track_map_cap,
                po_rounds=cfg.po_rounds, po_iters=cfg.po_iters)
            return (R, t, v_pred, c.bg, c.ba, feat_mp, n_in, vis, keep)

        R1, t1, v1, bg1, ba1, feat_mp1, n1, vis1, keep1 = jax.lax.cond(
            use_vi, track_vi, track_vis, None)

        # wide visual retry from the last confirmed pose
        def wide(_):
            R, t, feat_mp, n_in, vis, keep = mt.track_step_multi(
                m, bank, c.R, c.p, rig_kind, C, rig, W, H,
                cfg.relost_radius, min_last, map_cap=cfg.track_map_cap,
                po_rounds=cfg.po_rounds, po_iters=cfg.po_iters)
            return (R, t, v_pred, c.bg, c.ba, feat_mp, n_in, vis, keep)

        retry = n1 < cfg.min_inliers_track
        R2, t2, v2, bg2, ba2, feat_mp, n_in, vis, keepm = jax.lax.cond(
            retry, wide,
            lambda _: (R1, t1, v1, bg1, ba1, feat_mp1, n1, vis1, keep1),
            None)
        # wide retry is visual-only: the VI state update no longer applies
        vi_upd = use_vi & ~retry

        ok = n_in >= cfg.min_inliers_track
        dt = jnp.maximum(time - c.last_time, 1e-3)
        v_fd = (t2 - c.p) / dt
        # RECENTLY_LOST: coast on the IMU prediction so the pose stays
        # usable for relocalization (reference: Tracking.cc:1929-1940)
        coast = ~ok & c.imu_ok & has_pre
        R_new = jnp.where(ok, R2, jnp.where(coast, R_pred, c.R))
        t_new = jnp.where(ok, t2, jnp.where(coast, t_pred, c.p))
        v_new = jnp.where(ok, jnp.where(vi_upd, v2, v_fd),
                          jnp.where(coast, v_pred, c.v))
        recovered = ok & (lost | retry)
        c = c._replace(
            R=R_new, p=t_new, v=v_new,
            bg=jnp.where(ok & vi_upd, bg2, c.bg),
            ba=jnp.where(ok & vi_upd, ba2, c.ba),
            vel_R=jnp.where(ok, c.R.T @ R2, c.vel_R),
            vel_t=jnp.where(ok, c.R.T @ (t2 - c.p), c.vel_t),
            mode=jnp.where(ok, OK, LOST).astype(jnp.int32),
            lost_frames=jnp.where(ok, 0, c.lost_frames + 1),
            boost=jnp.where(recovered, 5,
                            jnp.maximum(c.boost - ok.astype(jnp.int32),
                                        0)))

        m = m._replace(
            mp_visible=m.mp_visible + (vis & ok).astype(jnp.int32),
            mp_found=m.mp_found + (keepm & ok).astype(jnp.int32))

        need_kf = (ok
                   & ((n_in < cfg.kf_min_inlier_frac
                       * jnp.maximum(c.ref_kf_inliers, 1))
                      | (n_in < cfg.kf_min_inliers_abs)
                      | (use_imu
                         & (time - c.last_kf_time
                            > cfg.kf_max_interval_s))))

        def do_kf(m, c):
            return kf_insert(m, c, bank, time, feat_mp, n_in, rig,
                             depth)

        return jax.lax.cond(need_kf, do_kf, lambda m, c: (m, c), m, c)

    # ------------------ the step ------------------
    use_rig_init = bool(cfg.stereo_pairs) or cfg.use_depth

    @jax.jit
    def step(m: ms.MapState, c: VIStreamCarry, images, time,
             imu_w, imu_a, imu_dt, depth, rig, noise, dist):
        # accept uint8 frames: 4x less host->device transfer; the cast is
        # free on device
        images = images.astype(jnp.float32)
        bank = extract_bank(images, rig, dist)
        # frame-interval preintegration (padded; dt=0 rows are no-ops)
        has_pre = jnp.asarray(False)
        pre_f = pre_mod.init_preintegrated(bias_of(c))
        if use_imu:
            pre_f = pre_mod.integrate(imu_w, imu_a, imu_dt, bias_of(c),
                                      noise)
            has_pre = (pre_f.dT > 0) & c.has_last
            # accumulate into the since-last-KF interval
            acc2 = pre_mod.compose(c.pre_acc,
                                   pre_mod.rebias(pre_f, c.pre_acc.b))
            c = c._replace(pre_acc=_tree_where(has_pre, acc2, c.pre_acc))

        def br_init(m, c):
            if use_rig_init:
                return rig_init(m, c, bank, time, rig, depth)
            return mono_need_ref(m, c, bank, time, rig)

        def br_mono_init(m, c):
            # unreachable for rig configs (rig init never enters INIT);
            # alias it to br_init there to avoid compiling dead code
            if use_rig_init:
                return br_init(m, c)
            return mono_init(m, c, bank, time, rig)

        def br_track(m, c):
            return branch_track(m, c, bank, time, pre_f, has_pre, rig,
                                depth)

        branch = jnp.minimum(c.mode, 2)
        m, c = jax.lax.switch(branch, [br_init, br_mono_init, br_track],
                              m, c)
        c = _record(m, c, time, c.mode == OK)
        c = c._replace(last_time=time, has_last=jnp.asarray(True))
        return m, c

    _STEP_CACHE[key_] = step
    return step


_COMBINED_CACHE: dict = {}
_CHUNK_CACHE: dict = {}


def _make_chunked_step(rig: RigParams, cfg: VIStreamConfig, noise,
                       dist, lc_key: tuple | None, chunk: int):
    """lax.scan over `chunk` frames in ONE dispatch (tracking [+ device
    LC] per frame, identical math to the per-frame step; a [chunk] valid
    mask makes padded tail frames no-ops so partial flushes reuse the
    same compiled program)."""
    from . import streaming_lc

    key_ = (cfg, rig.kind, dist is not None, lc_key, chunk)
    cached = _CHUNK_CACHE.get(key_)
    if cached is None:
        inner = _make_step_inner(cfg, rig.kind, dist is not None)
        lc_inner = (streaming_lc.make_lc_step(
            cfg, rig.kind, cfg.n_cams, inertial=cfg.use_imu,
            img_w=float(cfg.img_w), img_h=float(cfg.img_h),
            **dict(lc_key)) if lc_key is not None else None)

        @jax.jit
        def chunked(m, c, lcc, images, time, imu_w, imu_a, imu_dt,
                    valid, depth, rig, noise, dist):
            def body(carry, xs):
                m, c, lcc = carry
                img, t, w, a, dts, v, dep = xs

                def run(args):
                    m, c, lcc = args
                    m, c = inner(m, c, img, t, w, a, dts, dep, rig,
                                 noise, dist)
                    if lc_inner is not None:
                        m, c, lcc = lc_inner(m, c, lcc, rig)
                    return m, c, lcc

                carry = jax.lax.cond(v, run, lambda x: x, (m, c, lcc))
                return carry, None

            (m, c, lcc), _ = jax.lax.scan(
                body, (m, c, lcc),
                (images, time, imu_w, imu_a, imu_dt, valid, depth))
            return m, c, lcc

        _CHUNK_CACHE[key_] = chunked
        cached = chunked
    d0 = dist if dist is not None else 0.0
    return lambda m, c, lcc, imgs, t, w, a, dts, v, depth: cached(
        m, c, lcc, imgs, t, w, a, dts, v, depth, rig, noise, d0)


def _make_combined_step(rig: RigParams, cfg: VIStreamConfig, noise,
                        dist, lc_key: tuple,
                        merge_key: tuple | None = None):
    """Tracking step + device loop closing (+ optional device cross-map
    merge against a resident secondary slab) fused into ONE jitted
    program per frame (see StreamingVITracker.__init__). Cached per
    (cfg, rig.kind, dist?, lc params, merge params) so fresh trackers
    share the compile."""
    from . import streaming_lc

    key_ = (cfg, rig.kind, dist is not None, lc_key, merge_key)
    cached = _COMBINED_CACHE.get(key_)
    if cached is None:
        inner = _make_step_inner(cfg, rig.kind, dist is not None)
        lc_inner = streaming_lc.make_lc_step(
            cfg, rig.kind, cfg.n_cams, inertial=cfg.use_imu,
            img_w=float(cfg.img_w), img_h=float(cfg.img_h),
            **dict(lc_key))
        merge_inner = (streaming_lc.make_merge_step(
            cfg, rig.kind, cfg.n_cams, inertial=cfg.use_imu,
            img_w=float(cfg.img_w), img_h=float(cfg.img_h),
            **dict(merge_key)) if merge_key is not None else None)

        if merge_inner is None:
            @jax.jit
            def combined(m, c, lcc, images, time, imu_w, imu_a, imu_dt,
                         depth, rig, noise, dist):
                m, c = inner(m, c, images, time, imu_w, imu_a, imu_dt,
                             depth, rig, noise, dist)
                m, c, lcc = lc_inner(m, c, lcc, rig)
                return m, c, lcc
        else:
            @jax.jit
            def combined(m, c, lcc, m2, images, time, imu_w, imu_a,
                         imu_dt, depth, rig, noise, dist):
                m, c = inner(m, c, images, time, imu_w, imu_a, imu_dt,
                             depth, rig, noise, dist)
                m, c, lcc = merge_inner(m, c, lcc, m2, rig)
                m, c, lcc = lc_inner(m, c, lcc, rig)
                return m, c, lcc

        _COMBINED_CACHE[key_] = combined
        cached = combined
    return _bind(cached, rig, noise, dist if dist is not None else 0.0)


class StreamingVITracker:
    """Host wrapper: enqueue-only per frame, fetch-once at the end.

    Usage:
        tr = StreamingVITracker(rig, cfg, noise)
        for imgs, t, samples in stream:
            tr.push(imgs, t, samples)        # no device->host reads
        times, R, t = tr.get_trajectory()    # single fetch
    """

    def __init__(self, rig: RigParams, cfg: VIStreamConfig,
                 noise: pre_mod.ImuNoise | None = None, seed: int = 0,
                 dist=None, loop_closer=None, device_lc=False,
                 secondary_map=None, merge_kw=None):
        self.cfg = cfg
        self.noise = noise or pre_mod.ImuNoise.from_sigmas(
            1.7e-4, 2e-3, 1.9e-5, 3e-3, cfg.imu_freq)
        orb_cfg = cfg.orb or extractor.OrbConfig()
        self.map = ms.allocate(cfg.max_kf, cfg.n_cams * orb_cfg.n_features,
                               cfg.max_mp)
        self.carry = init_carry(cfg, seed)
        self.rig = jax.device_put(rig)
        self._step = make_step(self.rig, cfg, self.noise, dist)
        self._t_prev: float | None = None
        self.loop_closer = loop_closer
        self._last_lc_slot = -1
        # device-side loop closing: the whole detection->correction chain
        # as one jitted program per frame (pipeline/streaming_lc.py) —
        # zero host syncs, unlike the host-policy `loop_closer` path.
        self._lc_step = None
        self.lc_carry = None
        self.map2 = None
        lc_key = None
        if device_lc:
            from . import streaming_lc
            lc_kw = device_lc if isinstance(device_lc, dict) else {}
            lc_key = tuple(sorted(lc_kw.items()))
            # device cross-map merge: a previous session's map slab kept
            # RESIDENT on device; the fused per-frame program detects and
            # welds into it with zero host reads (streaming_lc.
            # make_merge_step; reference: MergeLocal2,
            # src/LoopClosing.cc:1956)
            merge_key = None
            if secondary_map is not None:
                merge_key = tuple(sorted((merge_kw or {}).items()))
                self.map2 = jax.device_put(secondary_map)
            # the tracking step and the LC step are fused into one jitted
            # program: one dispatch per frame, and XLA schedules both
            # halves together
            self._step = _make_combined_step(
                self.rig, cfg, self.noise, dist, lc_key, merge_key)
            self._lc_step = True
            self.lc_carry = streaming_lc.init_lc_carry()
        elif secondary_map is not None:
            raise ValueError("secondary_map requires device_lc")
        # frame-chunked dispatch: scan `chunk` frames per device program
        self._chunk = max(1, int(cfg.frames_per_dispatch))
        self._buf: list = []
        if self._chunk > 1 and self.map2 is not None:
            raise ValueError("secondary_map requires "
                             "frames_per_dispatch=1")
        if self._chunk > 1:
            self._chunk_step = _make_chunked_step(
                self.rig, cfg, self.noise, dist, lc_key, self._chunk)

    def _imu_arrays(self, samples, t_now: float):
        """Pad host IMU samples into fixed [S,3]/[S,3]/[S] buffers covering
        (t_prev, t_now]; pure host work, no device reads."""
        S = self.cfg.imu_per_frame
        w = np.zeros((S, 3), np.float32)
        a = np.zeros((S, 3), np.float32)
        dt = np.zeros((S,), np.float32)
        if samples and self._t_prev is not None:
            prev = self._t_prev
            j = 0
            for (ws, as_, ts) in samples:
                if ts <= prev or j >= S:
                    continue
                step_dt = min(ts, t_now) - prev
                if step_dt <= 0:
                    continue
                w[j], a[j], dt[j] = ws, as_, step_dt
                prev = min(ts, t_now)
                j += 1
            if j and prev < t_now and j < S:
                w[j], a[j] = w[j - 1], a[j - 1]
                dt[j] = t_now - prev
        return w, a, dt

    def _depth_arg(self, depth):
        if not self.cfg.use_depth:
            return np.zeros((), np.float32)
        if depth is None:
            raise ValueError("cfg.use_depth=True but push() got no "
                             "depth stack")
        return np.asarray(depth, np.float32)

    def _step_args(self, images, time: float, imu_samples, depth):
        """Arguments of the per-frame program for one frame."""
        w, a, dt = self._imu_arrays(list(imu_samples), time)
        depth = self._depth_arg(depth)
        state = (self.map, self.carry)
        if self._lc_step is not None:
            state += (self.lc_carry,)
            if self.map2 is not None:
                state += (self.map2,)
        return state + (np.asarray(images), np.float32(time), w, a, dt,
                        depth)

    def lower_step(self, images, time: float, imu_samples=(), depth=None):
        """AOT view (`jax.stages.Lowered`) of the per-frame program for one
        frame: `.compile().memory_analysis()` gives its device memory."""
        return self._step.lower(
            *self._step_args(images, time, imu_samples, depth))

    def push(self, images, time: float, imu_samples=(), depth=None):
        """images: [C,H,W] float32; imu_samples: iterable of (w, a, t);
        depth: [C,H,W] float32 z-depth maps (cfg.use_depth rigs only)."""
        if self._chunk > 1:
            w, a, dt = self._imu_arrays(list(imu_samples), time)
            self._buf.append((np.asarray(images), time, w, a, dt,
                              self._depth_arg(depth)))
            self._t_prev = time
            self._snap = None
            if len(self._buf) == self._chunk:
                self._flush()
            return
        out = self._step(*self._step_args(images, time, imu_samples, depth))
        if self._lc_step is not None:
            self.map, self.carry, self.lc_carry = out
        else:
            self.map, self.carry = out
        self._t_prev = time
        self._snap = None

    def _flush(self):
        """Dispatch the buffered frame chunk (padded + masked if partial)
        as one scanned device program."""
        if not self._buf:
            return
        N = self._chunk
        n = len(self._buf)
        imgs0, _, w0, a0, d0, _ = self._buf[0]
        imgs = np.zeros((N,) + imgs0.shape, imgs0.dtype)
        times = np.zeros((N,), np.float32)
        ws = np.zeros((N,) + w0.shape, np.float32)
        as_ = np.zeros((N,) + a0.shape, np.float32)
        dts = np.zeros((N,) + d0.shape, np.float32)
        valid = np.zeros((N,), bool)
        deps = (np.zeros((N,) + imgs0.shape, np.float32)
                if self.cfg.use_depth else np.zeros((N,), np.float32))
        for i, (im, t, w, a, d, dep) in enumerate(self._buf):
            imgs[i], times[i], ws[i], as_[i], dts[i] = im, t, w, a, d
            valid[i] = True
            if self.cfg.use_depth:
                deps[i] = dep
        self._buf = []
        lcc = (self.lc_carry if self.lc_carry is not None
               else jnp.zeros(()))
        self.map, self.carry, lcc = self._chunk_step(
            self.map, self.carry, lcc, imgs, times, ws, as_, dts, valid,
            deps)
        if self.lc_carry is not None:
            self.lc_carry = lcc

    def block(self):
        self._flush()
        jax.block_until_ready(self.carry.p)

    def maybe_close_loop(self) -> bool:
        """Run loop detection/correction on the newest keyframe.

        Host-policy and synchronizing: each call waits for the device to
        drain, so call this at LOW cadence (e.g. once a second) from the
        application loop — the reference's LoopClosing thread at its
        natural keyframe rate, amortized. On correction the
        device carry pose is re-expressed through its reference keyframe so
        tracking continues seamlessly in the corrected world.
        """
        if self.loop_closer is None:
            return False
        self._flush()
        slot = int(self.snapshot()["n_kf"]) - 1
        if slot < 1 or slot == self._last_lc_slot:
            return False
        self._last_lc_slot = slot
        self._snap = None
        old_R, old_t = self.map.kf_R, self.map.kf_t
        m2, closed = self.loop_closer.on_keyframe(
            self.map, slot, chain=self.carry.chain,
            chain_valid=self.carry.chain_valid)
        if not closed:
            self.map = m2
            return False
        c = self.carry
        ref = jnp.maximum(c.last_kf_slot, 0)
        R_rel = jnp.swapaxes(old_R[ref], -1, -2) @ c.R
        t_rel = jnp.einsum("ji,j->i", old_R[ref], c.p - old_t[ref])
        dR = m2.kf_R[ref] @ jnp.swapaxes(old_R[ref], -1, -2)
        self.carry = c._replace(
            R=m2.kf_R[ref] @ R_rel,
            p=m2.kf_t[ref] + m2.kf_R[ref] @ t_rel,
            v=dR @ c.v)
        self.map = m2
        return True

    def run_global_ba(self, mesh=None, stages=(4, 6), cg_iters=16):
        """Whole-map FullInertialBA over the streamed map, optionally
        SHARDED over a device mesh (reference: the background GBA thread,
        src/LoopClosing.cc:2351; the amortized in-stream GBA covers the
        same semantics at keyframe cadence — this entry is the explicit,
        scale-out form for event use: post-merge, shutdown refinement,
        multi-device offload).

        `mesh`: None = single-device jitted program (zero host reads);
        a Mesh / device list / int = landmark-sharded distributed solve
        through the product path (tracking.distributed_global_ba_step).
        Synchronizing: call at event cadence, not per frame.
        Returns chi2 (float when distributed, device scalar otherwise).
        """
        from . import tracking as trk

        self._flush()
        c = self.carry
        pre_b = jax.tree.map(lambda x: x[1:], c.chain)
        old_R, old_t = self.map.kf_R, self.map.kf_t
        if mesh is not None:
            from ..parallel import dist_ba
            if isinstance(mesh, int):
                mesh = dist_ba.make_mesh(jax.devices()[:mesh])
            elif isinstance(mesh, (list, tuple)):
                mesh = dist_ba.make_mesh(list(mesh))
            m2, chi = trk.distributed_global_ba_step(
                self.map, self.rig.kind, self.rig, mesh,
                pre_b=pre_b, edge_valid=c.chain_valid[1:],
                stages=stages, cg_iters=cg_iters,
                obs_cap=self.cfg.obs_cap)
        else:
            m2, chi = trk.global_inertial_ba_step(
                self.map, pre_b, c.chain_valid[1:], self.rig.kind,
                self.rig, stages=stages, cg_iters=cg_iters,
                obs_cap=self.cfg.obs_cap)
        # re-express the live pose through its reference keyframe in the
        # refined world (same protocol as maybe_close_loop)
        ref = jnp.maximum(c.last_kf_slot, 0)
        R_rel = jnp.swapaxes(old_R[ref], -1, -2) @ c.R
        t_rel = jnp.einsum("ji,j->i", old_R[ref], c.p - old_t[ref])
        dR = m2.kf_R[ref] @ jnp.swapaxes(old_R[ref], -1, -2)
        self.carry = c._replace(
            R=m2.kf_R[ref] @ R_rel,
            p=m2.kf_t[ref] + m2.kf_R[ref] @ t_rel,
            v=dR @ c.v)
        self.map = m2
        self._snap = None
        return chi

    def snapshot(self) -> dict:
        """Fetch trajectory + counters in one `jax.device_get`. Caches the
        result until the next push()."""
        if getattr(self, "_snap", None) is not None:
            return self._snap
        self._flush()
        tr = self.carry.traj
        fields = dict(
            time=tr.time, ref=tr.ref, R_rel=tr.R_rel, t_rel=tr.t_rel,
            ok=tr.ok, idx=tr.idx,
            kf_R=self.map.kf_R, kf_t=self.map.kf_t,
            n_kf=self.map.n_kf, n_mp=self.map.n_mp,
            # live bound-observation count: compare against cfg.obs_cap
            # to see whether whole-map BA tables are truncating
            n_obs=jnp.sum(((self.map.kf_obs >= 0)
                           & self.map.kf_feat_valid
                           & self.map.kf_valid[:, None])
                          .astype(jnp.int32)),
            imu_ok=self.carry.imu_ok.astype(jnp.int32),
            viba_stage=self.carry.viba_stage)
        if self.lc_carry is not None:
            fields["n_loops"] = self.lc_carry.n_loops
            fields["gba_left"] = self.lc_carry.gba_left
            fields["lc_max_tilt"] = self.lc_carry.max_tilt
            fields["n_merges"] = self.lc_carry.n_merges
            fields["merge_kf_off"] = self.lc_carry.kf_off
            fields["lc_dbg"] = self.lc_carry.dbg
        snap = jax.device_get(fields)
        self._snap = snap
        return snap

    def get_trajectory(self):
        s = self.snapshot()
        n = int(min(s["idx"], s["time"].shape[0]))
        kf_R, kf_t = s["kf_R"], s["kf_t"]
        times, Rs, ts = [], [], []
        for i in range(n):
            ref = s["ref"][i]
            times.append(s["time"][i])
            Rs.append(kf_R[ref] @ s["R_rel"][i])
            ts.append(kf_t[ref] + kf_R[ref] @ s["t_rel"][i])
        return (np.asarray(times),
                np.stack(Rs) if Rs else np.zeros((0, 3, 3)),
                np.stack(ts) if ts else np.zeros((0, 3)))

    @property
    def n_kf(self):
        return int(self.snapshot()["n_kf"])

    @property
    def imu_initialized(self):
        return bool(self.snapshot()["imu_ok"])
