"""Streaming tracker: the WHOLE per-frame state machine as one device program.

Motivation: the host-policy tracker (`tracking.Tracker`) reads scalars
back every frame (`int(n_in)`), so each frame waits for the device to
drain before the next is enqueued. Here initialization, tracking, lost
handling/relocalization, the keyframe decision and the whole mapper chain
(spawn / bind / fuse / cull / window-BA) run INSIDE one jit-compiled step
under `lax.cond`/`lax.switch`, with all state device-resident:

    step : (MapState, StreamCarry, image, time) -> (MapState, StreamCarry)

The host loop just enqueues `step` once per frame — zero device->host
traffic until `finalize()` fetches the trajectory and map exactly once.

(reference parity: this replaces the Tracking-thread state machine
src/Tracking.cc:1781-2230 + the LocalMapping consumer loop
src/LocalMapping.cc:59-283 with a single-dispatch pipeline; the
reference's cross-thread map handoff disappears because the map update is
part of the same program.)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..frontend import extractor, matcher
from ..geometry import cameras
from ..optim.reprojection import RigParams
from ..slam_map import map_state as ms
from ..solvers import two_view
from . import tracking as trk

# carry.mode values
NEED_REF = 0      # no init reference yet
INIT = 1          # have a reference frame, trying two-view init
OK = 2
LOST = 3


class TrajRing(NamedTuple):
    """Device-resident relative-pose trajectory (reference:
    Tracking::mlRelativeFramePoses, replayed at save time against final
    keyframe poses — src/System.cc:717-1090)."""
    time: jnp.ndarray    # [C] f32
    ref: jnp.ndarray     # [C] i32 keyframe slot the pose is relative to
    R_rel: jnp.ndarray   # [C,3,3]
    t_rel: jnp.ndarray   # [C,3]
    ok: jnp.ndarray      # [C] bool — frame was tracked
    idx: jnp.ndarray     # [] i32 next write position


class StreamCarry(NamedTuple):
    R: jnp.ndarray           # [3,3] current body pose (world-from-body)
    t: jnp.ndarray           # [3]
    vel_R: jnp.ndarray       # [3,3] motion model T_{k-1}^-1 T_k
    vel_t: jnp.ndarray       # [3]
    mode: jnp.ndarray        # [] i32
    last_kf_slot: jnp.ndarray  # [] i32
    ref_kf_inliers: jnp.ndarray  # [] i32
    lost_frames: jnp.ndarray   # [] i32
    key: jnp.ndarray         # PRNG key
    ref_feats: extractor.Features   # init reference frame features
    ref_time: jnp.ndarray    # [] f32
    traj: TrajRing


def _empty_feats(F: int) -> extractor.Features:
    return extractor.Features(
        xy=jnp.zeros((F, 2)), response=jnp.zeros((F,)),
        angle=jnp.zeros((F,)), level=jnp.zeros((F,), jnp.int32),
        sigma2=jnp.ones((F,)), desc=jnp.zeros((F, 256), jnp.int8),
        valid=jnp.zeros((F,), bool))


def init_carry(F: int, traj_cap: int, seed: int = 0) -> StreamCarry:
    return StreamCarry(
        R=jnp.eye(3), t=jnp.zeros(3), vel_R=jnp.eye(3), vel_t=jnp.zeros(3),
        mode=jnp.zeros((), jnp.int32),
        last_kf_slot=jnp.full((), -1, jnp.int32),
        ref_kf_inliers=jnp.zeros((), jnp.int32),
        lost_frames=jnp.zeros((), jnp.int32),
        key=jax.random.PRNGKey(seed),
        ref_feats=_empty_feats(F),
        ref_time=jnp.zeros(()),
        traj=TrajRing(
            time=jnp.zeros((traj_cap,)),
            ref=jnp.zeros((traj_cap,), jnp.int32),
            R_rel=jnp.tile(jnp.eye(3), (traj_cap, 1, 1)),
            t_rel=jnp.zeros((traj_cap, 3)),
            ok=jnp.zeros((traj_cap,), bool),
            idx=jnp.zeros((), jnp.int32)),
    )


def _record(m: ms.MapState, c: StreamCarry, time, ok) -> StreamCarry:
    ref = jnp.maximum(c.last_kf_slot, 0)
    R_ref = m.kf_R[ref]
    t_ref = m.kf_t[ref]
    R_rel = R_ref.T @ c.R
    t_rel = R_ref.T @ (c.t - t_ref)
    tr = c.traj
    i = jnp.minimum(tr.idx, tr.time.shape[0] - 1)
    tr = tr._replace(
        time=tr.time.at[i].set(time), ref=tr.ref.at[i].set(ref),
        R_rel=tr.R_rel.at[i].set(R_rel), t_rel=tr.t_rel.at[i].set(t_rel),
        ok=tr.ok.at[i].set(ok), idx=tr.idx + 1)
    return c._replace(traj=tr)


def _masked_median(x, mask):
    """Median of x[mask] (sort-based, static shape); 1.0 if mask empty."""
    n = jnp.sum(mask.astype(jnp.int32))
    xs = jnp.sort(jnp.where(mask, x, jnp.inf))
    med = xs[jnp.maximum((n - 1) // 2, 0)]
    return jnp.where(n > 0, med, 1.0)


@dataclass(frozen=True)
class StreamConfig:
    img_w: int = 640
    img_h: int = 480
    orb: extractor.OrbConfig = None  # set in __post_init__ by caller
    max_kf: int = 64
    max_mp: int = 8192
    traj_cap: int = 4096
    match_radius: float = 15.0
    relost_radius: float = 30.0
    min_inliers_track: int = 20
    kf_min_inlier_frac: float = 0.75
    kf_min_inliers_abs: int = 60
    new_mp_cap: int = 256
    ba_window: int = 8
    init_min_matches: int = 80
    init_min_inliers: int = 50
    # run the window BA on every KF insert (reference does; disabling
    # trades accuracy for throughput)
    ba_every_kf: bool = True


_STEP_CACHE = {}


def make_step(rig: RigParams, cfg: StreamConfig):
    """Build (or reuse) the jitted streaming step for this rig + config.

    The cached program takes the rig as a traced argument (RigParams is a
    pytree with static `kind`), so a fresh StreamingTracker — even with
    different intrinsics — pays no retrace/recompile.
    """
    inner = _make_step_inner(cfg)
    return lambda m, c, img, time: inner(m, c, img, time, rig)


def _make_step_inner(cfg: StreamConfig):
    cached = _STEP_CACHE.get(cfg)
    if cached is not None:
        return cached
    orb_cfg = cfg.orb or extractor.OrbConfig()
    F = orb_cfg.n_features
    W, H = float(cfg.img_w), float(cfg.img_h)

    def bearing_z1(rig, feats):
        ray = cameras.unproject(rig.kind, rig.params[0], feats.xy)
        z = jnp.maximum(ray[:, 2], 1e-6)
        return ray[:, :2] / z[:, None]

    # ---------------- init branches ----------------
    def branch_need_ref(m, c, feats, time, rig):
        c = c._replace(ref_feats=feats, ref_time=time,
                       mode=jnp.asarray(INIT, jnp.int32))
        return m, c

    def _do_init(m, c, feats, time, idx, matched, rig):
        """Two-view reconstruction + map bootstrap, all traced.
        (reference: Tracking::MonocularInitialization + map creation,
        src/Tracking.cc:2411-2619.)"""
        f0 = c.ref_feats
        key, sub = jax.random.split(c.key)
        x1 = bearing_z1(rig, f0)
        x2 = bearing_z1(rig, feats)
        safe = jnp.where(matched, idx, 0)
        res = two_view.reconstruct(
            sub, x1[safe], x2, matched,
            focal=rig.params[0, 0], min_inliers=cfg.init_min_inliers)

        good = res.is_good
        depths = res.points[:, 2]
        med = _masked_median(depths, good)
        scale = 1.0 / jnp.maximum(med, 1e-6)
        pts_c0 = res.points * scale
        R01 = res.R
        t01 = res.t * scale
        R_w1 = R01.T
        t_w1 = -R01.T @ t01

        M = m.mp_pos.shape[0]
        order = jnp.cumsum(good.astype(jnp.int32)) - 1
        write = good & (order < M)
        slot_mp = jnp.where(write, order, M)
        obs1 = jnp.where(write, order, -1).astype(jnp.int32)
        # frame-1 feature i matched ref feature idx[i]
        obs0 = jnp.full((F,), -1, jnp.int32).at[
            jnp.where(write & (idx >= 0), idx, F - 1)].max(
            jnp.where(write & (idx >= 0), order, -1))

        mp_pos = jnp.zeros((M + 1, 3)).at[slot_mp].set(pts_c0)[:M]
        mp_desc = jnp.zeros((M + 1, 256), jnp.int8).at[slot_mp].set(
            feats.desc)[:M]
        newly = jnp.zeros((M + 1,), bool).at[slot_mp].set(write)[:M]
        n_new = jnp.sum(write.astype(jnp.int32))
        m2 = m._replace(
            mp_pos=jnp.where(newly[:, None], mp_pos, m.mp_pos),
            mp_desc=jnp.where(newly[:, None], mp_desc, m.mp_desc),
            mp_valid=newly, n_mp=n_new)
        z3 = jnp.zeros(3)
        zc = jnp.zeros((F,), jnp.int32)
        m2 = ms.insert_keyframe(
            m2, 0, jnp.eye(3), z3, z3, z3, z3, c.ref_time,
            f0.xy, f0.desc, f0.level, f0.sigma2, zc, f0.valid, obs0)
        m2 = ms.insert_keyframe(
            m2, 1, R_w1, t_w1, z3, z3, z3, time,
            feats.xy, feats.desc, feats.level, feats.sigma2, zc,
            feats.valid, obs1)
        m2 = ms.update_mp_geometry(m2, None)
        m2, _ = trk.local_ba_step(m2, jnp.asarray(1), rig.kind, rig,
                                  window=2)

        success = res.success & (n_new >= cfg.init_min_inliers)
        c2 = c._replace(
            R=jnp.where(success, R_w1, c.R),
            t=jnp.where(success, t_w1, c.t),
            mode=jnp.where(success, OK, INIT).astype(jnp.int32),
            last_kf_slot=jnp.where(success, 1, c.last_kf_slot),
            ref_kf_inliers=jnp.where(success, n_new, c.ref_kf_inliers),
            key=key,
            # failed attempt: slide the reference forward
            ref_feats=jax.tree.map(
                lambda old, new: jnp.where(success, old, new),
                c.ref_feats, feats),
            ref_time=jnp.where(success, c.ref_time, time))
        m_out = jax.tree.map(lambda a, b: jnp.where(success, a, b), m2, m)
        return m_out, c2

    def branch_init(m, c, feats, time, rig):
        f0 = c.ref_feats
        idx, hdist = matcher.match_nn(
            feats.desc, feats.valid, f0.desc, f0.valid,
            max_dist=matcher.TH_LOW, ratio=0.9, mutual=True)
        matched = idx >= 0
        n_matches = jnp.sum(matched.astype(jnp.int32))
        enough = n_matches >= cfg.init_min_matches

        def attempt(m, c):
            return _do_init(m, c, feats, time, idx, matched, rig)

        def slide(m, c):
            return m, c._replace(ref_feats=feats, ref_time=time)

        return jax.lax.cond(enough, attempt, slide, m, c)

    # ---------------- keyframe pipeline ----------------
    def kf_insert(m, c, feats, time, feat_mp, n_in, rig):
        slot = m.n_kf
        z3 = jnp.zeros(3)
        m = ms.insert_keyframe(
            m, slot, c.R, c.t, z3, z3, z3, time,
            feats.xy, feats.desc, feats.level, feats.sigma2,
            jnp.zeros((F,), jnp.int32), feats.valid, feat_mp)
        refs = slot - 1 - jnp.arange(4, dtype=jnp.int32)
        m, _ = trk.spawn_landmarks(m, slot, refs, rig.kind, rig,
                                   cfg.new_mp_cap)
        m = trk.bind_landmarks(m, slot, rig.kind, rig, W, H)
        m = trk.fuse_new_landmarks(m, slot, cap=cfg.new_mp_cap)
        m = trk.cull_landmarks(m, slot)
        m, _ = trk.cull_keyframes(m, slot)
        if cfg.ba_every_kf:
            m, _ = trk.local_ba_step(m, slot, rig.kind, rig,
                                     window=cfg.ba_window)
        c = c._replace(last_kf_slot=slot,
                       ref_kf_inliers=jnp.maximum(n_in, 1),
                       R=m.kf_R[slot], t=m.kf_t[slot])
        return m, c

    # ---------------- tracking branch ----------------
    def branch_track(m, c, feats, time, rig):
        key, sub = jax.random.split(c.key)
        c = c._replace(key=key)
        lost = c.mode == LOST

        # pose prediction: motion model, or relocalization when LOST
        # (reference: Tracking.cc mVelocity / Relocalization 3543)
        def reloc_pred(_):
            okr, R_r, t_r, n_r = trk.relocalize_step(
                m, feats, sub, rig.kind, rig)
            return (jnp.where(okr, R_r, c.R), jnp.where(okr, t_r, c.t))

        def motion_pred(_):
            return (c.R @ c.vel_R, c.t + c.R @ c.vel_t)

        R_pred, t_pred = jax.lax.cond(lost, reloc_pred, motion_pred, None)

        R1, t1, feat_mp1, n1, vis1, keep1 = trk.track_step(
            m, feats, R_pred, t_pred, rig.kind, rig, W, H,
            cfg.match_radius)

        # wide retry from the last confirmed pose (RECENTLY_LOST coast)
        def wide(_):
            return trk.track_step(m, feats, c.R, c.t, rig.kind, rig,
                                  W, H, cfg.relost_radius)

        def keep(_):
            return R1, t1, feat_mp1, n1, vis1, keep1

        retry = n1 < cfg.min_inliers_track
        R2, t2, feat_mp, n_in, vis, keepm = jax.lax.cond(
            retry, wide, keep, None)

        ok = n_in >= cfg.min_inliers_track
        # motion model update only on success
        vel_R = jnp.where(ok, c.R.T @ R2, c.vel_R)
        vel_t = jnp.where(ok, c.R.T @ (t2 - c.t), c.vel_t)
        R_new = jnp.where(ok, R2, c.R)
        t_new = jnp.where(ok, t2, c.t)
        c = c._replace(
            R=R_new, t=t_new, vel_R=vel_R, vel_t=vel_t,
            mode=jnp.where(ok, OK, LOST).astype(jnp.int32),
            lost_frames=jnp.where(ok, 0, c.lost_frames + 1))

        # landmark statistics
        m = m._replace(
            mp_visible=m.mp_visible + (vis & ok).astype(jnp.int32),
            mp_found=m.mp_found + (keepm & ok).astype(jnp.int32))

        need_kf = (ok
                   & ((n_in < cfg.kf_min_inlier_frac
                       * jnp.maximum(c.ref_kf_inliers, 1))
                      | (n_in < cfg.kf_min_inliers_abs))
                   & (m.n_kf < cfg.max_kf))

        def do_kf(m, c):
            return kf_insert(m, c, feats, time, feat_mp, n_in, rig)

        def no_kf(m, c):
            return m, c

        return jax.lax.cond(need_kf, do_kf, no_kf, m, c)

    # ---------------- the step ----------------
    @jax.jit
    def step(m: ms.MapState, c: StreamCarry, img, time, rig):
        # accept uint8 frames: 4x less host->device transfer; the cast is
        # free on device
        img = img.astype(jnp.float32)
        feats = extractor.extract(img, orb_cfg)
        branch = jnp.minimum(c.mode, 2)
        m, c = jax.lax.switch(
            branch,
            [branch_need_ref, branch_init, branch_track],
            m, c, feats, time, rig)
        c = _record(m, c, time, c.mode == OK)
        return m, c

    _STEP_CACHE[cfg] = step
    return step


class StreamingTracker:
    """Host wrapper: enqueue-only per-frame, fetch-once at the end.

    Usage:
        tr = StreamingTracker(rig, cfg)
        for img, t in frames: tr.push(img, t)     # no device->host reads
        times, R, t = tr.get_trajectory()          # single fetch
    """

    def __init__(self, rig: RigParams, cfg: StreamConfig, seed: int = 0,
                 loop_closer=None):
        self.cfg = cfg
        orb_cfg = cfg.orb or extractor.OrbConfig()
        self.map = ms.allocate(cfg.max_kf, orb_cfg.n_features, cfg.max_mp)
        self.carry = init_carry(orb_cfg.n_features, cfg.traj_cap, seed)
        self.rig = jax.device_put(rig)
        self._step = make_step(self.rig, cfg)
        self.loop_closer = loop_closer
        self._last_lc_slot = -1

    def push(self, img, time: float):
        self.map, self.carry = self._step(
            self.map, self.carry, np.asarray(img), np.float32(time))
        self._snap = None

    def block(self):
        """Wait for the pipeline to drain WITHOUT a device->host copy."""
        jax.block_until_ready(self.carry.t)

    def maybe_close_loop(self) -> bool:
        """Loop detection/correction on the newest keyframe. Host-policy
        and synchronizing — call at LOW cadence from the application loop
        (see StreamingVITracker.maybe_close_loop)."""
        if self.loop_closer is None:
            return False
        slot = int(self.snapshot()["n_kf"]) - 1
        if slot < 1 or slot == self._last_lc_slot:
            return False
        self._last_lc_slot = slot
        self._snap = None
        old_R, old_t = self.map.kf_R, self.map.kf_t
        m2, closed = self.loop_closer.on_keyframe(self.map, slot)
        if not closed:
            self.map = m2
            return False
        c = self.carry
        ref = jnp.maximum(c.last_kf_slot, 0)
        R_rel = jnp.swapaxes(old_R[ref], -1, -2) @ c.R
        t_rel = jnp.einsum("ji,j->i", old_R[ref], c.t - old_t[ref])
        self.carry = c._replace(
            R=m2.kf_R[ref] @ R_rel,
            t=m2.kf_t[ref] + m2.kf_R[ref] @ t_rel)
        self.map = m2
        return True

    def snapshot(self) -> dict:
        """Trajectory + counters in one `jax.device_get`; cached until the
        next push()."""
        if getattr(self, "_snap", None) is not None:
            return self._snap
        tr = self.carry.traj
        self._snap = jax.device_get(dict(
            time=tr.time, ref=tr.ref, R_rel=tr.R_rel, t_rel=tr.t_rel,
            ok=tr.ok, idx=tr.idx, kf_R=self.map.kf_R, kf_t=self.map.kf_t,
            n_kf=self.map.n_kf, n_mp=self.map.n_mp))
        return self._snap

    def get_trajectory(self):
        """Fetch + replay relative poses against final keyframe poses."""
        s = self.snapshot()
        n = int(min(s["idx"], s["time"].shape[0]))
        kf_R, kf_t = s["kf_R"], s["kf_t"]
        times, Rs, ts = [], [], []
        for i in range(n):
            ref = s["ref"][i]
            times.append(s["time"][i])
            Rs.append(kf_R[ref] @ s["R_rel"][i])
            ts.append(kf_t[ref] + kf_R[ref] @ s["t_rel"][i])
        return (np.asarray(times), np.stack(Rs) if Rs else np.zeros(
            (0, 3, 3)), np.stack(ts) if ts else np.zeros((0, 3)))

    @property
    def n_kf(self):
        return int(self.snapshot()["n_kf"])
