"""Atlas multi-map lifecycle: new-map-on-LOST, cross-map merge detection,
4DoF pose graph, and Sim3 reprojection refinement."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras, lie
from openmavis_jax.optim import pose_graph, sim3_refine
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.pipeline import loop_closing, tracking
from openmavis_jax.slam_map import atlas as atlas_mod
from openmavis_jax.io import synthetic

# heavyweight (compile-dominated) — excluded from the fast tier
pytestmark = __import__('pytest').mark.slow

W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def mono_rig():
    return RigParams(kind=cameras.PINHOLE,
                     params=jnp.asarray(PIN)[None],
                     R_cb=jnp.eye(3)[None],
                     t_cb=jnp.zeros((1, 3)))


def _tracked_map(n_frames=24):
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    R_wc, t_wc = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=0.2)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, PIN,
                                       R_wc, t_wc, W, H)
    cfg = tracking.TrackerConfig(
        img_w=W, img_h=H,
        orb=extractor.OrbConfig(n_features=512, n_levels=4),
        max_kf=32, max_mp=4096, max_lost_frames=3)
    atlas = atlas_mod.Atlas()
    tr = tracking.Tracker(mono_rig(), cfg, seed=0, atlas=atlas)
    for i, img in enumerate(frames):
        tr.process_frame(jnp.asarray(img), time=i / 20.0)
    return tr, atlas, frames


def test_new_map_on_persistent_loss():
    """Blank frames force LOST; after max_lost_frames the tracker parks
    the map in the Atlas and spawns a fresh one (reference:
    Tracking::CreateMapInAtlas, src/Tracking.cc:1953-1968)."""
    tr, atlas, frames = _tracked_map()
    assert tr.state == tr.OK
    assert atlas.n_maps() == 1
    n_kf_before = tr.n_kf

    blank = jnp.zeros_like(jnp.asarray(frames[0]))
    for i in range(tr.cfg.max_lost_frames + 3):
        tr.process_frame(blank, time=2.0 + i / 20.0)
    assert atlas.n_maps() == 2, "no new map spawned after persistent loss"
    assert tr.state == tr.NOT_INITIALIZED
    assert int(atlas.maps[0].n_kf) == n_kf_before  # old map preserved
    # trajectory replay still resolves across both maps
    t_est, _, p_est = tr.get_trajectory()
    assert np.isfinite(p_est).all()


def test_detect_merge_welds_maps():
    """A copy of the map moved by a known Sim3 must be detected as the
    same place and welded back (reference: LoopClosing merge path +
    MergeLocal, src/LoopClosing.cc:176-204,1381)."""
    tr, atlas, _ = _tracked_map()
    tr._sync_atlas()
    m_a = tr.map
    n_kf = int(m_a.n_kf)
    assert n_kf >= 3

    # map B: same place, different world frame (drifted session)
    s = 1.12
    R = np.asarray(lie.so3_exp(jnp.asarray([0.0, 0.0, 0.4])))
    t = np.array([2.0, -1.0, 0.5], np.float32)
    m_b = atlas_mod.transform_map(m_a, jnp.asarray(s, jnp.float32),
                                  jnp.asarray(R, jnp.float32),
                                  jnp.asarray(t, jnp.float32))
    atlas.maps.append(m_b)
    atlas.current = 1

    lc = loop_closing.LoopCloser(None, 32, rig=mono_rig())
    hit = lc.detect_merge(atlas, slot=n_kf - 1)
    assert hit is not None, "merge not detected between identical places"
    new_id, kf_off, mp_off = hit
    assert atlas.n_maps() == 1
    assert kf_off == n_kf
    merged = atlas.maps[new_id]
    assert int(merged.n_kf) == 2 * n_kf

    # welded KF poses must land on the originals (Sim3 undone)
    t_orig = np.asarray(m_a.kf_t[:n_kf])
    t_weld = np.asarray(merged.kf_t[kf_off:kf_off + n_kf])
    err = np.linalg.norm(t_orig - t_weld, axis=-1).max()
    assert err < 0.15, err


def test_pose_graph_4dof_closes_loop():
    """Yaw-drifted chain with a loop edge: 4DoF optimization recovers the
    ground truth without touching roll/pitch (reference:
    Optimizer::OptimizeEssentialGraph4DoF, src/Optimizer.cc:6171)."""
    K = 12
    rng = np.random.default_rng(0)
    yaws = np.linspace(0, 2 * np.pi, K)
    R_gt = np.stack([np.asarray(lie.so3_exp(jnp.asarray([0.0, 0.0, y])))
                     for y in yaws])
    t_gt = np.stack([[np.cos(y) * 3, np.sin(y) * 3, 0.1 * i]
                     for i, y in enumerate(yaws)])
    Rcw = np.swapaxes(R_gt, 1, 2)
    tcw = -np.einsum("kij,kj->ki", Rcw, t_gt)
    Rn, tn = [Rcw[0]], [tcw[0]]
    for k in range(1, K):
        dR = np.asarray(lie.so3_exp(
            jnp.asarray(rng.normal(0, 0.02, 3) * [0, 0, 1.0])))
        Rn.append(dR @ Rcw[k])
        tn.append(tcw[k] + rng.normal(0, 0.1, 3))
    Rn, tn = np.stack(Rn), np.stack(tn)

    i = jnp.arange(K - 1)
    j = i + 1
    Ri_, ti_ = lie.se3_inverse(jnp.asarray(Rcw)[i], jnp.asarray(tcw)[i])
    Re, te = lie.se3_compose(jnp.asarray(Rcw)[j], jnp.asarray(tcw)[j],
                             Ri_, ti_)
    li, lj = jnp.asarray([0]), jnp.asarray([K - 1])
    Ri2, ti2 = lie.se3_inverse(jnp.asarray(Rcw)[li], jnp.asarray(tcw)[li])
    Rl, tl = lie.se3_compose(jnp.asarray(Rcw)[lj], jnp.asarray(tcw)[lj],
                             Ri2, ti2)
    edges = pose_graph.PoseGraphEdgesSE3(
        i=jnp.concatenate([i, li]), j=jnp.concatenate([j, lj]),
        R=jnp.concatenate([Re, Rl]), t=jnp.concatenate([te, tl]),
        weight=jnp.ones(K), valid=jnp.ones(K, bool))
    fixed = jnp.zeros(K, bool).at[0].set(True)
    R_o, t_o, chi = pose_graph.optimize_pose_graph_4dof(
        jnp.asarray(Rn, jnp.float32), jnp.asarray(tn, jnp.float32),
        edges, fixed, jnp.ones(K, bool))
    err0 = np.linalg.norm(tn - tcw, axis=1).mean()
    err1 = np.linalg.norm(np.asarray(t_o) - tcw, axis=1).mean()
    assert err1 < 0.2 * err0, (err0, err1)
    # gravity preserved: z-axis of each rotation unchanged in roll/pitch
    for k in range(K):
        z_before = Rn[k][2, :] / np.linalg.norm(Rn[k][2, :])
        z_after = np.asarray(R_o[k])[2, :]
        # rotation about z keeps the third ROW's z-component fixed
        assert abs(z_before[2] - z_after[2]) < 1e-4


def test_refine_sim3_reprojection():
    """GN refinement recovers a perturbed Sim3 to sub-1% scale error
    (reference: Optimizer::OptimizeSim3, src/Optimizer.cc:2460)."""
    rng = np.random.default_rng(1)
    N = 80
    params = np.tile(PIN, (N, 1))
    s_gt = 1.15
    R_gt = np.asarray(lie.so3_exp(jnp.asarray([0.05, -0.1, 0.3])))
    t_gt = np.array([0.4, -0.2, 0.6])
    p1 = rng.uniform([-2, -2, 3], [2, 2, 8], (N, 3)).astype(np.float32)
    p2 = (s_gt * p1 @ R_gt.T + t_gt).astype(np.float32)
    R_cb = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
    t_cb = np.zeros((N, 3), np.float32)
    uv1 = np.array(cameras.project(cameras.PINHOLE, jnp.asarray(params),
                                   jnp.asarray(p1)))
    uv2 = np.array(cameras.project(cameras.PINHOLE, jnp.asarray(params),
                                   jnp.asarray(p2)))
    uv1 = uv1 + rng.normal(0, 0.3, uv1.shape)
    uv2 = uv2 + rng.normal(0, 0.3, uv2.shape)
    dR = np.asarray(lie.so3_exp(jnp.asarray([0.02, -0.03, 0.05])))
    sig = np.ones(N, np.float32)
    out = sim3_refine.refine_sim3(
        jnp.asarray(s_gt * 1.08, jnp.float32),
        jnp.asarray(dR @ R_gt, jnp.float32),
        jnp.asarray(t_gt + np.array([0.1, -0.05, 0.1]), jnp.float32),
        jnp.asarray(p1), jnp.asarray(p2),
        jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32),
        jnp.asarray(sig), jnp.asarray(sig), jnp.ones(N, bool),
        cameras.PINHOLE, jnp.asarray(params), jnp.asarray(params),
        jnp.asarray(R_cb), jnp.asarray(t_cb),
        jnp.asarray(R_cb), jnp.asarray(t_cb))
    assert abs(float(out.s) - s_gt) < 0.01
    assert int(out.n_inliers) > 60
    assert np.linalg.norm(np.asarray(out.t) - t_gt) < 0.05

    # fix_scale mode must keep the initial scale untouched
    out_fs = sim3_refine.refine_sim3(
        jnp.asarray(1.0, jnp.float32),
        jnp.asarray(dR @ R_gt, jnp.float32),
        jnp.asarray(t_gt, jnp.float32),
        jnp.asarray(p1), jnp.asarray(p2 / s_gt, jnp.float32),
        jnp.asarray(uv1, jnp.float32),
        jnp.asarray(np.array(cameras.project(
            cameras.PINHOLE, jnp.asarray(params),
            jnp.asarray(p2 / s_gt, jnp.float32))), jnp.float32),
        jnp.asarray(sig), jnp.asarray(sig), jnp.ones(N, bool),
        cameras.PINHOLE, jnp.asarray(params), jnp.asarray(params),
        jnp.asarray(R_cb), jnp.asarray(t_cb),
        jnp.asarray(R_cb), jnp.asarray(t_cb), fix_scale=True)
    assert abs(float(out_fs.s) - 1.0) < 1e-6


def test_welding_ba_reduces_seam_error():
    """After a noisy Sim3 weld, the welding BA (reference: the welding
    LocalBundleAdjustment src/Optimizer.cc:3927 run by MergeLocal) must
    pull the welded-in keyframes back toward the true registration."""
    tr, atlas, _ = _tracked_map()
    tr._sync_atlas()
    m_a = tr.map
    n_kf = int(m_a.n_kf)
    K = m_a.kf_R.shape[0]

    # map B: the same map, perturbed — simulates accumulated drift that a
    # rigid Sim3 weld cannot remove
    rng = np.random.RandomState(0)
    dt_noise = jnp.asarray(rng.normal(0, 0.05, size=(K, 3)),
                           jnp.float32)
    m_b = m_a._replace(kf_t=m_a.kf_t + dt_noise)

    merged, ok = atlas_mod.merge_maps(m_a, m_b, jnp.ones(()),
                                      jnp.eye(3), jnp.zeros(3))
    assert ok
    free = (jnp.arange(merged.kf_R.shape[0]) >= n_kf) & merged.kf_valid

    def seam_err(m):
        t_orig = np.asarray(m_a.kf_t[:n_kf])
        t_weld = np.asarray(m.kf_t[n_kf:2 * n_kf])
        return float(np.linalg.norm(t_orig - t_weld, axis=-1).mean())

    err_raw = seam_err(merged)
    welded, chi = tracking.welding_ba_step(merged, free,
                                           cameras.PINHOLE, mono_rig())
    err_ba = seam_err(welded)
    assert np.isfinite(float(chi))
    assert err_ba < err_raw * 0.6, (err_raw, err_ba)
