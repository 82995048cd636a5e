"""Multi-session Atlas + distributed GBA: the BASELINE.json north-star
workload (config #5 — multi-session mapping with merging and distributed
global BA over the device mesh).

Two tracked sessions of the same scene are merged through the detected
cross-map Sim3 (LoopCloser.detect_merge + welding BA), then the MERGED map
is globally optimized with the landmark-sharded distributed GBA on the
8-device mesh and must agree with the single-device solve.

(reference: multi-session operation via Atlas save/load + MergeLocal,
src/LoopClosing.cc:1381/1956; the distributed stage is the new
capability — SURVEY.md §2.3.)
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import extractor
from openmavis_jax.geometry import cameras, lie
from openmavis_jax.io import evaluation, synthetic
from openmavis_jax.optim import ba
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.parallel import dist_ba
from openmavis_jax.pipeline import loop_closing, tracking
from openmavis_jax.slam_map import atlas as atlas_mod

pytestmark = pytest.mark.slow

W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def mono_rig():
    return RigParams(kind=cameras.PINHOLE,
                     params=jnp.asarray(PIN)[None],
                     R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))


def _track_session(world, n_frames, frac0, frac1, seed):
    R_wc, t_wc = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=frac1 - frac0,
                                            start=frac0)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, PIN,
                                       R_wc, t_wc, W, H)
    cfg = tracking.TrackerConfig(
        img_w=W, img_h=H,
        orb=extractor.OrbConfig(n_features=384, n_levels=4),
        max_kf=24, max_mp=4096)
    tr = tracking.Tracker(mono_rig(), cfg, seed=seed)
    for i, img in enumerate(frames):
        tr.process_frame(jnp.asarray(img), time=i / 20.0)
    return tr, t_wc


def test_multisession_merge_and_distributed_gba():
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    # two overlapping sessions: B traverses backward and ENDS inside A's
    # segment, so merge detection (which queries the newest keyframe)
    # sees the revisit
    tr_a, _ = _track_session(world, 26, 0.00, 0.22, seed=0)
    tr_b, _ = _track_session(world, 26, 0.32, 0.10, seed=1)
    assert tr_a.state == tr_a.OK and tr_b.state == tr_b.OK

    atlas = atlas_mod.Atlas()
    atlas.maps = [tr_a.map, tr_b.map]
    atlas.current = 1

    lc = loop_closing.LoopCloser(None, 24, rig=mono_rig(),
                                 img_w=W, img_h=H)
    hit = lc.detect_merge(atlas, slot=int(tr_b.map.n_kf) - 1)
    assert hit is not None, "overlapping sessions were not merged"
    new_id, kf_off, _ = hit
    merged = atlas.maps[new_id]
    n_kf = int(merged.n_kf)
    assert n_kf == int(tr_a.map.n_kf) + int(tr_b.map.n_kf)

    # distributed GBA over the merged map (landmark-sharded, 8 devices)
    obs, observed, _, _ = tracking.full_map_observations(merged)
    state0 = ba.BAState(R=merged.kf_R, t=merged.kf_t, v=merged.kf_v,
                        bg=merged.kf_bg, ba=merged.kf_ba,
                        points=merged.mp_pos)
    K = merged.kf_R.shape[0]
    fixed = (jnp.arange(K) < 2) | ~merged.kf_valid

    mesh = dist_ba.make_mesh(jax.devices()[:8])
    st_d, inl_d, chi_d = dist_ba.distributed_global_ba_lsharded(
        mesh, state0, obs, mono_rig(), fixed, point_fixed=~observed,
        stages=(2,), cg_iters=8)
    assert np.isfinite(float(chi_d))

    from openmavis_jax.optim import global_ba
    st_1, inl_1, chi_1 = jax.jit(
        lambda s, o: global_ba.global_bundle_adjust(
            s, o, mono_rig(), fixed, point_fixed=~observed,
            stages=(2,), cg_iters=8))(state0, obs)
    # distributed and single-device solves agree
    assert abs(float(chi_d) - float(chi_1)) <= 0.02 * abs(
        float(chi_1)) + 1e-3
    dt = float(jnp.abs(st_d.t - st_1.t).max())
    assert dt < 0.05, dt
