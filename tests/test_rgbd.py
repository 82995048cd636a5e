"""RGB-D pipeline: depth sampling, backprojection, metric-scale tracking.

(reference parity: Frame::ComputeStereoFromRGBD + StereoInitialization —
RGB-D recovers METRIC scale from frame 0, unlike monocular.)
"""

import numpy as np
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import depth as depth_mod, extractor
from openmavis_jax.geometry import cameras
from openmavis_jax.io import evaluation, synthetic
from openmavis_jax.optim.reprojection import RigParams
from openmavis_jax.pipeline import tracking


W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def test_sample_depth_bilinear():
    d = np.zeros((8, 8), np.float32)
    d[2:6, 2:6] = 4.0
    xy = jnp.asarray([[3.5, 3.5],    # interior -> 4.0
                      [1.0, 1.0],    # hole (zeros) -> invalid
                      [2.5, 2.5],    # interior of the filled block
                      [-1.0, 3.0],   # out of bounds
                      [7.9, 7.9]])   # boundary
    val, ok = depth_mod.sample_depth(jnp.asarray(d), xy)
    ok = np.asarray(ok)
    assert ok[0] and not ok[1] and ok[2] and not ok[3] and not ok[4]
    assert np.isclose(float(val[0]), 4.0)


def test_backproject_roundtrip():
    xy = jnp.asarray([[100.0, 50.0], [400.0, 300.0], [256.0, 192.0]])
    d = jnp.asarray([2.0, 5.0, 11.0])
    p = depth_mod.backproject(cameras.PINHOLE, jnp.asarray(PIN), xy, d)
    assert np.allclose(np.asarray(p[:, 2]), np.asarray(d), atol=1e-5)
    uv = cameras.pinhole_project(jnp.asarray(PIN), p)
    assert np.allclose(np.asarray(uv), np.asarray(xy), atol=1e-3)


def test_sample_depth_undistorted_pinhole_identity():
    # When the real camera IS the virtual pinhole, both paths agree.
    d = np.full((H, W), 3.0, np.float32)
    xy = jnp.asarray([[100.0, 80.0], [300.0, 200.0]])
    v1, ok1 = depth_mod.sample_depth(jnp.asarray(d), xy)
    v2, ok2 = depth_mod.sample_depth_undistorted(
        jnp.asarray(d), xy, cameras.PINHOLE, jnp.asarray(PIN),
        jnp.asarray(PIN))
    assert np.asarray(ok1).all() and np.asarray(ok2).all()
    assert np.allclose(np.asarray(v1), np.asarray(v2), atol=1e-4)


def test_depth_to_uright():
    xy = jnp.asarray([[320.0, 100.0]])
    d = jnp.asarray([4.0])
    bf = 380.0 * 0.1
    ur = depth_mod.depth_to_uright(xy, d, bf)
    assert np.isclose(float(ur[0]), 320.0 - bf / 4.0)


@pytest.mark.slow
def test_rgbd_tracking_metric_scale():
    """End-to-end RGB-D: ATE WITHOUT scale correction must be small —
    i.e. the pipeline recovered metric scale from depth."""
    rig = RigParams(kind=cameras.PINHOLE, params=jnp.asarray(PIN)[None],
                    R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))
    world = synthetic.BlobWorld.create(seed=5, n=3000)
    n_frames = 18
    R_wc, t_wc = synthetic.orbit_trajectory(n_frames, radius=6.0, frac=0.12)

    imgs, depths = [], []
    for i in range(n_frames):
        R_cw = R_wc[i].T
        t_cw = -R_wc[i].T @ t_wc[i]
        img, dm = synthetic.render(world, cameras.PINHOLE, PIN,
                                   R_cw, t_cw, W, H, with_depth=True)
        imgs.append(img)
        depths.append(dm)

    cfg = tracking.TrackerConfig(
        img_w=W, img_h=H,
        orb=extractor.OrbConfig(n_features=512, n_levels=4),
        max_kf=16, max_mp=4096)
    tr = tracking.Tracker(rig, cfg, seed=0)
    n_ok = 0
    for i in range(n_frames):
        ok = tr.process_frame(jnp.asarray(imgs[i]), i / 20.0,
                              depth=jnp.asarray(depths[i]))
        n_ok += bool(ok)
    assert n_ok >= n_frames - 2

    times, _, p_est = tr.get_trajectory()
    res = evaluation.ate_rmse(times, p_est, np.arange(n_frames) / 20.0,
                              t_wc)
    # metric: no scale correction allowed
    assert res["rmse_noscale"] < 0.30, res
    assert 0.8 < res["scale"] < 1.25, res
