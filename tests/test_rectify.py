"""Stereo undistort-rectify maps (frontend/rectify.py).

Reference parity target: Settings::precomputeRectificationMaps
(/root/reference/src/Settings.cc:683-725 — cv::stereoRectify +
cv::initUndistortRectifyMap + per-frame cv::remap). The tests verify the
map composition analytically (a world point's raw distorted projection,
looked up through the rectified camera, lands on the SAME ROW in both
rectified views — the property rectification exists to provide), the
remap itself, the settings wiring, and an end-to-end ATE-gated run of
the stereo pipeline on synthetically distorted, unrectified renders.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from openmavis_jax.frontend import rectify
from openmavis_jax.geometry import cameras

W, H = 320, 240
K1 = np.array([260.0, 258.0, 158.0, 122.0, 0, 0, 0, 0], np.float32)
K2 = np.array([262.0, 261.0, 162.0, 118.0, 0, 0, 0, 0], np.float32)
DIST = np.array([[-0.28, 0.07, 1e-4, -1e-4],
                 [-0.28, 0.07, -1e-4, 1e-4]], np.float32)


def _rig_raw(yaw2=0.02):
    """cam1 at origin; cam2 11 cm to the right, yawed slightly inward
    (converging axes — the configuration rectification must undo)."""
    c, s = np.cos(yaw2), np.sin(yaw2)
    R12 = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    t12 = np.array([0.11, 0.0, 0.0])
    return R12, t12


def _project_raw(K, dist, p_c):
    z = np.maximum(p_c[:, 2], 1e-9)
    xn, yn = p_c[:, 0] / z, p_c[:, 1] / z
    xd, yd = rectify._radtan_distort(xn, yn, dist)
    return np.stack([K[0] * xd + K[2], K[1] * yd + K[3]], axis=-1)


def test_rows_align_and_maps_compose():
    R12, t12 = _rig_raw()
    rect = rectify.stereo_rectify_maps([K1, K2], DIST, R12, t12, W, H)
    Kn = rect["new_params"]
    R_r1, R_r2 = rect["R_rect"]

    rng = np.random.default_rng(0)
    p_c1 = np.stack([rng.uniform(-1.5, 1.5, 64),
                     rng.uniform(-1.0, 1.0, 64),
                     rng.uniform(2.0, 8.0, 64)], axis=-1)
    # the same points in cam2 coords: p_c2 = R12^T (p_c1 - t12)
    p_c2 = (p_c1 - t12) @ R12

    # rectified projections (ideal pinhole after R_rect)
    pr1 = p_c1 @ np.asarray(R_r1, np.float64).T
    pr2 = p_c2 @ np.asarray(R_r2, np.float64).T
    uv_r1 = np.stack([Kn[0] * pr1[:, 0] / pr1[:, 2] + Kn[2],
                      Kn[1] * pr1[:, 1] / pr1[:, 2] + Kn[3]], axis=-1)
    uv_r2 = np.stack([Kn[0] * pr2[:, 0] / pr2[:, 2] + Kn[2],
                      Kn[1] * pr2[:, 1] / pr2[:, 2] + Kn[3]], axis=-1)

    # ROW ALIGNMENT: same v in both rectified views
    np.testing.assert_allclose(uv_r1[:, 1], uv_r2[:, 1], atol=1e-6)
    # disparity strictly positive (cam1 left of cam2 -> u1 >= u2)
    assert np.all(uv_r1[:, 0] - uv_r2[:, 0] > 0)

    # MAP COMPOSITION: the grid at a rectified pixel must point at the
    # raw distorted projection of the same ray
    uv_raw1 = _project_raw(K1, DIST[0], p_c1)
    inside = ((uv_r1[:, 0] > 2) & (uv_r1[:, 0] < W - 3)
              & (uv_r1[:, 1] > 2) & (uv_r1[:, 1] < H - 3))
    ui = np.round(uv_r1[inside]).astype(int)
    grid = rect["maps"][0]
    looked = grid[ui[:, 1], ui[:, 0]]
    # rounding to the nearest rectified pixel moves the source point by
    # <~1 source pixel; compare against the map evaluated there
    err = np.linalg.norm(looked - uv_raw1[inside], axis=-1)
    assert np.median(err) < 1.5
    assert rect["baseline"] == pytest.approx(0.11)


def test_remap_bilinear_identity_and_shift():
    img = jnp.asarray(np.arange(24, dtype=np.float32).reshape(4, 6))
    u, v = np.meshgrid(np.arange(6, dtype=np.float32),
                       np.arange(4, dtype=np.float32))
    ident = jnp.asarray(np.stack([u, v], axis=-1))
    np.testing.assert_allclose(np.asarray(rectify.remap_bilinear(
        img, ident)), np.asarray(img))
    half = jnp.asarray(np.stack([u + 0.5, v], axis=-1))
    out = np.asarray(rectify.remap_bilinear(img, half))
    np.testing.assert_allclose(out[:, :4],
                               np.asarray(img)[:, :4] + 0.5)


def test_settings_produce_rect():
    from openmavis_jax.io import settings as cfg_mod

    R12, t12 = _rig_raw()
    T12 = np.eye(4)
    T12[:3, :3] = R12
    T12[:3, 3] = t12
    cfg = {
        "Camera": {"type": "PinHole", "width": W, "height": H},
        "Camera1": {"fx": float(K1[0]), "fy": float(K1[1]),
                    "cx": float(K1[2]), "cy": float(K1[3]),
                    "k1": float(DIST[0, 0]), "k2": float(DIST[0, 1]),
                    "p1": float(DIST[0, 2]), "p2": float(DIST[0, 3]),
                    "T_b_c": np.eye(4).tolist()},
        "Camera2": {"fx": float(K2[0]), "fy": float(K2[1]),
                    "cx": float(K2[2]), "cy": float(K2[3]),
                    "k1": float(DIST[1, 0]), "k2": float(DIST[1, 1]),
                    "p1": float(DIST[1, 2]), "p2": float(DIST[1, 3]),
                    "T_b_c": T12.tolist()},
        "Stereo": {"T_c1_c2": T12.tolist()},
    }
    s = cfg_mod.load_settings(cfg)
    assert s["rect"] is not None
    assert s["rect"]["maps"].shape == (2, H, W, 2)
    rig_r = rectify.rectified_rig(s["rig"], s["rect"])
    assert rig_r.kind == cameras.PINHOLE
    # both rectified cameras share the ideal intrinsics
    np.testing.assert_allclose(np.asarray(rig_r.params[0]),
                               np.asarray(rig_r.params[1]))
    # optical centers unchanged by rectification
    c1 = -np.asarray(rig_r.R_cb[1]).T @ np.asarray(rig_r.t_cb[1])
    np.testing.assert_allclose(c1, t12, atol=1e-6)


@pytest.mark.slow
def test_stereo_e2e_on_distorted_unrectified_renders():
    """Raw distorted, converging-axis stereo renders -> rectify -> the
    standard 2-cam streaming tracker; gated BOTH absolutely and against
    an ideal-input control run — the rectified-from-raw pipeline must
    not degrade tracking relative to the same pipeline fed ideal
    undistorted parallel-rig frames (the reference consumes
    raw EuRoC pairs through precomputeRectificationMaps,
    src/Settings.cc:683-725)."""
    from openmavis_jax.io import synthetic, evaluation
    from openmavis_jax.frontend import extractor
    from openmavis_jax.optim.reprojection import RigParams
    from openmavis_jax.pipeline import streaming_vi
    from openmavis_jax.imu import preintegration as pre_mod

    # wider baseline + closer orbit than the headline bench: at
    # 320x240/f=260 the disparity must be >~8 px for stereo scale to be
    # meaningfully observable in this small config
    R12, t12 = _rig_raw()
    t12 = np.array([0.2, 0.0, 0.0])
    nf = 40
    dt = 0.05
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    R_wb, t_wb = synthetic.orbit_trajectory(nf, radius=3.0, frac=0.3)
    imu = synthetic.imu_from_trajectory(R_wb, t_wb, dt, rate_mult=10)
    cfg = streaming_vi.VIStreamConfig(
        img_w=W, img_h=H, n_cams=2, stereo_pairs=((0, 1),),
        orb=extractor.OrbConfig(n_features=256, n_levels=4),
        imu_freq=200.0, imu_per_frame=16, max_kf=16, max_mp=2048,
        traj_cap=64, ba_window=4, imu_init_kfs=4,
        kf_max_interval_s=0.15, temporal_refs=1, min_rig_landmarks=20)
    noise = pre_mod.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3,
                                         200.0)

    def render_for(rig, dists):
        frames = []
        for c in range(2):
            R_cb = np.asarray(rig.R_cb[c])
            cb = -R_cb.T @ np.asarray(rig.t_cb[c])
            frames.append(synthetic.render_sequence(
                world, cameras.PINHOLE, np.asarray(rig.params[c]),
                R_wb @ R_cb.T,
                t_wb + np.einsum("tij,j->ti", R_wb, cb), W, H,
                dist=dists[c]))
        return np.stack(frames, axis=1).astype(np.float32)

    def track(rig_track, frames, maps=None):
        tr = streaming_vi.StreamingVITracker(rig_track, cfg, noise,
                                             seed=0)
        imu_iter = iter(imu)
        pending = next(imu_iter, None)
        for i in range(nf):
            t = i * dt
            b = []
            while pending is not None and pending[2] <= t + 1e-9:
                b.append(pending)
                pending = next(imu_iter, None)
            img = frames[i]
            if maps is not None:
                img = np.asarray(rectify.remap_multicam(
                    jnp.asarray(img), maps))
            tr.push(img, t, b)
        tr.block()
        t_est, _, p_est = tr.get_trajectory()
        ok = tr.snapshot()["ok"][:len(t_est)]
        assert ok.sum() > nf * 0.8, f"tracked {ok.sum()}/{nf}"
        res = evaluation.ate_rmse(t_est[ok], p_est[ok],
                                  np.arange(nf) * dt, t_wb,
                                  with_scale=False)
        return float(res["rmse"])

    # control: ideal parallel rig, undistorted renders
    rig_ideal = RigParams(
        kind=cameras.PINHOLE,
        params=jnp.asarray(np.stack([K1, K1])),
        R_cb=jnp.asarray(np.stack([np.eye(3), np.eye(3)])).astype(
            jnp.float32),
        t_cb=jnp.asarray(np.stack([np.zeros(3), -t12])).astype(
            jnp.float32))
    ate_ideal = track(rig_ideal, render_for(rig_ideal, (None, None)))

    # treatment: raw distorted converging rig -> rectify -> track
    rect = rectify.stereo_rectify_maps([K1, K2], DIST, R12, t12, W, H)
    rig_raw = RigParams(
        kind=cameras.PINHOLE,
        params=jnp.asarray(np.stack([K1, K2])),
        R_cb=jnp.asarray(np.stack([np.eye(3), R12.T])).astype(
            jnp.float32),
        t_cb=jnp.asarray(np.stack([np.zeros(3),
                                   -R12.T @ t12])).astype(jnp.float32))
    ate_rect = track(rectify.rectified_rig(rig_raw, rect),
                     render_for(rig_raw, (DIST[0], DIST[1])),
                     maps=jnp.asarray(rect["maps"]))

    # rectified-from-raw must match the ideal-input pipeline (and stay
    # sane absolutely on the ~5.7 m path)
    assert ate_rect < 0.15, f"rect ATE {ate_rect}"
    assert ate_rect < 1.5 * ate_ideal + 0.02, (
        f"rectified {ate_rect} vs ideal {ate_ideal}")
