"""Reference-format yaml ingestion (reference: src/Settings.cc:358-617).

The reference ships OpenCV-format yamls (`%YAML:1.0` directive,
`!!opencv-matrix` nodes, flat dotted keys like `Camera1.fx`, KB8
distortion named `k1..k4`, rig extrinsics `IMU.T_b_c1/c3/c4` +
`Stereo.T_c1_c2`). These must load verbatim — no hand-translation.
"""

import numpy as np

from openmavis_jax.geometry import cameras
from openmavis_jax.io import settings as cfg_mod

# A Hilti-style 3-camera KB8 rig written in the reference's OpenCV yaml
# dialect (our own numbers).
REF_YAML = """\
%YAML:1.0

File.version: "1.0"

Camera.type: "KannalaBrandt8"

Camera1.fx: 350.0
Camera1.fy: 351.0
Camera1.cx: 360.0
Camera1.cy: 270.0
Camera1.k1: -0.04
Camera1.k2: 0.003
Camera1.k3: -0.0037
Camera1.k4: 0.0008

Camera2.fx: 352.0
Camera2.fy: 353.0
Camera2.cx: 361.0
Camera2.cy: 255.0
Camera2.k1: -0.043
Camera2.k2: 0.004
Camera2.k3: -0.0038
Camera2.k4: 0.0006

Camera3.fx: 349.0
Camera3.fy: 349.5
Camera3.cx: 342.0
Camera3.cy: 260.0
Camera3.k1: -0.039
Camera3.k2: -0.0016
Camera3.k3: 0.00026
Camera3.k4: -0.0004

Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [ 1.0, 0.0, 0.0, 0.11,
          0.0, 1.0, 0.0, 0.001,
          0.0, 0.0, 1.0, 0.0004,
          0, 0, 0, 1]

Camera1.overlappingBegin: 0
Camera1.overlappingEnd: 720

Camera2.overlappingBegin: 40
Camera2.overlappingEnd: 700

Camera.width: 720
Camera.height: 540
Camera.fps: 30

Stereo.ThDepth: 40.0

IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0, -1.0, 0.0, 0.05,
          1.0, 0.0, 0.0, -0.06,
          0.0, 0.0, 1.0, -0.01,
          0, 0, 0, 1]

IMU.T_b_c3: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [1.0, 0.0, 0.0, -0.008,
         0.0, 0.0, -1.0, -0.08,
         0.0, 1.0, 0.0, -0.0097,
         0, 0, 0, 1]

IMU.NoiseGyro: 0.000171
IMU.NoiseAcc: 0.0086
IMU.GyroWalk: 3.1e-06
IMU.AccWalk: 0.00022
IMU.Frequency: 400.0

ORBextractor.nFeatures: 500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 15
ORBextractor.minThFAST: 7
"""


def _parse(tmp_path, text):
    p = tmp_path / "ref.yaml"
    p.write_text(text)
    return cfg_mod.load_settings(str(p))


def test_reference_yaml_kb8_rig(tmp_path):
    cfg = _parse(tmp_path, REF_YAML)
    rig = cfg["rig"]
    assert rig.kind == cameras.KB8
    assert rig.params.shape == (3, 8)
    p1 = np.asarray(rig.params[0])
    # yaml k1..k4 -> internal theta-poly [k0..k3] (Settings.cc:254-259)
    np.testing.assert_allclose(
        p1, [350.0, 351.0, 360.0, 270.0, -0.04, 0.003, -0.0037, 0.0008],
        rtol=1e-6)
    assert cfg["camera_width"] == 720 and cfg["camera_height"] == 540
    assert cfg["camera_fps"] == 30.0
    assert cfg["imu_frequency"] == 400.0
    assert cfg["imu_noise"] is not None
    np.testing.assert_allclose(cfg["lapping"],
                               [[0, 720], [40, 700], [0, 720]])


def test_reference_yaml_extrinsic_chain(tmp_path):
    """Camera2's pose must chain T_b_c2 = T_b_c1 @ T_c1_c2
    (Settings.cc:611-617); camera3 reads IMU.T_b_c3 directly."""
    cfg = _parse(tmp_path, REF_YAML)
    rig = cfg["rig"]
    T_bc1 = np.array([[0, -1, 0, 0.05], [1, 0, 0, -0.06],
                      [0, 0, 1, -0.01], [0, 0, 0, 1.0]])
    T_c1c2 = np.eye(4)
    T_c1c2[:3, 3] = [0.11, 0.001, 0.0004]
    T_bc2 = T_bc1 @ T_c1c2
    # stored camera-from-body
    R2 = np.asarray(rig.R_cb[1])
    t2 = np.asarray(rig.t_cb[1])
    np.testing.assert_allclose(R2, T_bc2[:3, :3].T, atol=1e-6)
    np.testing.assert_allclose(t2, -T_bc2[:3, :3].T @ T_bc2[:3, 3],
                               atol=1e-6)
    T_bc3 = np.array([[1, 0, 0, -0.008], [0, 0, -1, -0.08],
                      [0, 1, 0, -0.0097], [0, 0, 0, 1.0]])
    np.testing.assert_allclose(np.asarray(rig.R_cb[2]), T_bc3[:3, :3].T,
                               atol=1e-6)


def test_k0_alias_still_accepted(tmp_path):
    """The repo's own k0..k3 naming keeps working for KB8."""
    cfg = cfg_mod.load_settings({
        "Camera": {"type": "KannalaBrandt8", "width": 512, "height": 512},
        "Camera1": {"fx": 190.0, "fy": 190.0, "cx": 256.0, "cy": 256.0,
                    "k0": 0.0035, "k1": 0.0007, "k2": -0.002,
                    "k3": 0.0002},
    })
    p = np.asarray(cfg["rig"].params[0])
    np.testing.assert_allclose(p[4:], [0.0035, 0.0007, -0.002, 0.0002],
                               rtol=1e-6)


def test_pinhole_radtan_unaffected(tmp_path):
    """PinHole k1/k2/p1/p2 stay radtan distortion, not intrinsic tail."""
    cfg = cfg_mod.load_settings({
        "Camera": {"type": "PinHole", "width": 752, "height": 480},
        "Camera1": {"fx": 458.0, "fy": 457.0, "cx": 367.0, "cy": 248.0,
                    "k1": -0.28, "k2": 0.07, "p1": 0.0002, "p2": 1.8e-5},
    })
    p = np.asarray(cfg["rig"].params[0])
    np.testing.assert_allclose(p[4:], 0.0)
    np.testing.assert_allclose(np.asarray(cfg["dist"][0]),
                               [-0.28, 0.07, 0.0002, 1.8e-5], rtol=1e-5)


def test_actual_reference_yaml_files():
    """The shipped reference yamls load as-is (no translation step)."""
    import os
    ref = "/root/reference/Examples"
    candidates = [
        os.path.join(ref, "Multi-Inertial", "HiltiChallenge2022.yaml"),
        os.path.join(ref, "Stereo-Inertial", "EuRoC.yaml"),
        os.path.join(ref, "Monocular-Inertial", "TUM-VI.yaml"),
    ]
    for path in candidates:
        if not os.path.exists(path):
            continue
        cfg = cfg_mod.load_settings(path)
        assert cfg["rig"].params.shape[0] >= 1, path
        assert cfg["camera_width"] > 0, path
        assert cfg["imu_noise"] is not None, path
