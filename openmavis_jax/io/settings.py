"""Typed yaml settings -> rig / tracker configuration.

Replacement for the reference's Settings reader (reference:
src/Settings.cc — `File.version: "1.0"` yaml with Camera1..Camera4
intrinsics, rig extrinsics `IMU.T_b_c1/c3/c4` + `Stereo.T_c1_c2`, IMU
noise, ORB params; the legacy parser lives in Tracking::Parse*ParamFile,
Tracking.cc:606-1286).

Two input dialects are accepted:

* the repo's own nested schema (see `example_settings()`), and
* **reference-format OpenCV yamls** verbatim (HiltiChallenge2022.yaml,
  EuRoC.yaml, TUM-VI.yaml ...): the `%YAML:1.0` directive is stripped,
  `!!opencv-matrix` nodes become arrays, flat dotted keys
  (`Camera1.fx`) are nested, and the reference's extrinsic key family
  (`IMU.T_b_c1/c3/c4`, `Stereo.T_c1_c2`) is understood.

Distortion-key semantics follow Settings.cc:254-259: for KannalaBrandt8
the yaml keys `k1..k4` are the four theta-polynomial coefficients stored
internally as ``[k0..k3]``; `k0..k3` keys are accepted as an alias. For
PinHole, `k1,k2,p1,p2(,k3)` are radtan distortion.
"""

from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

from ..frontend.extractor import OrbConfig
from ..geometry import cameras
from ..imu import preintegration as pre_mod
from ..optim.reprojection import RigParams


# ---------------------------------------------------------------------------
# OpenCV-yaml ingestion
# ---------------------------------------------------------------------------

@functools.cache
def _cv_loader():
    """PyYAML loader that understands OpenCV matrices. PyYAML is imported
    here, not at module level: a dict config needs no yaml package."""
    import yaml

    class _CvLoader(yaml.SafeLoader):
        pass

    def _cv_matrix(loader, node):
        return loader.construct_mapping(node, deep=True)

    _CvLoader.add_constructor("tag:yaml.org,2002:opencv-matrix", _cv_matrix)
    # OpenCV writes the tag as !!opencv-matrix which pyyaml resolves to the
    # yaml.org namespace above; some files carry the short form too.
    _CvLoader.add_constructor("!opencv-matrix", _cv_matrix)
    return yaml, _CvLoader


def _load_yaml_text(text: str) -> dict:
    yaml, loader = _cv_loader()
    # strip the (invalid-for-pyyaml) OpenCV `%YAML:1.0` directive
    lines = [ln for ln in text.splitlines()
             if not ln.strip().startswith("%YAML")]
    return yaml.load("\n".join(lines), Loader=loader) or {}


def _normalize(cfg: dict) -> dict:
    """Flat dotted keys -> nested dicts; opencv-matrix dicts -> arrays."""
    out: dict = {}
    for key, val in cfg.items():
        if (isinstance(val, dict) and "data" in val
                and "rows" in val and "cols" in val):
            val = np.asarray(val["data"], np.float64).reshape(
                int(val["rows"]), int(val["cols"]))
        if isinstance(key, str) and "." in key:
            head, tail = key.split(".", 1)
            out.setdefault(head, {})
            if isinstance(out[head], dict):
                out[head][tail] = val
            continue
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key].update(_normalize(val))
        else:
            out[key] = _normalize(val) if isinstance(val, dict) else val
    return out


def _cam_params(node: dict, kind: int) -> np.ndarray:
    p = np.zeros(8, np.float32)
    p[0] = node["fx"]
    p[1] = node["fy"]
    p[2] = node["cx"]
    p[3] = node["cy"]
    if kind == cameras.KB8:
        # Settings.cc:254-259 — yaml k1..k4 are the internal k0..k3
        # theta-poly coefficients; accept the internal names as alias.
        keys = (["k0", "k1", "k2", "k3"] if "k0" in node
                else ["k1", "k2", "k3", "k4"])
        for i, k in enumerate(keys):
            p[4 + i] = node.get(k, 0.0)
    return p


def _T(node) -> np.ndarray:
    """4x4 from a nested list / flat 16-list / array."""
    return np.asarray(node, np.float64).reshape(4, 4)


def load_settings(path_or_dict):
    """Parse settings; returns dict with rig, orb config, imu noise, misc.

    Camera model: `Camera.type` in {"PinHole", "KannalaBrandt8"}.
    Extrinsics, first match wins per camera:
    `CameraN.T_b_c` (body-from-camera 4x4), `IMU.T_b_cN`
    (reference versioned family), camera2 via `Stereo.T_c1_c2`.
    """
    if isinstance(path_or_dict, dict):
        cfg = path_or_dict
    else:
        with open(path_or_dict) as f:
            cfg = _load_yaml_text(f.read())
    cfg = _normalize(cfg)

    cam_type = cfg.get("Camera", {}).get("type", "PinHole")
    kind = cameras.PINHOLE if cam_type == "PinHole" else cameras.KB8
    imu_node = cfg.get("IMU", {}) if isinstance(cfg.get("IMU"), dict) else {}

    params, T_bc_list, dist, lapping = [], [], [], []
    for i in range(1, 9):
        key = f"Camera{i}"
        if key not in cfg:
            break
        node = cfg[key]
        params.append(_cam_params(node, kind))
        if kind == cameras.PINHOLE:
            # radtan distortion of a distorted-pinhole camera (reference:
            # the k1/k2/p1/p2 keys of e.g. EuRoC.yaml handled via
            # cv::undistortPoints in Frame::UndistortKeyPoints)
            dist.append(np.asarray(
                [node.get("k1", 0.0), node.get("k2", 0.0),
                 node.get("p1", 0.0), node.get("p2", 0.0)], np.float32))
        if "T_b_c" in node:
            T_bc = _T(node["T_b_c"])
        elif f"T_b_c{i}" in imu_node:
            T_bc = _T(imu_node[f"T_b_c{i}"])
        elif "T_b_c1" in imu_node and i == 2 and "Stereo" in cfg \
                and "T_c1_c2" in cfg["Stereo"]:
            # Settings.cc:611-617 — camera2 chained through the stereo
            # extrinsic off camera1
            T_bc = _T(imu_node["T_b_c1"]) @ _T(cfg["Stereo"]["T_c1_c2"])
        else:
            T_bc = np.eye(4)
        T_bc_list.append(T_bc)
        lapping.append([int(node.get("overlappingBegin", 0)),
                        int(node.get("overlappingEnd",
                                     cfg.get("Camera", {}).get("width", 0)))])
    if not params:
        raise ValueError("settings define no Camera1")
    dist_arr = (np.stack(dist) if dist and any(d.any() for d in dist)
                else None)

    R_cb, t_cb = [], []
    for T_bc in T_bc_list:
        # stored as camera-from-body
        R = T_bc[:3, :3].T
        R_cb.append(R.astype(np.float32))
        t_cb.append((-R @ T_bc[:3, 3]).astype(np.float32))

    rig = RigParams(kind=kind,
                    params=jnp.asarray(np.stack(params)),
                    R_cb=jnp.asarray(np.stack(R_cb)),
                    t_cb=jnp.asarray(np.stack(t_cb)))

    orb_node = cfg.get("ORBextractor", {})
    orb = OrbConfig(
        n_features=int(orb_node.get("nFeatures", 512)),
        n_levels=int(orb_node.get("nLevels", 8)),
        scale=float(orb_node.get("scaleFactor", 1.2)),
        th_high=float(orb_node.get("iniThFAST", 15)),
        th_low=float(orb_node.get("minThFAST", 7)),
    )

    noise = None
    if imu_node:
        noise = pre_mod.ImuNoise.from_sigmas(
            imu_node.get("NoiseGyro", 1.7e-4),
            imu_node.get("NoiseAcc", 2e-3),
            imu_node.get("GyroWalk", 1.9e-5),
            imu_node.get("AccWalk", 3e-3),
            imu_node.get("Frequency", 200.0))

    # stereo undistort-rectify precompute (reference:
    # Settings::precomputeRectificationMaps, src/Settings.cc:683-725 —
    # built for distorted-pinhole stereo configs with a known
    # `Stereo.T_c1_c2`): consumers remap raw images through rect["maps"]
    # and track with frontend.rectify.rectified_rig(rig, rect)
    rect = None
    if (kind == cameras.PINHOLE and dist_arr is not None
            and len(params) >= 2 and "Stereo" in cfg
            and isinstance(cfg["Stereo"], dict)
            and "T_c1_c2" in cfg["Stereo"]):
        from ..frontend import rectify as rect_mod
        T12 = _T(cfg["Stereo"]["T_c1_c2"])
        rect = rect_mod.stereo_rectify_maps(
            [params[0], params[1]], dist_arr[:2],
            T12[:3, :3], T12[:3, 3],
            int(cfg.get("Camera", {}).get("width", 640)),
            int(cfg.get("Camera", {}).get("height", 480)))

    return {
        "rig": rig,
        "rect": rect,
        "dist": dist_arr,
        "orb": orb,
        "imu_noise": noise,
        "imu_frequency": float(imu_node.get("Frequency", 200.0)),
        "camera_width": int(cfg.get("Camera", {}).get("width", 640)),
        "camera_height": int(cfg.get("Camera", {}).get("height", 480)),
        "camera_fps": float(cfg.get("Camera", {}).get("fps", 30.0)),
        "lapping": np.asarray(lapping, np.int32),
        "th_depth": float(cfg.get("Stereo", {}).get("ThDepth", 40.0)),
        "raw": cfg,
    }


def example_settings(n_cams: int = 1) -> dict:
    base = {
        "File": {"version": "1.0"},
        "Camera": {"type": "PinHole", "width": 640, "height": 480,
                   "fps": 30.0},
        "ORBextractor": {"nFeatures": 512, "nLevels": 8,
                         "scaleFactor": 1.2, "iniThFAST": 15,
                         "minThFAST": 7},
        "IMU": {"NoiseGyro": 1.7e-4, "NoiseAcc": 2e-3,
                "GyroWalk": 1.9e-5, "AccWalk": 3e-3, "Frequency": 200.0},
    }
    for i in range(1, n_cams + 1):
        base[f"Camera{i}"] = {
            "fx": 458.0, "fy": 457.0, "cx": 367.0, "cy": 248.0,
            "T_b_c": np.eye(4).tolist(),
        }
    return base
