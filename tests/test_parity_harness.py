"""Parity harness (scripts/parity.py) + multisession main wiring.

BASELINE.json configs 1-5 must be fireable the moment a dataset
directory is mounted: config table resolves, reference yamls ingest,
reference-shipped EuRoC ground truth loads with the reference metric
semantics, and missing datasets are reported (not crashed on).
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_parity():
    spec = importlib.util.spec_from_file_location(
        "parity", os.path.join(REPO, "scripts", "parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_table_resolves():
    parity = _load_parity()
    keys = [c[0] for c in parity.CONFIGS]
    assert keys == ["mono-mh01", "si-v102", "mi-tumvi-room1",
                    "multi-hilti-exp01"]
    for _, main, _, yaml_path, _, gate, _ in parity.CONFIGS:
        assert os.path.exists(os.path.join(REPO, "examples", main)), main
        assert gate > 0
    assert os.path.exists(os.path.join(REPO, "examples",
                                       "multisession_euroc.py"))


def test_reference_yamls_ingest():
    from openmavis_jax.io import settings as cfg_mod
    parity = _load_parity()
    for _, _, _, yaml_path, _, _, _ in parity.CONFIGS:
        if not os.path.exists(yaml_path):
            pytest.skip(f"reference yaml missing: {yaml_path}")
        cfg = cfg_mod.load_settings(yaml_path)
        assert cfg["rig"].params.shape[0] >= 1
        assert cfg["camera_width"] > 0


def test_reference_ground_truth_loads():
    from openmavis_jax.io import evaluation
    gt = os.path.join(_load_parity().GT_EUROC, "MH01_GT.txt")
    if not os.path.exists(gt):
        pytest.skip("reference GT not mounted")
    t, p = evaluation.load_ground_truth(gt)
    assert len(t) > 1000 and p.shape[1] == 3
    assert t[0] > 1e9 - 1  # absolute epoch seconds (converted from ns)
    span = np.linalg.norm(p.max(0) - p.min(0))
    assert 1.0 < span < 500.0


def test_missing_dataset_reports_cleanly(tmp_path):
    parity = _load_parity()
    res = parity.run_config("mono-mh01", str(tmp_path))
    assert res["status"] == "missing"
    assert "looked_for" in res


def test_cli_list():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "parity.py"),
         "list"], capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0
    for key in ("mono-mh01", "si-v102", "mi-tumvi-room1",
                "multi-hilti-exp01", "multisession-mh"):
        assert key in proc.stdout


def test_cli_all_missing_returns_2(tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "parity.py"),
         "all", "--data-root", str(tmp_path)],
        capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 2, (proc.stdout, proc.stderr)
