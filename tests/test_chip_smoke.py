"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phase functions work end to end at a tiny size (2 cameras, 160x120)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import bench
import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_phases_a_to_c_tiny():
    s = cs.stream_setup(cs.TINY, 12, max_kf=16, max_mp=1024)
    tr = bench.new_tracker(s)
    shapes = cs.step_match_shapes(tr, s)
    # the map match (every landmark against one camera band) and the
    # mutual stereo spawn match are both in the per-frame program
    assert (1024, 96, False) in shapes and (96, 96, True) in shapes
    for r in cs.phase_matcher(shapes, reps=1):
        assert r["exact"], r

    b = cs.phase_stream(s, tr)
    times, R, p = b["traj"]
    assert len(times) == 12 and np.isfinite(R).all() and np.isfinite(p).all()
    assert 1 <= b["frames_tracked"] <= 12
    mem = cs.step_memory(tr, s)
    assert mem["temp_size_in_bytes"] > 0
    assert mem["peak_bytes_in_use"] is None      # CPU keeps no stats

    # XLA:CPU is deterministic: the same seed gives the same trajectory
    assert cs.same_trajectory(b, cs.phase_stream(s))
