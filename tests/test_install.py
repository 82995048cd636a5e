"""Installation policy: the compile-cache directory, and a System built
from a dict config without PyYAML."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax, openmavis_jax as o; "
          "print(o.compile_cache_dir()); "
          "print(jax.config.jax_compilation_cache_dir); "
          "print(jax.config.jax_enable_compilation_cache)")


def _probe(env_extra, unset=()):
    env = {k: v for k, v in os.environ.items() if k not in unset}
    env.update(env_extra, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split("\n")[:3]


@pytest.mark.parametrize("case", ["env_set", "env_unset", "cpu_only"])
def test_compile_cache_dir(case, tmp_path):
    # no backend is brought up: importing the package only sets config
    if case == "env_set":
        d = str(tmp_path / "cache")
        chosen, configured, enabled = _probe(
            {"JAX_PLATFORMS": "cuda", "JAX_COMPILATION_CACHE_DIR": d})
        assert chosen == configured == d and enabled == "True"
    elif case == "env_unset":
        chosen, configured, enabled = _probe(
            {"JAX_PLATFORMS": "cuda"}, unset=("JAX_COMPILATION_CACHE_DIR",))
        assert chosen == configured == os.path.join(REPO, ".jax_cache")
        assert enabled == "True"
    else:
        chosen, _, enabled = _probe(
            {"JAX_PLATFORMS": "cpu",
             "JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        assert chosen == "None" and enabled == "False"


def test_system_without_yaml():
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from openmavis_jax.io import settings\n"
        "from openmavis_jax.pipeline.system import Sensor, System\n"
        "cfg = settings.example_settings(n_cams=2)\n"
        "cfg['ORBextractor'].update(nFeatures=64, nLevels=2)\n"
        "slam = System(cfg, Sensor.IMU_MULTI,\n"
        "              tracker_overrides={'max_kf': 4, 'max_mp': 256})\n"
        "assert slam.tracker is not None\n"
        "print('built')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "built" in proc.stdout
