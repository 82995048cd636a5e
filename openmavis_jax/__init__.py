"""openmavis_jax — a multi-camera visual-inertial SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of OpenMAVIS
(ORB-SLAM3 + 4-camera rig + SE2(3) exact IMU pre-integration; see SURVEY.md).
Not a port: the pointer-graph + mutex architecture of the C++ reference is
replaced by device-resident structure-of-arrays map slabs, jit-compiled
kernels for every compute-heavy component, and `jax.sharding` for scale-out.

Subpackages
-----------
geometry   Lie groups (SO3/SE3/Sim3), camera models, triangulation.
imu        SE2(3) IMU pre-integration (`lax.scan` over samples).
frontend   Image pyramid, FAST + oriented-BRIEF extraction, Hamming matching.
solvers    Batched RANSAC solvers: two-view H/F, Sim3 Horn, PnP.
optim      Batched Levenberg-Marquardt, Schur-complement BA, pose graphs.
slam_map   Fixed-capacity map slabs, Atlas, keyframe database, vocabulary.
pipeline   Tracking / local mapping / loop closing orchestration + System facade.
parallel   Device meshes, sharded BA reductions, distributed place recognition.
io         Dataset loaders, yaml settings, trajectory writers, checkpoints.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Geometry and BA math everywhere in this package assumes true float32
# accumulation. On the GPU, float32 matmuls otherwise run in TF32 (about
# three decimal digits), which is catastrophic for 3x3 pose algebra and
# normal-equation assembly. Hot products that are exact in bf16
# (descriptor-distance matmuls over {0,1} planes) opt back in explicitly
# with precision/preferred_element_type at the call site.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the full pipeline is a few large jitted
# programs whose first compile dominates a cold run. The cache lives where
# JAX_COMPILATION_CACHE_DIR says (JAX reads the variable itself) or, when
# that is unset, at a fixed path inside the checkout: the path is part of
# the cache key, so it must not move between runs.
# CPU-only runs (the test suite) stay uncached: jaxlib 0.9.0 reads XLA:CPU
# entries back with a machine-feature mismatch error ("could lead to
# execution errors such as SIGILL"), and on the 8-device test mesh the
# readback aborted the process.
REPO_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _cpu_only() -> bool:
    plat = (_jax.config.jax_platforms
            or _os.environ.get("JAX_PLATFORMS") or "")
    first = plat.split(",")[0].strip().lower()
    return first == "cpu"


def compile_cache_dir() -> str | None:
    """Directory of the persistent compile cache, or None when uncached."""
    if _cpu_only():
        return None
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


# XLA:GPU autotuning compiles and times every candidate kernel of every
# matmul, and the per-frame program holds hundreds of small ones. In one
# run on an H100 (700 W limit) the flagship per-frame program compiled in
# 343.7 s with autotuning at its default level and in 211.6 s without, and
# ran warm at 11.90-12.64 ms/frame with it (three passes) and 12.47
# ms/frame without: no runtime cost could be seen (PERF.md, PR 1). The
# flag only reaches the GPU backend if this package is imported before JAX
# brings up its devices; a value the user already put in XLA_FLAGS wins.
GPU_XLA_FLAGS = ("--xla_gpu_autotune_level=0",)
if not _cpu_only():
    _flags = _os.environ.get("XLA_FLAGS", "")
    for _f in GPU_XLA_FLAGS:
        if _f.split("=")[0] not in _flags:
            _flags = f"{_flags} {_f}"
    _os.environ["XLA_FLAGS"] = _flags.strip()

if compile_cache_dir() is None:
    _jax.config.update("jax_enable_compilation_cache", False)
elif not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
