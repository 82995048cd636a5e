"""Test configuration: force an 8-device virtual CPU mesh before jax imports.

Multi-device sharding tests run against ``xla_force_host_platform_device_count``
virtual CPU devices — the mechanism SURVEY.md §4 prescribes for testing
multi-device code without several GPUs.

A process that has already brought up its devices (chip_smoke.py runs the
tests marked ``gpu`` on the card in its own process) keeps them: the
platform is forced only while no backend exists yet.
"""

import os

from jax._src import xla_bridge

if not xla_bridge.backends_are_initialized():
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ.setdefault("JAX_ENABLE_X64", "0")

    import jax

    jax.config.update("jax_platforms", "cpu")

# NOTE: do NOT enable jax_compilation_cache_dir here. jaxlib 0.9.0's CPU
# executable deserialization aborts the process (SIGABRT in
# compilation_cache.get_executable_and_time) when reading back its own
# entries, so the persistent cache cannot be used on the test mesh. Suite
# time is managed by marking heavyweight end-to-end tests `slow` instead.
