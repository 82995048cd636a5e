"""Tests that need a GPU (marker ``gpu``).

They skip wherever JAX's first device is not a GPU — the CPU test mesh
included — and run on the card through ``python chip_smoke.py`` (phase e),
in that script's own process. Whether a card exists is decided inside the
fixture, so every test worker collects the same tests.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX runs on {d.platform}; "
                    "run through chip_smoke.py")
    return d


def test_match_runs_on_card_and_stays_there(gpu):
    import jax
    import jax.numpy as jnp

    from openmavis_jax.frontend import matcher

    rng = np.random.default_rng(0)
    d1 = jnp.asarray((rng.random((512, 256)) < 0.5).astype(np.int8))
    d2 = jnp.asarray((rng.random((512, 256)) < 0.5).astype(np.int8))
    valid = jnp.ones((512,), bool)
    idx, dist = jax.jit(matcher.match_nn)(d1, valid, d2, valid)
    assert idx.devices() == {gpu} and dist.devices() == {gpu}


def test_f32_matmuls_are_not_tf32(gpu):
    """The package sets "highest" matmul precision: 3x3 pose products on
    the card keep float32 accuracy (TF32 would err by ~1e-3)."""
    import jax
    import jax.numpy as jnp

    import openmavis_jax  # noqa: F401  (sets the precision)
    from openmavis_jax.geometry import lie

    rng = np.random.default_rng(1)
    w = rng.normal(size=(4096, 3)).astype(np.float32)
    R = jax.jit(jax.vmap(lie.so3_exp))(jnp.asarray(w))
    got = np.asarray(jax.jit(lambda r: r @ jnp.swapaxes(r, -1, -2))(R))
    Rn = np.asarray(R, np.float64)
    want = Rn @ np.swapaxes(Rn, -1, -2)
    assert np.abs(got - want).max() < 1e-5


def test_preintegration_matches_cpu(gpu):
    import jax
    import jax.numpy as jnp

    from openmavis_jax.imu import preintegration as pre_mod

    rng = np.random.default_rng(2)
    w = rng.normal(scale=0.5, size=(32, 3)).astype(np.float32)
    a = (rng.normal(scale=0.5, size=(32, 3))
         + [0.0, 0.0, 9.81]).astype(np.float32)
    dts = np.full((32,), 1 / 400, np.float32)
    bias = np.zeros(6, np.float32)
    noise = pre_mod.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3, 400.0)
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        pytest.skip("no CPU backend in this process (JAX_PLATFORMS)")
    f = jax.jit(pre_mod.integrate)
    on_card = f(w, a, dts, bias, noise)
    on_cpu = f(*jax.device_put((w, a, dts, bias, noise), cpu))
    assert on_card.dR.devices() == {gpu}
    for x, y in zip(jax.tree.leaves(on_card), jax.tree.leaves(on_cpu)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-4, atol=1e-5)


def test_compile_cache_follows_policy(gpu):
    import os

    import jax

    import openmavis_jax

    want = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or openmavis_jax.REPO_CACHE_DIR)
    assert openmavis_jax.compile_cache_dir() == want
    assert jax.config.jax_compilation_cache_dir == want
