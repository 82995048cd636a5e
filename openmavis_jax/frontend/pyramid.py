"""Image pyramid + Gaussian blur, static shapes per level.

JAX replacement for ORBextractor::ComputePyramid (reference:
src/ORBextractor.cc) — levels are computed by `jax.image.resize` with static
per-level shapes, and the Gaussian blur used before BRIEF sampling
(reference blurs with 7x7 sigma=2, src/ORBextractor.cc descriptor path) is a
separable depthwise convolution.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static [H, W] per level (level 0 = full resolution)."""
    shapes = []
    for lv in range(n_levels):
        s = scale ** lv
        shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes


def _gauss_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _sep_blur_2d(img: jnp.ndarray, k: jnp.ndarray, radius: int) -> jnp.ndarray:
    """[H, W] separable blur using shifts (cheap, fully fused by XLA)."""
    x = jnp.pad(img, ((radius, radius), (radius, radius)), mode="edge")
    h = jnp.zeros_like(x)
    for i in range(2 * radius + 1):
        h = h + k[i] * jnp.roll(x, radius - i, axis=1)
    v = jnp.zeros_like(h)
    for i in range(2 * radius + 1):
        v = v + k[i] * jnp.roll(h, radius - i, axis=0)
    return v[radius:-radius, radius:-radius]


def blur(img: jnp.ndarray, sigma: float = 2.0, radius: int = 3) -> jnp.ndarray:
    """Gaussian blur of [..., H, W]."""
    k = jnp.asarray(_gauss_kernel(sigma, radius))
    fn = partial(_sep_blur_2d, k=k, radius=radius)
    for _ in range(img.ndim - 2):
        fn = jax.vmap(fn)
    return fn(img)


def build_pyramid(img: jnp.ndarray, n_levels: int = 8, scale: float = 1.2):
    """[..., H, W] float image -> list of per-level images (static shapes).

    Successive bilinear resizes from the previous level (matches the
    reference's cv::resize chain rather than resizing from level 0 each time).
    """
    h, w = img.shape[-2], img.shape[-1]
    shapes = level_shapes(h, w, n_levels, scale)
    out = [img]
    for lv in range(1, n_levels):
        prev = out[-1]
        nh, nw = shapes[lv]
        out.append(jax.image.resize(
            prev, prev.shape[:-2] + (nh, nw), method="bilinear"))
    return out
