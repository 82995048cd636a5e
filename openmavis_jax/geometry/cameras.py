"""Batched camera models: pinhole (+ radial-tangential) and Kannala-Brandt8.

JAX replacement for the reference's camera-model class hierarchy
(reference: src/CameraModels/GeometricCamera.h:40-89, Pinhole.cpp,
KannalaBrandt8.cpp). Instead of virtual dispatch, each model is a set of pure
functions over a parameter vector; the model *kind* is static per rig, chosen
at trace time by host code.

Parameter layout (``params``, last axis):
* pinhole: ``[fx, fy, cx, cy]`` (+ ignored tail, so an 8-vector is fine)
* kb8 equidistant fisheye: ``[fx, fy, cx, cy, k0, k1, k2, k3]``
  (reference: src/CameraModels/KannalaBrandt8.h — 8 parameters)
* radtan distortion (used only for keypoint undistortion, like the
  reference's cv::undistortPoints path): ``[k1, k2, p1, p2]``

All functions broadcast over leading batch dims. Projections return pixel
coordinates ``[..., 2]``; unprojections return **unit bearing vectors**
``[..., 3]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PINHOLE = 0
KB8 = 1

_EPS = 1e-8


# ---------------------------------------------------------------------------
# Pinhole
# ---------------------------------------------------------------------------

def pinhole_project(params: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """[...,4+] params, [...,3] camera-frame points -> [...,2] pixels."""
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    z = p[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    u = fx * p[..., 0] * inv_z + cx
    v = fy * p[..., 1] * inv_z + cy
    return jnp.stack([u, v], axis=-1)


def pinhole_unproject(params: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """[...,2] pixels -> [...,3] unit bearing."""
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    ray = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    return ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)


def pinhole_project_jac(params: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """d(uv)/d(p): [..., 2, 3] (reference: Pinhole::projectJac)."""
    fx, fy = params[..., 0], params[..., 1]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    inv_z2 = inv_z * inv_z
    zero = jnp.zeros_like(x)
    row_u = jnp.stack([fx * inv_z, zero, -fx * x * inv_z2], axis=-1)
    row_v = jnp.stack([zero, fy * inv_z, -fy * y * inv_z2], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)


# ---------------------------------------------------------------------------
# Radial-tangential distortion (for keypoint undistortion a la the
# reference's Frame::UndistortKeyPoints via cv::undistortPoints)
# ---------------------------------------------------------------------------

def radtan_distort(dist: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Apply [k1,k2,p1,p2] distortion to normalized coords [..., 2]."""
    k1, k2, p1, p2 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def radtan_undistort(dist: jnp.ndarray, xy_d: jnp.ndarray,
                     iters: int = 8) -> jnp.ndarray:
    """Invert radtan by fixed-point iteration (static trip count)."""
    k1, k2, p1, p2 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return jnp.stack([x, y], axis=-1)


def undistort_pixels(params: jnp.ndarray, dist: jnp.ndarray,
                     uv: jnp.ndarray) -> jnp.ndarray:
    """Distorted pixels -> ideal-pinhole pixels with the same K."""
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    xy_d = jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)
    xy = radtan_undistort(dist, xy_d)
    return jnp.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], axis=-1)


# ---------------------------------------------------------------------------
# Kannala-Brandt 8 (equidistant fisheye)
# ---------------------------------------------------------------------------

def _kb8_theta_d(k: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[..., 0] + t2 * (
        k[..., 1] + t2 * (k[..., 2] + t2 * k[..., 3]))))


def _kb8_theta_d_prime(k: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    t2 = theta * theta
    return 1.0 + t2 * (3 * k[..., 0] + t2 * (
        5 * k[..., 1] + t2 * (7 * k[..., 2] + t2 * 9 * k[..., 3])))


def kb8_project(params: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """[...,8] params, [...,3] camera points -> [...,2] pixels.

    (reference: KannalaBrandt8::project, src/CameraModels/KannalaBrandt8.cpp)
    """
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    k = params[..., 4:8]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(jnp.maximum(r2, _EPS * _EPS))
    theta = jnp.arctan2(r, z)
    theta_d = _kb8_theta_d(k, theta)
    # s = theta_d / r, with the on-axis limit theta_d/r -> 1/z (z>0).
    on_axis = r2 < _EPS
    s = jnp.where(on_axis,
                  1.0 / jnp.where(jnp.abs(z) < _EPS, _EPS, z),
                  theta_d / r)
    return jnp.stack([fx * s * x + cx, fy * s * y + cy], axis=-1)


def kb8_unproject(params: jnp.ndarray, uv: jnp.ndarray,
                  iters: int = 10) -> jnp.ndarray:
    """[...,2] pixels -> [...,3] unit bearing via Newton on theta.

    (reference: KannalaBrandt8::unprojectEig — Newton to precision 1e-6)
    """
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    k = params[..., 4:8]
    wx = (uv[..., 0] - cx) / fx
    wy = (uv[..., 1] - cy) / fy
    theta_d = jnp.sqrt(wx * wx + wy * wy)
    theta = theta_d  # good init for small distortion
    for _ in range(iters):
        f = _kb8_theta_d(k, theta) - theta_d
        fp = _kb8_theta_d_prime(k, theta)
        theta = theta - f / jnp.where(jnp.abs(fp) < _EPS, _EPS, fp)
    theta = jnp.clip(theta, 0.0, jnp.pi)
    scale = jnp.where(theta_d < _EPS, jnp.ones_like(theta_d),
                      jnp.sin(theta) / jnp.maximum(theta_d, _EPS))
    ray = jnp.stack([wx * scale, wy * scale, jnp.cos(theta)], axis=-1)
    return ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)


def kb8_project_jac(params: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Analytic d(uv)/d(p): [..., 2, 3].

    (reference: KannalaBrandt8::projectJac)
    """
    fx, fy = params[..., 0], params[..., 1]
    k = params[..., 4:8]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(jnp.maximum(r2, _EPS * _EPS))
    rho2 = r2 + z * z
    theta = jnp.arctan2(r, z)
    theta_d = _kb8_theta_d(k, theta)
    dtd = _kb8_theta_d_prime(k, theta)

    # d(theta)/d(x,y,z)
    dth_dx = z * x / (rho2 * r)
    dth_dy = z * y / (rho2 * r)
    dth_dz = -r / rho2
    # d(x/r), d(y/r)
    inv_r3 = 1.0 / (r * r2)
    dxr_dx = y * y * inv_r3
    dxr_dy = -x * y * inv_r3
    dyr_dy = x * x * inv_r3
    dyr_dx = dxr_dy

    xr = x / r
    yr = y / r
    du_dx = fx * (dtd * dth_dx * xr + theta_d * dxr_dx)
    du_dy = fx * (dtd * dth_dy * xr + theta_d * dxr_dy)
    du_dz = fx * (dtd * dth_dz * xr)
    dv_dx = fy * (dtd * dth_dx * yr + theta_d * dyr_dx)
    dv_dy = fy * (dtd * dth_dy * yr + theta_d * dyr_dy)
    dv_dz = fy * (dtd * dth_dz * yr)

    jac = jnp.stack(
        [jnp.stack([du_dx, du_dy, du_dz], axis=-1),
         jnp.stack([dv_dx, dv_dy, dv_dz], axis=-1)], axis=-2)

    # On-axis fallback: behaves like a pinhole with focal f * (theta_d'/...)
    on_axis = (r2 < _EPS)[..., None, None]
    pin = pinhole_project_jac(params, p)
    return jnp.where(on_axis, pin, jac)


# ---------------------------------------------------------------------------
# Generic dispatch (kind is a static Python int)
# ---------------------------------------------------------------------------

def project(kind: int, params: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    if kind == PINHOLE:
        return pinhole_project(params, p)
    if kind == KB8:
        return kb8_project(params, p)
    raise ValueError(f"unknown camera kind {kind}")


def unproject(kind: int, params: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    if kind == PINHOLE:
        return pinhole_unproject(params, uv)
    if kind == KB8:
        return kb8_unproject(params, uv)
    raise ValueError(f"unknown camera kind {kind}")


def project_jac(kind: int, params: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    if kind == PINHOLE:
        return pinhole_project_jac(params, p)
    if kind == KB8:
        return kb8_project_jac(params, p)
    raise ValueError(f"unknown camera kind {kind}")
