"""Batched Lie-group operations for SO(3), SE(3) and Sim(3) in pure JAX.

This is the JAX replacement for the vendored Sophus headers of the
reference (reference: Thirdparty/Sophus/sophus/{so3,se3,sim3}.hpp) and for the
SO(3) Jacobian helpers in the IMU code (reference: src/ImuTypes.cc:14-56,
include/ImuTypes.h:254-260).

Conventions
-----------
* Rotations are 3x3 matrices with shape ``[..., 3, 3]``; tangent vectors live
  on the last axis.
* All ops broadcast over arbitrary leading batch dimensions and are safe to
  ``vmap``/``jit``/differentiate: every small-angle singularity has an exact
  Taylor branch selected with the "double-where" trick so neither branch
  produces NaN in the forward or backward pass.
* SE(3) tangent is ``[rho(3), omega(3)]`` (translation part first);
  Sim(3) tangent is ``[rho(3), omega(3), sigma(1)]``.
* Default dtype follows the inputs (float32 on the accelerator).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Angle below which Taylor branches are used. float32 epsilon is ~1.2e-7; at
# theta=1e-3 the truncation error of the 2-term Taylor series is ~1e-13,
# far below f32 resolution, while the closed forms start losing bits.
_SMALL = 1e-3


def _safe(x, eps=_SMALL):
    """Replace near-zero values by 1 so the non-Taylor branch never divides by 0."""
    return jnp.where(jnp.abs(x) < eps, jnp.ones_like(x), x)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_hat(w: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_vee(W: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> [..., 3]; inverse of :func:`so3_hat` (antisymmetrises)."""
    return jnp.stack(
        [
            0.5 * (W[..., 2, 1] - W[..., 1, 2]),
            0.5 * (W[..., 0, 2] - W[..., 2, 0]),
            0.5 * (W[..., 1, 0] - W[..., 0, 1]),
        ],
        axis=-1,
    )


def _theta(w: jnp.ndarray) -> jnp.ndarray:
    """|w| with a gradient-safe sqrt (returns [...])."""
    sq = jnp.sum(w * w, axis=-1)
    # sqrt has infinite gradient at 0; clamp inside, exact value outside.
    return jnp.sqrt(jnp.maximum(sq, 1e-24))


def _sin_coeffs(theta):
    """(sin t)/t and (1-cos t)/t^2 and (t - sin t)/t^3 with Taylor guards."""
    t2 = theta * theta
    safe_t = _safe(theta)
    small = theta < _SMALL
    a = jnp.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                  jnp.sin(safe_t) / safe_t)
    b = jnp.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                  (1.0 - jnp.cos(safe_t)) / (safe_t * safe_t))
    c = jnp.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                  (safe_t - jnp.sin(safe_t)) / (safe_t ** 3))
    return a, b, c


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: [..., 3] tangent -> [..., 3, 3] rotation."""
    theta = _theta(w)
    a, b, _ = _sin_coeffs(theta)
    W = so3_hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] rotation -> [..., 3] tangent. Robust near 0 and pi.

    theta comes from atan2 (differentiable everywhere), NOT arccos, whose
    infinite derivative at the identity poisons forward-mode autodiff
    through pose-graph residuals.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip(0.5 * (trace - 1.0), -1.0, 1.0)
    # vee((R - R^T)/2) = sin(theta) * axis
    v = so3_vee(R)
    n2 = jnp.sum(v * v, axis=-1)
    theta = jnp.arctan2(jnp.sqrt(n2 + 1e-24), cos_t)

    # Generic branch: w = theta / sin(theta) * v = theta/|v| * v, with a
    # Taylor fallback where |v| is tiny AND the angle is small (|v| is also
    # tiny near pi, but that region is overridden below).
    small = n2 < 1e-12
    safe_n = jnp.sqrt(jnp.where(small, 1.0, n2))
    scale = jnp.where(small, 1.0 + n2 / 6.0, theta / safe_n)
    w_generic = scale[..., None] * v

    # Large-angle branch: the generic formula divides by sin(theta) which loses
    # precision as theta -> pi. Use the exact identity
    #   (R + R^T)/2 - cos(theta) I = (1 - cos(theta)) a a^T
    # whose largest column is parallel to the axis for any theta, with f32
    # accuracy independent of sin(theta).
    M = 0.5 * (R + jnp.swapaxes(R, -1, -2)) - cos_t[..., None, None] * jnp.eye(
        3, dtype=R.dtype)
    col_norms = jnp.linalg.norm(M, axis=-2)  # [..., 3]
    best = jnp.argmax(col_norms, axis=-1)
    axis = jnp.take_along_axis(
        M, best[..., None, None].repeat(3, axis=-2), axis=-1)[..., 0]
    axis = axis / jnp.maximum(jnp.linalg.norm(axis, axis=-1, keepdims=True),
                              1e-12)
    # Fix the sign so it matches sin(theta)*axis = v when sin != 0; at exactly
    # pi the sign is arbitrary (w and -w are the same rotation).
    sign = jnp.where(jnp.sum(axis * v, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign

    near_pi = theta > 2.9
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """J_l(w) = I + (1-cos)/t^2 W + (t-sin)/t^3 W^2  (a.k.a. Gamma_1)."""
    theta = _theta(w)
    _, b, c = _sin_coeffs(theta)
    W = so3_hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def so3_right_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """J_r(w) = J_l(-w) (reference: src/ImuTypes.cc RightJacobianSO3)."""
    return so3_left_jacobian(-w)


def _inv_jac_coeff(theta):
    """Coefficient of W^2 in J_l^{-1}: 1/t^2 - (1+cos t)/(2 t sin t)."""
    small = theta < _SMALL
    t2 = theta * theta
    safe_t = _safe(theta)
    val = 1.0 / (safe_t * safe_t) - (1.0 + jnp.cos(safe_t)) / (
        2.0 * safe_t * _safe(jnp.sin(safe_t)))
    taylor = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
    return jnp.where(small, taylor, val)


def so3_left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    theta = _theta(w)
    e = _inv_jac_coeff(theta)
    W = so3_hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + e[..., None, None] * W2


def so3_right_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse right Jacobian (reference: src/ImuTypes.cc InverseRightJacobianSO3)."""
    return so3_left_jacobian_inv(-w)


def so3_gamma2(w: jnp.ndarray) -> jnp.ndarray:
    """Gamma_2(w) = 1/2 I + (t - sin t)/t^3 W + (t^2 + 2 cos t - 2)/(2 t^4) W^2.

    Second-order SE_2(3) Gamma function: the exact double integral of the
    rotation, used by the MAVIS closed-form pre-integration
    (reference: src/ImuTypes.cc:196-198 computes J2 = Gamma_2(w*dt) * dt^2
    with the dt factored into each term).
    """
    theta = _theta(w)
    _, _, c = _sin_coeffs(theta)
    small = theta < _SMALL
    t2 = theta * theta
    safe_t = _safe(theta)
    d = jnp.where(
        small,
        1.0 / 24.0 - t2 / 720.0 + t2 * t2 / 40320.0,
        (safe_t * safe_t + 2.0 * jnp.cos(safe_t) - 2.0) / (2.0 * safe_t ** 4),
    )
    W = so3_hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return 0.5 * eye + c[..., None, None] * W + d[..., None, None] * W2


def normalize_rotation(R: jnp.ndarray, iters: int = 3) -> jnp.ndarray:
    """Project a near-rotation onto SO(3) by Newton-Schulz iteration.

    Replaces the SVD-based NormalizeRotation of the reference
    (src/ImuTypes.cc:44-56) with a matmul-only polynomial iteration:
    R <- R (3I - R^T R)/2 converges quadratically for matrices near SO(3).
    """
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    for _ in range(iters):
        R = R @ (1.5 * eye - 0.5 * (jnp.swapaxes(R, -1, -2) @ R))
    return R


# ---------------------------------------------------------------------------
# SE(3)  — stored as (R [...,3,3], t [...,3])
# ---------------------------------------------------------------------------

def se3_exp(xi: jnp.ndarray):
    """[..., 6] tangent [rho, omega] -> (R, t)."""
    rho, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    t = jnp.einsum("...ij,...j->...i", so3_left_jacobian(w), rho)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R, t) -> [..., 6] tangent [rho, omega]."""
    w = so3_log(R)
    rho = jnp.einsum("...ij,...j->...i", so3_left_jacobian_inv(w), t)
    return jnp.concatenate([rho, w], axis=-1)


def se3_inverse(R: jnp.ndarray, t: jnp.ndarray):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): first apply b, then a."""
    return Ra @ Rb, jnp.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_apply(R, t, p):
    """Transform points p [..., 3]."""
    return jnp.einsum("...ij,...j->...i", R, p) + t


def se3_matrix(R, t):
    """(R, t) -> [..., 4, 4] homogeneous matrix."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4))
    top = jnp.concatenate(
        [jnp.broadcast_to(R, batch + (3, 3)),
         jnp.broadcast_to(t[..., None], batch + (3, 1))], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# Sim(3) — stored as (s [...], R [...,3,3], t [...,3])
# ---------------------------------------------------------------------------

def _sim3_W(w: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """W such that t = W rho in Sim(3) exp; W = int_0^1 e^{s u} exp(u w^) du.

    Closed form with four-way Taylor branching on (theta, sigma); validated in
    tests against numerical quadrature of the defining integral.
    """
    dtype = w.dtype
    theta = _theta(w)
    s = jnp.exp(sigma)
    W_ = so3_hat(w)
    W2 = W_ @ W_
    small_t = theta < _SMALL
    small_s = jnp.abs(sigma) < _SMALL
    safe_t = _safe(theta)
    safe_s = _safe(sigma)
    t2 = safe_t * safe_t

    # C = (e^sigma - 1)/sigma
    C = jnp.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                  (s - 1.0) / safe_s)

    # Branch values for A (coeff of W) and B (coeff of W^2)
    # sigma ~ 0:
    a_s0_t0 = 0.5 + sigma / 3.0                       # Taylor in sigma, theta->0
    b_s0_t0 = 1.0 / 6.0 + sigma / 8.0
    a_s0 = (1.0 - jnp.cos(safe_t)) / t2
    b_s0 = (safe_t - jnp.sin(safe_t)) / (t2 * safe_t)
    # sigma != 0, theta -> 0:
    s2 = safe_s * safe_s
    a_t0 = ((safe_s - 1.0) * s + 1.0) / s2
    b_t0 = (s * (0.5 * s2 - safe_s + 1.0) - 1.0) / (s2 * safe_s)
    # generic:
    a_sin = s * jnp.sin(safe_t)
    b_cos = s * jnp.cos(safe_t)
    c2 = t2 + s2
    A_gen = (a_sin * safe_s + (1.0 - b_cos) * safe_t) / (safe_t * c2)
    B_gen = (C - ((b_cos - 1.0) * safe_s + a_sin * safe_t) / c2) / t2

    A = jnp.where(small_s, jnp.where(small_t, a_s0_t0, a_s0),
                  jnp.where(small_t, a_t0, A_gen))
    B = jnp.where(small_s, jnp.where(small_t, b_s0_t0, b_s0),
                  jnp.where(small_t, b_t0, B_gen))

    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), W_.shape)
    return C[..., None, None] * eye + A[..., None, None] * W_ + B[..., None, None] * W2


def sim3_exp(xi: jnp.ndarray):
    """[..., 7] tangent [rho, omega, sigma] -> (s, R, t)."""
    rho, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(w)
    t = jnp.einsum("...ij,...j->...i", _sim3_W(w, sigma), rho)
    return s, R, t


def sim3_log(s: jnp.ndarray, R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(s, R, t) -> [..., 7] tangent [rho, omega, sigma]."""
    sigma = jnp.log(s)
    w = so3_log(R)
    W = _sim3_W(w, sigma)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, w, sigma[..., None]], axis=-1)


def sim3_inverse(s, R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t)


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) * (sb,Rb,tb): p -> sa Ra (sb Rb p + tb) + ta."""
    return (sa * sb, Ra @ Rb,
            sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb) + ta)


def sim3_apply(s, R, t, p):
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, p) + t


# ---------------------------------------------------------------------------
# Quaternion helpers (wxyz), for compact pose storage / checkpointing
# ---------------------------------------------------------------------------

def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [jnp.stack([r00, r01, r02], axis=-1),
         jnp.stack([r10, r11, r12], axis=-1),
         jnp.stack([r20, r21, r22], axis=-1)], axis=-2)


def rotmat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Shepperd's method, branch-free via where-select of 4 candidates."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # candidate 0: trace
    s0 = jnp.sqrt(jnp.maximum(tr + 1.0, 1e-12)) * 2
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                    (m10 - m01) / s0], axis=-1)
    s1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                    (m02 + m20) / s1], axis=-1)
    s2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-12)) * 2
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                    (m12 + m21) / s2], axis=-1)
    s3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-12)) * 2
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                    0.25 * s3], axis=-1)

    # pick the numerically best candidate
    scores = jnp.stack([tr, m00, m11, m22], axis=-1)
    best = jnp.argmax(scores, axis=-1)
    q = jnp.where((best == 0)[..., None], q0,
                  jnp.where((best == 1)[..., None], q1,
                            jnp.where((best == 2)[..., None], q2, q3)))
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)
