"""SE2(3) exact IMU pre-integration as a `lax.scan`, batched over intervals.

JAX rebuild of the reference's `IMU::Preintegrated`
(reference: src/ImuTypes.cc:160-239 `IntegrateNewMeasurement`,
include/ImuTypes.h:212-251) including the MAVIS novelty: closed-form SE2(3)
Gamma-matrix integration (J1 = Jl(w dt) dt, J2 = Gamma2(w dt) dt^2) instead of
Euler steps, with the matching 15x15 covariance propagation and the five bias
Jacobians (JRg, JVg, JVa, JPg, JPa).

State-error ordering everywhere: [dphi(3), dv(3), dp(3), bg(3), ba(3)].
Bias vectors are ``[bg(3), ba(3)]`` (gyro first, matching the reference's
``db`` vector, src/ImuTypes.cc:269-274).

Design notes:
* one `lax.scan` over samples; padded samples use dt=0 which is an exact
  no-op of the recursion, so a fixed sample capacity needs no masks;
* `vmap(integrate)` re-integrates *every* inter-keyframe interval of a map
  in one batched kernel after a bias update (the reference replays raw
  measurement vectors serially per keyframe, src/ImuTypes.cc:152-158).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import lie

# numpy (not jnp) so importing the library never touches a device backend
GRAVITY = np.array([0.0, 0.0, -9.81], dtype=np.float32)


class ImuNoise(NamedTuple):
    """Discrete-time noise covariances.

    ``nga``: [6,6] measurement noise (gyro then acc), = diag(sigma^2 * freq)
    ``nga_walk``: [6,6] bias random walk, = diag(sigma_walk^2 / freq)
    (reference: IMU::Calib::Set, include/ImuTypes.h:105-128)
    """
    nga: jnp.ndarray
    nga_walk: jnp.ndarray

    @staticmethod
    def from_sigmas(sigma_g, sigma_a, walk_g, walk_a, freq):
        sf = float(freq)
        nga = jnp.diag(jnp.array(
            [sigma_g**2 * sf] * 3 + [sigma_a**2 * sf] * 3, dtype=jnp.float32))
        walk = jnp.diag(jnp.array(
            [walk_g**2 / sf] * 3 + [walk_a**2 / sf] * 3, dtype=jnp.float32))
        return ImuNoise(nga=nga, nga_walk=walk)


class Preintegrated(NamedTuple):
    """Pre-integrated IMU deltas between two frames/keyframes (a pytree)."""
    dR: jnp.ndarray     # [3,3]
    dV: jnp.ndarray     # [3]
    dP: jnp.ndarray     # [3]
    JRg: jnp.ndarray    # [3,3] d(dR)/d(bg)
    JVg: jnp.ndarray    # [3,3]
    JVa: jnp.ndarray    # [3,3]
    JPg: jnp.ndarray    # [3,3]
    JPa: jnp.ndarray    # [3,3]
    C: jnp.ndarray      # [15,15] covariance [phi, v, p, bg, ba]
    dT: jnp.ndarray     # [] total time
    b: jnp.ndarray      # [6] bias used for integration [bg, ba]
    avgA: jnp.ndarray   # [3] average body acceleration (bias-corrected)
    avgW: jnp.ndarray   # [3] average angular rate (bias-corrected)


def init_preintegrated(bias: jnp.ndarray, dtype=jnp.float32) -> Preintegrated:
    z3 = jnp.zeros((3, 3), dtype=dtype)
    return Preintegrated(
        dR=jnp.eye(3, dtype=dtype), dV=jnp.zeros(3, dtype=dtype),
        dP=jnp.zeros(3, dtype=dtype), JRg=z3, JVg=z3, JVa=z3, JPg=z3, JPa=z3,
        C=jnp.zeros((15, 15), dtype=dtype), dT=jnp.zeros((), dtype=dtype),
        b=bias.astype(dtype), avgA=jnp.zeros(3, dtype=dtype),
        avgW=jnp.zeros(3, dtype=dtype))


def _step(state: Preintegrated, sample, noise: ImuNoise) -> Preintegrated:
    """One IMU sample update (reference: src/ImuTypes.cc:160-239).

    dt == 0 is an exact no-op (phi=0 -> J1=J2=0, dRi=I, A=I, B=0), which is
    how padded samples are represented.
    """
    w, a, dt = sample
    bg, ba = state.b[:3], state.b[3:]
    acc = a - ba
    acc_w = w - bg

    # SE2(3) closed forms (MAVIS): J1 = Jl(phi) dt, J2 = Gamma2(phi) dt^2
    phi = acc_w * dt
    J1 = lie.so3_left_jacobian(phi) * dt
    J2 = lie.so3_gamma2(phi) * (dt * dt)

    dR_old = state.dR
    dP = state.dP + state.dV * dt + dR_old @ (J2 @ acc)
    dV = state.dV + dR_old @ (J1 @ acc)

    # running averages (reference: src/ImuTypes.cc:181-182)
    denom = jnp.where(state.dT + dt > 0, state.dT + dt, 1.0)
    avgA = (state.dT * state.avgA + dR_old @ acc * dt) / denom
    avgW = (state.dT * state.avgW + acc_w * dt) / denom

    # covariance propagation: C[0:9,0:9] = A C A^T + B Nga B^T with A 9x15
    # (reference: src/ImuTypes.cc:205-232)
    Wacc = lie.so3_hat(acc)
    dRi = lie.so3_exp(phi)
    Jr_dt = lie.so3_right_jacobian(phi) * dt
    dtype = dR_old.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    z3 = jnp.zeros((3, 3), dtype=dtype)

    A = jnp.block([
        [dRi.T,                      z3,        z3, -dt * eye3,          z3],
        [-dR_old @ lie.so3_hat(J1 @ acc), eye3, z3,  z3,        -dR_old @ J1],
        [-dR_old @ lie.so3_hat(J2 @ acc), dt * eye3, eye3, z3,  -dR_old @ J2],
    ])  # [9, 15]
    B = jnp.block([
        [Jr_dt,        z3],
        [z3, dR_old @ J1],
        [z3, dR_old @ J2],
    ])  # [9, 6]

    # The reference leaves the cross block C[0:9, 9:15] at zero: bias
    # variance feeds the 9x9 delta-state block only through A's bias columns
    # (src/ImuTypes.cc:231-232). Replicate that exactly — the optimizer reads
    # only the 9x9 (EdgeInertial information) and the 6x6 (bias RW edges).
    C = state.C
    top_left = A @ C @ A.T + B @ noise.nga @ B.T            # [9,9]
    bottom = C[9:, 9:] + dt * dt * noise.nga_walk            # [6,6]
    z96 = jnp.zeros((9, 6), dtype=dtype)
    C_new = jnp.block([
        [top_left, z96],
        [z96.T, bottom],
    ])

    # bias Jacobians, pre-rotation-update (reference: src/ImuTypes.cc:217-220)
    JPa = state.JPa + state.JVa * dt - dR_old @ J2
    JPg = state.JPg + state.JVg * dt - dR_old @ J2 @ Wacc @ state.JRg
    JVa = state.JVa - dR_old @ J1
    JVg = state.JVg - dR_old @ J1 @ Wacc @ state.JRg

    # rotation update (reference: src/ImuTypes.cc:222-235)
    dR = lie.normalize_rotation(dR_old @ dRi)
    JRg = dRi.T @ state.JRg - Jr_dt

    return Preintegrated(
        dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        C=C_new, dT=state.dT + dt, b=state.b, avgA=avgA, avgW=avgW)


def integrate(w: jnp.ndarray, a: jnp.ndarray, dts: jnp.ndarray,
              bias: jnp.ndarray, noise: ImuNoise) -> Preintegrated:
    """Integrate a fixed-capacity buffer of IMU samples.

    Args:
      w: [N, 3] gyro samples (rad/s); a: [N, 3] accelerometer samples (m/s^2);
      dts: [N] per-sample integration times — pad with zeros;
      bias: [6] = [bg, ba];
      noise: ImuNoise.
    """
    init = init_preintegrated(bias, dtype=w.dtype)

    def body(state, sample):
        return _step(state, sample, noise), None

    # rolled, on every backend: in one run on an H100 the flagship
    # per-frame program compiled 43 s faster rolled than fully unrolled
    # and ran no slower (PERF.md, PR 1); the host-policy trackers also
    # recompile this scan for every distinct IMU batch length, which
    # unrolled costs a full compile each time.
    out, _ = jax.lax.scan(body, init, (w, a, dts))
    return out


integrate_batch = jax.vmap(integrate, in_axes=(0, 0, 0, 0, None))


# ---------------------------------------------------------------------------
# Exact composition of consecutive preintegrations.
#
# The reference merges intervals by replaying the raw measurement cache
# (IMU::Preintegrated::MergePrevious, src/ImuTypes.cc:241-263). On device a
# closed-form composition is better: it is O(1) instead of O(samples), needs
# no raw-sample storage on device, and is what lets the streaming pipeline
# keep ONE running preintegration since the last keyframe and the map keep a
# per-keyframe chain that can be merged when keyframes are culled.
#
# Derivation: with b following a (same linearization bias),
#   dR_ab = dR_a dR_b
#   dV_ab = dV_a + dR_a dV_b
#   dP_ab = dP_a + dV_a dT_b + dR_a dP_b
# First-order bias Jacobians and the 15x15 covariance compose through the
# corresponding error-state transition F (a-part) and injection G (b-part);
# the bias-variance feed the standalone b-part missed (its C started at
# zero) re-enters through b's own bias Jacobians (H_b C_bb(a) H_b^T).
# ---------------------------------------------------------------------------

def compose(a: Preintegrated, b: Preintegrated) -> Preintegrated:
    """Compose two consecutive preintegrated intervals (a then b).

    Both must be linearized at the same bias (`a.b == b.b`); use
    `rebias` first if they differ. `init_preintegrated` is the identity
    element on either side.
    """
    dtype = a.dR.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    z3 = jnp.zeros((3, 3), dtype=dtype)
    dTb = b.dT

    dR = lie.normalize_rotation(a.dR @ b.dR)
    dV = a.dV + a.dR @ b.dV
    dP = a.dP + a.dV * dTb + a.dR @ b.dP

    hat_dVb = lie.so3_hat(b.dV)
    hat_dPb = lie.so3_hat(b.dP)

    JRg = b.dR.T @ a.JRg + b.JRg
    JVg = a.JVg + a.dR @ b.JVg - a.dR @ hat_dVb @ a.JRg
    JVa = a.JVa + a.dR @ b.JVa
    JPg = a.JPg + a.JVg * dTb + a.dR @ b.JPg - a.dR @ hat_dPb @ a.JRg
    JPa = a.JPa + a.JVa * dTb + a.dR @ b.JPa

    # covariance: [phi, v, p] block
    F = jnp.block([
        [b.dR.T,            z3,         z3],
        [-a.dR @ hat_dVb,   eye3,       z3],
        [-a.dR @ hat_dPb,   dTb * eye3, eye3],
    ])
    G = jnp.block([
        [eye3, z3,   z3],
        [z3,   a.dR, z3],
        [z3,   z3,   a.dR],
    ])
    # bias-variance feed through interval b (b's Jacobians ARE the
    # accumulated bias columns of its error-state transition)
    Hb = jnp.block([
        [b.JRg, z3],
        [b.JVg, b.JVa],
        [b.JPg, b.JPa],
    ])                                                    # [9, 6]
    C9a = a.C[:9, :9]
    C9b = b.C[:9, :9]
    Cbb_a = a.C[9:, 9:]
    top = F @ C9a @ F.T + G @ (C9b + Hb @ Cbb_a @ Hb.T) @ G.T
    bottom = Cbb_a + b.C[9:, 9:]
    z96 = jnp.zeros((9, 6), dtype=dtype)
    C = jnp.block([[top, z96], [z96.T, bottom]])

    dT = a.dT + b.dT
    denom = jnp.where(dT > 0, dT, 1.0)
    avgA = (a.dT * a.avgA + dTb * (a.dR @ b.avgA)) / denom
    avgW = (a.dT * a.avgW + dTb * b.avgW) / denom
    return Preintegrated(
        dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        C=C, dT=dT, b=a.b, avgA=avgA, avgW=avgW)


def rebias(pre: Preintegrated, new_bias: jnp.ndarray) -> Preintegrated:
    """Re-linearize a preintegration at `new_bias` (first order, via the
    stored Jacobians — the closed-form stand-in for the reference's
    `Reintegrate` measurement replay, src/ImuTypes.cc:152-158)."""
    return pre._replace(
        dR=delta_rotation(pre, new_bias),
        dV=delta_velocity(pre, new_bias),
        dP=delta_position(pre, new_bias),
        b=new_bias.astype(pre.b.dtype))


# ---------------------------------------------------------------------------
# Device-resident per-keyframe preintegration chain (batched Preintegrated
# with leading dim K; entry k covers the interval keyframe k-1 -> k).
# The reference stores this as KeyFrame::mpImuPreintegrated along the
# mPrevKF temporal chain (include/ImuTypes.h:212).
# ---------------------------------------------------------------------------

def chain_allocate(K: int, dtype=jnp.float32) -> Preintegrated:
    one = init_preintegrated(jnp.zeros(6, dtype), dtype=dtype)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (K,) + x.shape), one)


def chain_set(chain: Preintegrated, k, pre: Preintegrated) -> Preintegrated:
    return jax.tree.map(lambda c, x: c.at[k].set(x), chain, pre)


def chain_get(chain: Preintegrated, k) -> Preintegrated:
    return jax.tree.map(lambda c: c[k], chain)


# ---------------------------------------------------------------------------
# Bias-corrected deltas (first-order, via the stored Jacobians)
# (reference: src/ImuTypes.cc:288-324 GetDelta{Rotation,Velocity,Position})
# ---------------------------------------------------------------------------

def delta_rotation(pre: Preintegrated, new_bias: jnp.ndarray) -> jnp.ndarray:
    dbg = new_bias[..., :3] - pre.b[..., :3]
    corr = lie.so3_exp(jnp.einsum("...ij,...j->...i", pre.JRg, dbg))
    return lie.normalize_rotation(pre.dR @ corr)


def delta_velocity(pre: Preintegrated, new_bias: jnp.ndarray) -> jnp.ndarray:
    dbg = new_bias[..., :3] - pre.b[..., :3]
    dba = new_bias[..., 3:] - pre.b[..., 3:]
    return (pre.dV + jnp.einsum("...ij,...j->...i", pre.JVg, dbg)
            + jnp.einsum("...ij,...j->...i", pre.JVa, dba))


def delta_position(pre: Preintegrated, new_bias: jnp.ndarray) -> jnp.ndarray:
    dbg = new_bias[..., :3] - pre.b[..., :3]
    dba = new_bias[..., 3:] - pre.b[..., 3:]
    return (pre.dP + jnp.einsum("...ij,...j->...i", pre.JPg, dbg)
            + jnp.einsum("...ij,...j->...i", pre.JPa, dba))


def predict_state(R_wb, p_wb, v_w, pre: Preintegrated, bias: jnp.ndarray,
                  gravity: jnp.ndarray = GRAVITY):
    """Propagate a world-frame IMU state across the pre-integrated interval.

    (reference: Tracking::PredictStateIMU, src/Tracking.cc:1723-1779)
    Returns (R2, p2, v2).
    """
    t = pre.dT
    dR = delta_rotation(pre, bias)
    dV = delta_velocity(pre, bias)
    dP = delta_position(pre, bias)
    R2 = lie.normalize_rotation(R_wb @ dR)
    v2 = v_w + gravity * t + R_wb @ dV
    p2 = p_wb + v_w * t + 0.5 * gravity * t * t + R_wb @ dP
    return R2, p2, v2
