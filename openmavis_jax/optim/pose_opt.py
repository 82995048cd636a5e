"""Motion-only pose optimization (visual and visual-inertial).

JAX replacement for:
* Optimizer::PoseOptimization (reference: src/Optimizer.cc:855) — one body
  pose against matched map points across all camera bands, 4 rounds x 10 LM
  iterations with chi2 outlier re-gating between rounds;
* Optimizer::PoseInertialOptimizationLastKeyFrame / LastFrame
  (src/Optimizer.cc:5021/5580) — full 15-dof inertial state of the current
  frame, with the preintegration edge to the anchor frame (whose state is
  fixed) and an optional 15-dim marginalization prior.

Observations come in fixed-capacity padded arrays with validity masks.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie
from . import inertial as inertial_mod
from . import lm as lm_mod
from . import robust
from .reprojection import RigParams, mono_residual_jac


class PoseState(NamedTuple):
    R: jnp.ndarray   # [3,3]
    t: jnp.ndarray   # [3]


def _visual_terms(R, t, p_w, cam_idx, uv, sigma2, active, rig):
    o = p_w.shape[0]
    Rb = jnp.broadcast_to(R, (o, 3, 3))
    tb = jnp.broadcast_to(t, (o, 3))
    r, Jp, _, depth = mono_residual_jac(Rb, tb, p_w, cam_idx, uv, rig)
    info = 1.0 / sigma2
    chi2 = jnp.sum(r * r, axis=-1) * info
    w = robust.huber_weight(chi2, robust.CHI2_2D) * info
    w = jnp.where(active & (depth > 0), w, 0.0)
    return r, Jp, w, chi2


def pose_optimization(R0, t0, p_w, cam_idx, uv, sigma2, valid,
                      rig: RigParams, rounds: int = 4,
                      iters_per_round: int = 7,
                      chi2_th: float = robust.CHI2_2D):
    """Motion-only PO with chi2 re-gating (reference: Optimizer.cc:855).

    Args:
      R0, t0: initial body pose (world-from-body).
      p_w [O,3], cam_idx [O], uv [O,2], sigma2 [O], valid [O]: matched
        map-point observations (padded).
    Returns (R, t, inlier [O] bool, n_inliers).
    """
    inlier = valid

    def one_round(carry, _):
        R, t, inlier = carry

        def assemble(x):
            r, Jp, w, _ = _visual_terms(x.R, x.t, p_w, cam_idx, uv, sigma2,
                                        inlier, rig)
            H = jnp.einsum("oai,o,oaj->ij", Jp, w, Jp)
            g = jnp.einsum("oai,o,oa->i", Jp, w, r)
            chi = jnp.sum(w * jnp.sum(r * r, axis=-1))
            return H, g, chi

        def chi2_fn(x):
            r, _, w, _ = _visual_terms(x.R, x.t, p_w, cam_idx, uv, sigma2,
                                       inlier, rig)
            return jnp.sum(w * jnp.sum(r * r, axis=-1))

        def retract(x, dx):
            # normalize_rotation: ~40 multiplicative updates per call and
            # many calls per trajectory — without re-projection onto SO(3)
            # the accumulated drift breaks downstream triangulation
            return PoseState(R=lie.normalize_rotation(
                x.R @ lie.so3_exp(dx[:3])),
                t=x.t + x.R @ dx[3:6])

        x, _, _ = lm_mod.lm_optimize(assemble, retract, chi2_fn,
                                     PoseState(R, t),
                                     max_iters=iters_per_round)
        # re-gate outliers for the next round (outliers may return, like the
        # reference toggling setLevel(0/1) per round)
        _, _, _, chi2 = _visual_terms(x.R, x.t, p_w, cam_idx, uv, sigma2,
                                      valid, rig)
        inlier = valid & (chi2 < chi2_th)
        return (x.R, x.t, inlier), None

    (R, t, inlier), _ = jax.lax.scan(one_round, (R0, t0, inlier), None,
                                     length=rounds)
    return R, t, inlier, jnp.sum(inlier.astype(jnp.int32))


class InertialState(NamedTuple):
    R: jnp.ndarray   # [3,3]
    p: jnp.ndarray   # [3]
    v: jnp.ndarray   # [3]
    bg: jnp.ndarray  # [3]
    ba: jnp.ndarray  # [3]


def _vi_retract(x: InertialState, dx: jnp.ndarray) -> InertialState:
    return InertialState(
        R=lie.normalize_rotation(x.R @ lie.so3_exp(dx[0:3])),
        p=x.p + x.R @ dx[3:6],
        v=x.v + dx[6:9],
        bg=x.bg + dx[9:12],
        ba=x.ba + dx[12:15])


def pose_inertial_optimization(
        state0: InertialState, anchor: InertialState, pre,
        p_w, cam_idx, uv, sigma2, valid, rig: RigParams,
        prior: inertial_mod.PoseImuPrior | None = None,
        rounds: int = 4, iters_per_round: int = 7,
        chi2_th: float = robust.CHI2_2D):
    """VI motion-only optimization of the current frame's 15-dof state.

    The anchor frame (last KF or last frame) is FIXED; the preintegration
    edge `pre` connects anchor -> current. Optionally a 15-dim prior on the
    current state (marginalization of the previous frame, reference:
    ConstraintPoseImu).
    (reference: Optimizer.cc:5021 PoseInertialOptimizationLastKeyFrame,
     5580 ...LastFrame)
    Returns (state, inlier mask, n_inliers).
    """
    info9 = inertial_mod.inertial_information(pre)
    info_g, info_a = inertial_mod.bias_rw_information(pre)
    inlier = valid

    def terms(x: InertialState, active):
        o = p_w.shape[0]
        Rb = jnp.broadcast_to(x.R, (o, 3, 3))
        tb = jnp.broadcast_to(x.p, (o, 3))
        r, Jp6, _, depth = mono_residual_jac(Rb, tb, p_w, cam_idx, uv, rig)
        infov = 1.0 / sigma2
        chi2 = jnp.sum(r * r, axis=-1) * infov
        w = robust.huber_weight(chi2, robust.CHI2_2D) * infov
        w = jnp.where(active & (depth > 0), w, 0.0)
        return r, Jp6, w, chi2

    def assemble_with(active):
        def assemble(x: InertialState):
            r, Jp6, w, _ = terms(x, active)
            # visual block: pose columns only [w, rho] -> pad to 15
            Hv6 = jnp.einsum("oai,o,oaj->ij", Jp6, w, Jp6)
            gv6 = jnp.einsum("oai,o,oa->i", Jp6, w, r)
            H = jnp.zeros((15, 15), r.dtype).at[:6, :6].set(Hv6)
            g = jnp.zeros((15,), r.dtype).at[:6].set(gv6)
            chi = jnp.sum(w * jnp.sum(r * r, axis=-1))

            # inertial edge anchor(FIXED) -> current: only J2 (current) used
            ri, _, J2 = inertial_mod.inertial_residual_jac(
                anchor.R, anchor.p, anchor.v, anchor.bg, anchor.ba,
                x.R, x.p, x.v, pre)
            # J2 is [9,9] over current [w, rho, dv]; embed into 15
            J2e = jnp.zeros((9, 15), r.dtype).at[:, :9].set(J2)
            H = H + J2e.T @ info9 @ J2e
            g = g + J2e.T @ (info9 @ ri)
            chi = chi + ri @ (info9 @ ri)

            # bias random-walk edges anchor.b (fixed) -> current.b
            rg = x.bg - anchor.bg
            ra = x.ba - anchor.ba
            H = H.at[9:12, 9:12].add(info_g)
            H = H.at[12:15, 12:15].add(info_a)
            g = g.at[9:12].add(info_g @ rg)
            g = g.at[12:15].add(info_a @ ra)
            chi = chi + rg @ (info_g @ rg) + ra @ (info_a @ ra)

            if prior is not None:
                rp, Jp15 = inertial_mod.prior_residual_jac(
                    x.R, x.p, x.v, x.bg, x.ba, prior)
                H = H + Jp15.T @ prior.H @ Jp15
                g = g + Jp15.T @ (prior.H @ rp)
                chi = chi + rp @ (prior.H @ rp)
            return H, g, chi

        def chi2_fn(x: InertialState):
            _, _, chi = assemble(x)
            return chi
        return assemble, chi2_fn

    def one_round(carry, _):
        x, inlier = carry
        assemble, chi2_fn = assemble_with(inlier)
        x, _, _ = lm_mod.lm_optimize(assemble, _vi_retract, chi2_fn, x,
                                     max_iters=iters_per_round)
        _, _, _, chi2 = terms(x, valid)
        inlier = valid & (chi2 < chi2_th)
        return (x, inlier), None

    (x, inlier), _ = jax.lax.scan(one_round, (state0, inlier), None,
                                  length=rounds)
    return x, inlier, jnp.sum(inlier.astype(jnp.int32))
