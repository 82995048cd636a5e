"""Generic dense Levenberg-Marquardt driver under `lax.while_loop`.

JAX replacement for g2o's OptimizationAlgorithmLevenberg
(reference: Thirdparty/g2o/g2o/core/optimization_algorithm_levenberg.cpp,
used by every Optimizer::* entry point, src/Optimizer.cc). The solver state
is a pytree `x`; problems provide
  * assemble(x)  -> (H [D, D], g [D], chi2 scalar)  — normal equations,
  * retract(x, dx [D]) -> x                         — manifold update,
  * chi2(x) -> scalar                               — cost at a candidate,
and the driver runs damped steps with accept/reject lambda control, fully
jit-compatible (fixed iteration budget, no recompiles).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


def damped_solve(H: jnp.ndarray, g: jnp.ndarray, lam: jnp.ndarray,
                 eps: float = 1e-10) -> jnp.ndarray:
    """Solve (H + lam * diag(H)) dx = -g (Marquardt scaling).

    Uses Cholesky; falls back to adding absolute jitter when diagonals
    vanish (unobserved parameters), which pins those coordinates near 0.
    """
    d = jnp.diagonal(H)
    damp = lam * jnp.maximum(d, eps) + eps
    Hd = H + jnp.diag(damp)
    L = jnp.linalg.cholesky(Hd)
    dx = jax.scipy.linalg.cho_solve((L, True), -g)
    # if the factorization failed (non-PSD after damping), take no step
    ok = jnp.all(jnp.isfinite(dx))
    return jnp.where(ok, dx, jnp.zeros_like(dx))


def lm_optimize(assemble: Callable, retract: Callable, chi2_fn: Callable,
                x0, max_iters: int = 10, lambda0: float = 1e-2,
                lambda_up: float = 4.0, lambda_down: float = 0.5,
                min_lambda: float = 1e-9, max_lambda: float = 1e6):
    """Run LM; returns (x, final_chi2, n_accepted).

    All callables must be jit-traceable with static shapes. `chi2_fn` is
    kept in the signature for API compatibility but the driver never calls
    it: one `assemble` per iteration supplies BOTH the candidate's chi2
    (accept test) and, on acceptance, the normal equations of the next
    iteration — halving the residual/Jacobian evaluations per step (the
    dominant cost of motion-only optimization).
    """
    del chi2_fn
    H0, g0, chi0 = assemble(x0)

    def body(state):
        x, H, g, lam, chi, it, n_acc = state
        dx = damped_solve(H, g, lam)
        x_new = retract(x, dx)
        H2, g2, chi_new = assemble(x_new)
        accept = chi_new < chi
        x = jax.tree.map(
            lambda a, b: jnp.where(accept, b, a), x, x_new)
        H = jnp.where(accept, H2, H)
        g = jnp.where(accept, g2, g)
        chi = jnp.where(accept, chi_new, chi)
        lam = jnp.clip(jnp.where(accept, lam * lambda_down, lam * lambda_up),
                       min_lambda, max_lambda)
        return x, H, g, lam, chi, it + 1, n_acc + accept.astype(jnp.int32)

    def cond(state):
        return state[5] < max_iters

    x, _, _, _, chi, _, n_acc = jax.lax.while_loop(
        cond, body, (x0, H0, g0, jnp.asarray(lambda0, jnp.float32), chi0,
                     jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32)))
    return x, chi, n_acc


def inv3x3(A: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / determinant).

    `jnp.linalg.inv` on [..., 3, 3] lowers to batched LU with pivoting —
    measured as a dominant cost of Schur preparation at Atlas scale
    (M=16k landmark blocks); the adjugate form is ~10 fused elementwise
    ops."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / jnp.where(jnp.abs(det) < eps,
                              jnp.where(det < 0, -eps, eps), det)
    adj = jnp.stack([
        jnp.stack([A11, A12, A13], axis=-1),
        jnp.stack([A21, A22, A23], axis=-1),
        jnp.stack([A31, A32, A33], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]
