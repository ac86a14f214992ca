"""Model-quality statistics (r2/mae/mse, standard errors, t- and p-values).

Batched equivalent of the reference's src/statistics.rs: residual metrics
over the fitted rows (:15-35) and ridge-aware feature metrics (:76-156):
``sigma^2 = RSS / df`` with ``df = n - trace((XtX+lI)^-1)`` when l > 0 else
``n - p``, ``se = sqrt(sigma^2 |diag|)``, ``t = beta/se`` and two-sided
p-values from the Student-t CDF. When the Cholesky inversion of XtX + lI
fails the feature metrics are NaN (:101-111).
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp

from .linalg import t_two_sided_p_value

F64 = jnp.float64


@jax.jit
def residual_metrics(
    y: jnp.ndarray,  # [G, R] fit targets (excluded rows zeroed)
    preds: jnp.ndarray,  # [G, R] predictions on fit rows
    w: jnp.ndarray,  # [G, R] bool fit mask
) -> Dict[str, jnp.ndarray]:
    wf = w.astype(F64)
    n = wf.sum(axis=1)
    n_safe = jnp.maximum(n, 1.0)
    err = (y - preds) * wf
    mean = (y * wf).sum(axis=1) / n_safe
    sse = (err * err).sum(axis=1)
    sae = jnp.abs(err).sum(axis=1)
    sst = (wf * (y - mean[:, None]) ** 2).sum(axis=1)
    return {
        "mse": sse / n_safe,
        "mae": sae / n_safe,
        "r2": 1.0 - sse / sst,
        "rss": sse,
    }


def feature_metrics(XtX, Xty, rss, n, alpha, ridge=None) -> Dict[str, jnp.ndarray]:
    """RSS must come from *per-row* residuals (as the reference does,
    src/statistics.rs:119-123): the moment identity yty - 2b'Xty + b'XtXb
    cancels catastrophically for good fits (can report mse=0 or negative).

    ``alpha`` is a traced operand (one compiled program serves every ridge
    strength); ``ridge`` selects the degrees-of-freedom formula (n - trace
    vs n - p, reference statistics.rs:124-128), which is structural — it
    defaults from ``alpha`` here, OUTSIDE the jit boundary, so inference
    works whenever alpha is a concrete Python number (callers inside a
    trace must pass ridge explicitly)."""
    if ridge is None:
        ridge = bool(alpha > 0.0)  # raises if alpha is a tracer: pass ridge
    return _feature_metrics_jit(XtX, Xty, rss, n, alpha, ridge=ridge)


@partial(jax.jit, static_argnames=("ridge",))
def _feature_metrics_jit(
    XtX: jnp.ndarray,  # [G, K, K]
    Xty: jnp.ndarray,  # [G, K]
    rss: jnp.ndarray,  # [G] residual sum of squares over the fitted rows
    n: jnp.ndarray,  # [G] valid-row counts
    alpha: float,
    ridge: bool,
) -> Dict[str, jnp.ndarray]:
    G, k, _ = XtX.shape
    A = XtX + alpha * jnp.eye(k, dtype=F64)
    if k <= 32:
        # the vectorized elementwise Cholesky inverse (custom calls don't
        # partition under SPMD)
        from .linalg import _chol_solve_vectorized

        A_inv, ok = _chol_solve_vectorized(
            A, jnp.broadcast_to(jnp.eye(k, dtype=F64), A.shape)
        )
        A_inv = jnp.where(ok[:, None, None], A_inv, jnp.eye(k, dtype=F64))
    else:
        L = jnp.linalg.cholesky(A)
        ok = jnp.isfinite(L).all(axis=(-2, -1))
        L_safe = jnp.where(ok[:, None, None], L, jnp.eye(k, dtype=F64))
        A_inv = jax.scipy.linalg.cho_solve(
            (L_safe, True), jnp.broadcast_to(jnp.eye(k, dtype=F64), A.shape)
        )
    beta = jnp.einsum("gkl,gl->gk", A_inv, Xty, preferred_element_type=F64)
    if ridge:
        df = n - jnp.trace(A_inv, axis1=-2, axis2=-1)
    else:
        df = n - float(k)
    sigma2 = rss / df
    diag = jnp.diagonal(A_inv, axis1=-2, axis2=-1)
    se = jnp.sqrt(sigma2[:, None] * jnp.abs(diag))
    t = beta / se
    p = t_two_sided_p_value(t, df[:, None])
    nanify = lambda a: jnp.where(ok[:, None] if a.ndim == 2 else ok, a, jnp.nan)
    return {
        "coefficients": nanify(beta),
        "standard_errors": nanify(se),
        "t_values": nanify(t),
        "p_values": nanify(p),
    }
