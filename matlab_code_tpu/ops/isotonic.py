"""Isotonic and unimodal regression (PAVA / prefix-isotonic), jit-compatible.

JAX re-implementation of the reference's unimodal projection
(functions/project_unimodal_vector.m, the Stout 2008 prefix-isotonic
algorithm) and of the `project_monotone` PAVA projection from the Proximity
Operator Repository (dispatched at constraints_to_prox.m:25-31).

The merge loop is inherently sequential, so it runs as a lax.fori_loop with a
nested lax.while_loop over fixed-size buffers; columns are vmapped.  The
vectors involved are factor-matrix columns (length = one tensor mode, typically
<= a few hundred), so this is latency- not throughput-bound and cheap relative
to the MTTKRP.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def _prefix_isotonic(y: jnp.ndarray, nonneg: bool):
    """Prefix isotonic regression scan (project_unimodal_vector.m:43-88).

    y: (n,).  Returns (level, idxr, err), each of length n+1 with slot 0 a
    sentinel; slot i (1..n) describes the isotonic fit of the prefix y[:i]:
    level[i] = mean of the final level set, idxr[i] = leftmost slot of that
    level set, err[i] = total squared error of the prefix fit.
    """
    n = y.shape[0]
    dt = y.dtype
    sumwy = jnp.concatenate([jnp.zeros((1,), dt), y])
    sumwy2 = jnp.concatenate([jnp.zeros((1,), dt), y * y])
    sumw = jnp.concatenate([jnp.zeros((1,), dt), jnp.ones((n,), dt)])
    cumsumwy2 = jnp.cumsum(sumwy2)
    level = jnp.full((n + 1,), -jnp.inf, dtype=dt)
    idxr = jnp.zeros((n + 1,), dtype=jnp.int32)
    err = jnp.zeros((n + 1,), dtype=dt)
    thresh = jnp.zeros((n + 1,), dtype=bool)

    def body(i, carry):
        sumwy, sumwy2, sumw, level, idxr, err, thresh = carry
        level = level.at[i].set(y[i - 1])
        idxr = idxr.at[i].set(i)

        def merge_cond(c):
            sumwy, sumwy2, sumw, level, idxr = c
            return level[i] <= level[idxr[i] - 1]

        def merge_body(c):
            sumwy, sumwy2, sumw, level, idxr = c
            merger = idxr[i] - 1
            sumwy = sumwy.at[i].add(sumwy[merger])
            sumwy2 = sumwy2.at[i].add(sumwy2[merger])
            sumw = sumw.at[i].add(sumw[merger])
            level = level.at[i].set(sumwy[i] / sumw[i])
            idxr = idxr.at[i].set(idxr[merger])
            return (sumwy, sumwy2, sumw, level, idxr)

        sumwy, sumwy2, sumw, level, idxr = lax.while_loop(
            merge_cond, merge_body, (sumwy, sumwy2, sumw, level, idxr))
        levelerror = sumwy2[i] - sumwy[i] ** 2 / sumw[i]
        if nonneg:
            is_neg = level[i] < 0
            thresh = thresh.at[i].set(is_neg)
            e = jnp.where(is_neg, cumsumwy2[i - 1], levelerror + err[idxr[i] - 1])
        else:
            e = levelerror + err[idxr[i] - 1]
        err = err.at[i].set(e)
        return (sumwy, sumwy2, sumw, level, idxr, err, thresh)

    carry = (sumwy, sumwy2, sumw, level, idxr, err, thresh)
    sumwy, sumwy2, sumw, level, idxr, err, thresh = lax.fori_loop(
        1, n + 1, body, carry)
    if nonneg:
        level = jnp.where(thresh, 0.0, level)
    return level, idxr, err


def _reconstruct(mode_idx: jnp.ndarray, level: jnp.ndarray, idxr: jnp.ndarray,
                 n: int) -> jnp.ndarray:
    """Rebuild the fitted vector for the prefix of length mode_idx by walking
    the level-set pointers (project_unimodal_vector.m:34-41).

    Returns a length-n buffer whose first mode_idx entries are the fit.
    """
    out = jnp.zeros((n,), dtype=level.dtype)
    pos = jnp.arange(n)

    def cond(c):
        idx, _ = c
        return idx >= 1

    def body(c):
        idx, out = c
        left = idxr[idx]  # leftmost slot of the level set ending at idx
        mask = (pos >= left - 1) & (pos <= idx - 1)
        out = jnp.where(mask, level[idx], out)
        return (left - 1, out)

    _, out = lax.while_loop(cond, body, (mode_idx, out))
    return out


def isotonic_vector(y: jnp.ndarray, increasing: bool = True) -> jnp.ndarray:
    """L2 isotonic regression of a vector (PAVA).  Equivalent of the Proximity
    Operator Repository's project_monotone (constraints_to_prox.m:25-28)."""
    x = y if increasing else -y
    n = x.shape[0]
    level, idxr, _ = _prefix_isotonic(x, nonneg=False)
    out = _reconstruct(jnp.asarray(n, jnp.int32), level, idxr, n)
    return out if increasing else -out


def unimodal_vector(y: jnp.ndarray, nonneg: bool) -> jnp.ndarray:
    """Unimodal (optionally nonnegative) L2 regression of a vector.

    Exact re-implementation of project_unimodal_vector.m (Stout 2008):
    prefix-isotonic scans from the left and from the flipped right, best peak
    index by minimum total error, reconstruction of both halves.
    """
    n = y.shape[0]
    lv_l, ir_l, err_l = _prefix_isotonic(y, nonneg)
    lv_r, ir_r, err_r = _prefix_isotonic(y[::-1], nonneg)
    # errs[i-1] = error_left(i) + error_right(n-i+1), i = 1..n; the reference
    # seeds with error_right(n) alone, but error_left(1) == 0 always, so the
    # seeded value equals errs[0] (project_unimodal_vector.m:21-32).
    i = jnp.arange(1, n + 1)
    errs = err_l[i] + err_r[n - i + 1]
    best_idx = jnp.argmin(errs).astype(jnp.int32) + 1  # first minimum, 1-based
    left = _reconstruct(best_idx, lv_l, ir_l, n)
    right = _reconstruct(n - best_idx, lv_r, ir_r, n)
    pos = jnp.arange(n)
    return jnp.where(pos < best_idx, left[pos], right[n - 1 - pos])


@partial(jax.jit, static_argnames=("increasing",))
def project_monotone(X: jnp.ndarray, increasing: bool = True) -> jnp.ndarray:
    """Column-wise monotone projection of a matrix."""
    return jax.vmap(lambda c: isotonic_vector(c, increasing), in_axes=1, out_axes=1)(X)


@partial(jax.jit, static_argnames=("nonneg",))
def project_unimodal(X: jnp.ndarray, nonneg: bool) -> jnp.ndarray:
    """Column-wise unimodal projection of a matrix (project_unimodal.m)."""
    return jax.vmap(lambda c: unimodal_vector(c, nonneg), in_axes=1, out_axes=1)(X)
