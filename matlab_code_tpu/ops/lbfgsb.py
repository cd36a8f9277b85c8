"""Box-constrained limited-memory BFGS, jit-compatible.

JAX replacement for the external L-BFGS-B-C MEX solver the reference
calls for KL / IS / beta-divergence subproblems (cmtf_fun_AOADMM.m:1409-1418,
options at example_script7:64-69).  Runs entirely under jit as a
lax.while_loop: fixed-size (m, n) curvature history, two-loop recursion,
gradient projection onto the box, and a projected-Armijo backtracking line
search.  The subproblems here are smooth and strongly convex near the ADMM
fixed point, where this scheme converges to the same minimizers as the
reference's Byrd-Lu-Nocedal implementation (iterate paths may differ).

Options mirror the reference's lbfgsb_options: m (history), maxIts, pgtol,
factr (relative f-change stop, scaled by eps like the original).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

_LS_MAX_STEPS = 60


class LbfgsbResult(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    iterations: jnp.ndarray


def lbfgsb(value_and_grad: Callable, x0: jnp.ndarray,
           lower: jnp.ndarray | float, upper: jnp.ndarray | float,
           m: int = 5, maxiter: int = 100,
           pgtol: float = 1e-5, factr: float = 1e7,
           max_total_its: int = 0) -> LbfgsbResult:
    """Minimize fun over the box [lower, upper] starting from x0 (1-D).

    max_total_its > 0 also caps the TOTAL number of function evaluations
    (outer iterations + line-search backtracks), the reference's
    lbfgsb_options.maxTotalIts (example_script7:64-69, the L-BFGS-B-C
    wrapper's cumulative-iteration budget)."""
    n = x0.shape[0]
    dt = x0.dtype
    eps = jnp.finfo(dt).eps
    lo = jnp.broadcast_to(jnp.asarray(lower, dt), (n,))
    hi = jnp.broadcast_to(jnp.asarray(upper, dt), (n,))

    def proj(x):
        return jnp.clip(x, lo, hi)

    x0 = proj(x0)
    f0, g0 = value_and_grad(x0)

    S = jnp.zeros((m, n), dt)
    Y = jnp.zeros((m, n), dt)
    rho_h = jnp.zeros((m,), dt)

    def pg_norm(x, g):
        return jnp.max(jnp.abs(x - proj(x - g)))

    def two_loop(g, S, Y, rho_h, k):
        """Two-loop recursion over the (up to m) most recent pairs.
        Slot (k-1) % m is the most recent."""
        q = g

        def bwd(i, carry):
            q, alpha = carry
            slot = jnp.mod(k - 1 - i, m)
            valid = i < jnp.minimum(k, m)
            a = jnp.where(valid, rho_h[slot] * jnp.dot(S[slot], q), 0.0)
            q = q - a * Y[slot]
            alpha = alpha.at[slot].set(a)
            return (q, alpha)

        q, alpha = lax.fori_loop(0, m, bwd, (q, jnp.zeros((m,), dt)))
        slot_last = jnp.mod(k - 1, m)
        sy = jnp.dot(S[slot_last], Y[slot_last])
        yy = jnp.dot(Y[slot_last], Y[slot_last])
        gamma = jnp.where((k > 0) & (yy > 0), sy / yy, 1.0)
        r = gamma * q

        def fwd(i, r):
            slot = jnp.mod(k - jnp.minimum(k, m) + i, m)
            valid = i < jnp.minimum(k, m)
            b = jnp.where(valid, rho_h[slot] * jnp.dot(Y[slot], r), 0.0)
            return r + jnp.where(valid, (alpha[slot] - b), 0.0) * S[slot]

        return lax.fori_loop(0, m, fwd, r)

    def line_search(x, f, g, d, alpha0):
        """Projected backtracking: find alpha with Armijo decrease on
        x_a = proj(x + alpha d)."""
        def cond(c):
            alpha, x_new, f_new, g_new, ls_it, done = c
            return (~done) & (ls_it < _LS_MAX_STEPS)

        def body(c):
            alpha, x_new, f_new, g_new, ls_it, done = c
            x_try = proj(x + alpha * d)
            f_try, g_try = value_and_grad(x_try)
            dec = jnp.dot(g, x_try - x)
            ok = f_try <= f + 1e-4 * dec
            # also accept any strict decrease on the last backtrack
            last = ls_it == _LS_MAX_STEPS - 1
            ok = ok | (last & (f_try < f))
            return (jnp.where(ok, alpha, alpha * 0.5),
                    jnp.where(ok, x_try, x_new),
                    jnp.where(ok, f_try, f_new),
                    jnp.where(ok, g_try, g_new),
                    ls_it + 1, ok)

        init = (alpha0, x, f, g, jnp.int32(0), jnp.bool_(False))
        _, x_new, f_new, g_new, ls_evals, ok = lax.while_loop(cond, body, init)
        return x_new, f_new, g_new, ok, ls_evals

    def cond(state):
        x, f, g, S, Y, rho_h, k, it, tot, done = state
        under_total = (tot < max_total_its) if max_total_its > 0 else True
        return (~done) & (it < maxiter) & under_total

    def body(state):
        x, f, g, S, Y, rho_h, k, it, tot, done = state
        # active-set restriction: variables pinned at a bound with the gradient
        # pushing outward are frozen; the quasi-Newton direction is built on
        # the free subspace (the gradient-projection idea of Byrd-Lu-Nocedal).
        tol_b = 1e-10
        active = ((x <= lo + tol_b) & (g > 0)) | ((x >= hi - tol_b) & (g < 0))
        gf = jnp.where(active, 0.0, g)
        d = -two_loop(gf, S, Y, rho_h, k)
        d = jnp.where(active, 0.0, d)
        # safeguard: fall back to projected steepest descent if not a descent
        # direction on the free subspace
        desc = jnp.dot(gf, d)
        d = jnp.where(desc < 0, d, -gf)
        # first step (no curvature info yet) is normalized to unit length —
        # otherwise steep losses (KL with near-zero model entries) would need
        # more backtracking than any fixed budget covers
        dnorm = jnp.linalg.norm(d)
        alpha0 = jnp.where(k == 0,
                           jnp.minimum(1.0, 1.0 / jnp.maximum(dnorm, 1e-30)),
                           jnp.asarray(1.0, dt)).astype(dt)
        x_new, f_new, g_new, ok, ls_evals = line_search(x, f, g, d, alpha0)
        s = x_new - x
        yv = g_new - g
        sy = jnp.dot(s, yv)
        good_pair = sy > eps * jnp.linalg.norm(s) * jnp.linalg.norm(yv)
        slot = jnp.mod(k, m)
        S = jnp.where(good_pair, S.at[slot].set(s), S)
        Y = jnp.where(good_pair, Y.at[slot].set(yv), Y)
        rho_h = jnp.where(good_pair,
                          rho_h.at[slot].set(1.0 / jnp.where(sy == 0, 1.0, sy)),
                          rho_h)
        k = jnp.where(good_pair, k + 1, k)
        # stopping: projected-gradient norm, relative f change, stalled search
        small_pg = pg_norm(x_new, g_new) <= pgtol
        small_df = (f - f_new) <= factr * eps * jnp.maximum(
            jnp.maximum(jnp.abs(f), jnp.abs(f_new)), 1.0)
        done = small_pg | small_df | (~ok)
        return (x_new, f_new, g_new, S, Y, rho_h, k, it + 1, tot + ls_evals,
                done)

    init = (x0, f0, g0, S, Y, rho_h, jnp.int32(0), jnp.int32(0),
            jnp.int32(1), pg_norm(x0, g0) <= pgtol)
    x, f, g, S, Y, rho_h, k, it, tot, done = lax.while_loop(cond, body, init)
    return LbfgsbResult(x=x, f=f, iterations=it)
