"""Exact 1-D total-variation proximal operator (Condat's direct algorithm).

JAX equivalent of the external TV_Condat_v2.m used by the reference's
prox_TV (functions/prox_TV.m:5-8).  The TV prox problem

    min_x 1/2 ||x - y||^2 + lam * sum_i |x[i+1] - x[i]|

is strictly convex, so its minimizer is unique: this implementation (Condat,
"A Direct Algorithm for 1D Total Variation Denoising", IEEE SPL 2013) matches
the reference output to floating-point tolerance.

Sequential state machine -> lax.while_loop with masked segment writes;
columns are vmapped.  Vectors are factor columns (short), so the O(n) scalar
loop with O(n) masked writes is negligible next to the MTTKRP.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def tv_denoise_vector(y: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Exact TV prox of a vector y with strength lam (lam >= 0)."""
    n = y.shape[0]
    dt = y.dtype
    lam = jnp.asarray(lam, dt)
    if n == 1:
        return y
    pos = jnp.arange(n)

    # state: (k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done)
    # indices are 1-based as in the paper; y[k] is read as y[k-1].
    init = (jnp.int32(1), jnp.int32(1), jnp.int32(1), jnp.int32(1),
            y[0] - lam, y[0] + lam, lam, -lam,
            jnp.zeros((n,), dt), jnp.bool_(True), jnp.bool_(False))

    def seg_write(x, lo, hi, val):
        # x[lo..hi] = val (1-based inclusive)
        return jnp.where((pos >= lo - 1) & (pos <= hi - 1), val, x)

    def body(s):
        k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done = s

        def at_end_fresh(s):
            k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done = s
            x = x.at[n - 1].set(vmin + umin)
            return (k, k0, km, kp, vmin, vmax, umin, umax, x, fresh,
                    jnp.bool_(True))

        def at_end(s):
            k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done = s

            def neg(s):
                k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done = s
                x = seg_write(x, k0, km, vmin)
                k_ = km + 1
                return (k_, k_, k_, kp, y[k_ - 1], vmax, lam,
                        y[k_ - 1] + lam - vmax, x, jnp.bool_(True), done)

            def pos_(s):
                k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done = s
                x = seg_write(x, k0, kp, vmax)
                k_ = kp + 1
                # vmin is left unchanged (paper step j)
                return (k_, k_, km, k_, vmin, y[k_ - 1],
                        y[k_ - 1] - lam - vmin, -lam, x, jnp.bool_(True), done)

            def fin(s):
                k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done = s
                denom = (k - k0 + 1).astype(dt)
                x = seg_write(x, k0, k, vmin + umin / denom)
                return (k, k0, km, kp, vmin, vmax, umin, umax, x, fresh,
                        jnp.bool_(True))

            return lax.cond(umin < 0, neg,
                            lambda s: lax.cond(umax > 0, pos_, fin, s), s)

        def interior(s):
            k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done = s
            ynext = y[k]  # y[k+1] 1-based

            def jump_down(s):
                k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done = s
                x = seg_write(x, k0, km, vmin)
                k_ = km + 1
                return (k_, k_, k_, k_, y[k_ - 1], y[k_ - 1] + 2 * lam,
                        lam, -lam, x, jnp.bool_(True), done)

            def jump_up(s):
                k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done = s
                x = seg_write(x, k0, kp, vmax)
                k_ = kp + 1
                return (k_, k_, k_, k_, y[k_ - 1] - 2 * lam, y[k_ - 1],
                        lam, -lam, x, jnp.bool_(True), done)

            def advance(s):
                k, k0, km, kp, vmin, vmax, umin, umax, x, fresh, done = s
                k_ = k + 1
                umin_ = umin + y[k_ - 1] - vmin
                umax_ = umax + y[k_ - 1] - vmax
                denom = (k_ - k0 + 1).astype(dt)
                hit_min = umin_ >= lam
                vmin_ = jnp.where(hit_min, vmin + (umin_ - lam) / denom, vmin)
                km_ = jnp.where(hit_min, k_, km)
                umin_ = jnp.where(hit_min, lam, umin_)
                hit_max = umax_ <= -lam
                vmax_ = jnp.where(hit_max, vmax + (umax_ + lam) / denom, vmax)
                kp_ = jnp.where(hit_max, k_, kp)
                umax_ = jnp.where(hit_max, -lam, umax_)
                return (k_, k0, km_, kp_, vmin_, vmax_, umin_, umax_, x,
                        jnp.bool_(False), done)

            return lax.cond(
                ynext + umin < vmin - lam, jump_down,
                lambda s: lax.cond(ynext + umax > vmax + lam, jump_up,
                                   advance, s), s)

        return lax.cond(
            k == n,
            lambda s: lax.cond(fresh, at_end_fresh, at_end, s),
            interior, s)

    out = lax.while_loop(lambda s: ~s[-1], body, init)[8]
    return jnp.where(lam > 0, out, y)


@jax.jit
def prox_tv(X: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Column-wise TV prox of a matrix (functions/prox_TV.m)."""
    return jax.vmap(lambda c: tv_denoise_vector(c, lam), in_axes=1, out_axes=1)(X)
