"""Per-op breakdown of the PARAFAC2 production workload (K=512, J=256,
I=256, R=32) on one GPU: batched Cholesky, inverse, Newton-Hotelling and
Newton-Schulz polar costs behind the inner_solve / par2_polar choices.

Every timing loops INSIDE one jit with a scalar feedback dependency, so
per-call dispatch does not enter it; best-of-3.  Run: `python
bench_par2_breakdown.py`.
"""
import time

import numpy as np
import jax
import jax.numpy as jnp

from matlab_code_tpu.ops.linalg import (
    chol_lower, spd_inverse_from_chol, polar_orth_ns)

K, I, J, R = 512, 256, 256, 32


def timed(fn, *args, reps=100):
    """fn(args..., reps) -> scalar; returns best-of-3 seconds per rep."""
    jfn = jax.jit(fn, static_argnames=("reps",))
    jax.block_until_ready(jfn(*args, reps=reps))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn(*args, reps=reps))
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def feed(x, s):
    return x + 1e-30 * s


def main():
    from matlab_code_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    d = jax.devices()[0]
    print(f"# device: {d.platform} {d.device_kind}", flush=True)
    rng = np.random.default_rng(0)
    dt = jnp.float32
    # SPD batch like the Bk normal matrices: w*C + rho/2 I
    M = rng.standard_normal((K, R, R)).astype(np.float32)
    C = np.einsum("krs,krt->kst", M, M) / R
    rho = np.trace(C, axis1=1, axis2=2) / R
    B = jnp.asarray(C + 0.5 * rho[:, None, None] * np.eye(R, dtype=np.float32),
                    dt)
    Bk_fac = jnp.asarray(rng.standard_normal((K, J, R)), dt)  # (K,J,R)
    A_rhs = jnp.asarray(rng.standard_normal((K, J, R)), dt)
    DB = jnp.asarray(rng.standard_normal((R, R)), dt)

    # 1. batched Cholesky
    def f_chol(B, reps):
        def body(i, c):
            B_, acc = c
            L = chol_lower(B_)
            s = jnp.sum(L)
            return (feed(B_, s), acc + s)
        return jax.lax.fori_loop(0, reps, body, (B, jnp.zeros((), dt)))[1]
    t = timed(f_chol, B)
    print(f"chol (512,32,32):            {t*1e6:8.1f} us")

    # 2. chol + inverse-from-chol (the current 'inverse'-mode per-outer cost)
    def f_inv(B, reps):
        def body(i, c):
            B_, acc = c
            Binv = spd_inverse_from_chol(chol_lower(B_))
            s = jnp.sum(Binv)
            return (feed(B_, s), acc + s)
        return jax.lax.fori_loop(0, reps, body, (B, jnp.zeros((), dt)))[1]
    t = timed(f_inv, B)
    print(f"chol+inverse_from_chol:      {t*1e6:8.1f} us")

    # 3. batched (512,32,32)@(512,32,32) matmul
    def f_mm(B, reps):
        def body(i, c):
            X, acc = c
            Y = B @ X
            s = jnp.sum(Y)
            return (feed(X, s), acc + s)
        return jax.lax.fori_loop(0, reps, body, (B, jnp.zeros((), dt)))[1]
    t = timed(f_mm, B)
    print(f"batched matmul 32x32:        {t*1e6:8.1f} us")

    # 4. Newton-Hotelling inverse, fixed 14 iters (2 matmuls/iter)
    def newton_inv(B_, lmin, iters):
        ninf = jnp.max(jnp.sum(jnp.abs(B_), axis=-1), axis=-1)
        c = 2.0 / (ninf + lmin)
        eye = jnp.eye(R, dtype=B_.dtype)
        X = c[:, None, None] * eye
        for _ in range(iters):
            X = X @ (2.0 * eye - B_ @ X)
        return X

    for it in (10, 14, 18):
        def f_newt(B, reps, it=it):
            lmin = 0.5 * jnp.trace(B, axis1=1, axis2=2) / R  # rho/2 bound
            def body(i, c):
                B_, acc = c
                X = newton_inv(B_, lmin, it)
                s = jnp.sum(X)
                return (feed(B_, s), acc + s)
            return jax.lax.fori_loop(0, reps, body, (B, jnp.zeros((), dt)))[1]
        t = timed(f_newt, B)
        print(f"newton inverse {it:2d} iters:     {t*1e6:8.1f} us")

    # accuracy of newton vs chol-inverse
    lmin = 0.5 * jnp.trace(B, axis1=1, axis2=2) / R
    Xn = newton_inv(B, lmin, 14)
    Xc = spd_inverse_from_chol(chol_lower(B))
    err = float(jnp.max(jnp.abs(Xn - Xc)) / jnp.max(jnp.abs(Xc)))
    res = float(jnp.max(jnp.abs(
        Xn @ B - jnp.eye(R, dtype=dt)[None])))
    print(f"newton14 vs chol-inv rel err {err:.2e};  ||XB-I||inf {res:.2e}")

    # 5. NS polar, 40 iters on (512,256,32)
    def f_pol(Bk, reps):
        def body(i, c):
            X, acc = c
            P = polar_orth_ns(X @ DB.T, iters=40)
            s = jnp.sum(P)
            return (feed(X, s), acc + s)
        return jax.lax.fori_loop(0, reps, body, (Bk_fac, jnp.zeros((), dt)))[1]
    t = timed(f_pol, Bk_fac, reps=20)
    print(f"NS polar 40it (512,256,32):  {t*1e6:8.1f} us")

    # 6. warm small-polar: P = Q polar(Q^T M), small NS on (512,32,32)
    def warm_polar(Q, Mmat, small_iters):
        S = jnp.einsum("kjr,kjs->krs", Q, Mmat)          # Q^T M
        Ps = polar_orth_ns(S, iters=small_iters)
        P = jnp.einsum("kjr,krs->kjs", Q, Ps)
        # one big NS step to kill orthogonality drift
        return 1.5 * P - 0.5 * P @ (jnp.einsum("kjr,kjs->krs", P, P))

    for it in (12, 20):
        def f_wpol(Bk, reps, it=it):
            Q0 = polar_orth_ns(Bk @ DB.T, iters=40)
            def body(i, c):
                Q, acc = c
                P = warm_polar(Q, Bk @ DB.T, it)
                s = jnp.sum(P)
                return (feed(P, s), acc + s)
            return jax.lax.fori_loop(0, reps, body, (Q0, jnp.zeros((), dt)))[1]
        t = timed(f_wpol, Bk_fac, reps=20)
        print(f"warm polar small{it:2d}:          {t*1e6:8.1f} us")

    # accuracy: warm polar vs direct NS (after one step from a converged Q)
    Mm = Bk_fac @ DB.T
    Qd = polar_orth_ns(Mm, iters=40)
    Qw = warm_polar(Qd, Mm, 20)
    print(f"warm-vs-direct max|dP| {float(jnp.max(jnp.abs(Qw - Qd))):.2e}; "
          f"orth defect direct "
          f"{float(jnp.max(jnp.abs(jnp.einsum('kjr,kjs->krs', Qd, Qd) - jnp.eye(R)))):.2e} "
          f"warm {float(jnp.max(jnp.abs(jnp.einsum('kjr,kjs->krs', Qw, Qw) - jnp.eye(R)))):.2e}")

    # 7. the per-inner-iter solve matmul (512,256,32)@(512,32,32)
    def f_solve(A, Binv, reps):
        def body(i, c):
            X, acc = c
            Y = X @ Binv
            s = jnp.sum(Y)
            return (feed(X, s), acc + s)
        return jax.lax.fori_loop(0, reps, body, (A, jnp.zeros((), dt)))[1]
    t = timed(f_solve, A_rhs, Xc)
    print(f"solve matmul (512,256,32):   {t*1e6:8.1f} us")

    # 8. full outer step at MaxInnerIters 1 vs 5 (from bench_large workload)
    import bench_large as bl
    from matlab_code_tpu.options import AlgOptions
    for mii in (1, 5):
        spec, data, state, opts = bl.par2_problem()
        opts = AlgOptions(MaxOuterIters=10, MaxInnerIters=mii)
        it_s = bl.run_iters(spec, data, state, opts, 100)
        print(f"full outer it/s (inner={mii}):  {it_s:8.1f}")


if __name__ == "__main__":
    main()
