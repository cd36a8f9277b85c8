import numpy as np
import jax.numpy as jnp

from matlab_code_tpu.ops import linalg as LA

rng = np.random.default_rng(7)


def _spd(n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def test_solve_with_chol():
    B = _spd(4)
    A = rng.standard_normal((9, 4))
    L = np.asarray(LA.chol_lower(jnp.asarray(B)))
    got = np.asarray(LA.solve_with_chol(jnp.asarray(L), jnp.asarray(A)))
    np.testing.assert_allclose(got, A @ np.linalg.inv(B), rtol=1e-9)


def test_solve_with_chol_batched():
    import jax
    Bs = np.stack([_spd(3) for _ in range(5)])
    As = rng.standard_normal((5, 7, 3))
    Ls = np.asarray(LA.chol_lower(jnp.asarray(Bs)))
    got = np.asarray(jax.vmap(LA.solve_with_chol)(jnp.asarray(Ls), jnp.asarray(As)))
    for k in range(5):
        np.testing.assert_allclose(got[k], As[k] @ np.linalg.inv(Bs[k]), rtol=1e-8)


def test_spd_inverse_from_chol():
    """B^{-1} from the Cholesky factor (the 'inverse' inner-solve mode),
    single and batched: A @ Binv must equal the triangular-solve solution."""
    B = _spd(4)
    L = np.asarray(LA.chol_lower(jnp.asarray(B)))
    Binv = np.asarray(LA.spd_inverse_from_chol(jnp.asarray(L)))
    np.testing.assert_allclose(Binv, np.linalg.inv(B), rtol=1e-9, atol=1e-12)
    Bs = np.stack([_spd(3) for _ in range(5)])
    Ls = np.asarray(LA.chol_lower(jnp.asarray(Bs)))
    Binvs = np.asarray(LA.spd_inverse_from_chol(jnp.asarray(Ls)))
    As = rng.standard_normal((5, 7, 3))
    via_chol = np.asarray(LA.solve_with_chol(jnp.asarray(Ls), jnp.asarray(As)))
    np.testing.assert_allclose(As @ Binvs, via_chol, rtol=1e-8, atol=1e-11)


def test_sylvester_sym():
    B2 = _spd(6)
    B = _spd(3)
    C = rng.standard_normal((6, 3))
    X = np.asarray(LA.sylvester_sym(jnp.asarray(B2), jnp.asarray(B), jnp.asarray(C)))
    np.testing.assert_allclose(B2 @ X + X @ B, C, rtol=1e-8, atol=1e-10)


def test_polar():
    M = rng.standard_normal((10, 3))
    Q = np.asarray(LA.polar_orth(jnp.asarray(M)))
    np.testing.assert_allclose(Q.T @ Q, np.eye(3), atol=1e-10)
    # polar factor maximizes tr(Q^T M) over orthonormal Q
    U, s, Vt = np.linalg.svd(M, full_matrices=False)
    np.testing.assert_allclose(np.trace(Q.T @ M), s.sum(), rtol=1e-10)


def test_polar_preserves_zero_rows():
    M = rng.standard_normal((8, 3))
    M[5:] = 0.0
    Q = np.asarray(LA.polar_orth(jnp.asarray(M)))
    np.testing.assert_allclose(Q[5:], 0.0, atol=1e-10)


def test_top_eigvecs():
    Y = _spd(8)
    V = np.asarray(LA.top_eigvecs(jnp.asarray(Y), 3))
    w, Vfull = np.linalg.eigh(Y)
    span_want = Vfull[:, -3:]
    # same subspace
    proj = span_want @ span_want.T
    np.testing.assert_allclose(proj @ V, V, atol=1e-8)


def test_block_diag():
    mats = rng.standard_normal((3, 2, 2))
    got = np.asarray(LA.block_diag(jnp.asarray(mats)))
    import scipy.linalg
    want = scipy.linalg.block_diag(*mats)
    np.testing.assert_allclose(got, want)


def test_lbfgsb_quadratic_box():
    from matlab_code_tpu.ops.lbfgsb import lbfgsb
    import jax
    n = 20
    A = _spd(n)
    b = rng.standard_normal(n)

    def f(x):
        return 0.5 * x @ (A @ x) - b @ x

    vag = jax.value_and_grad(f)
    res = lbfgsb(vag, jnp.zeros(n), 0.0, jnp.inf, m=5, maxiter=200,
                 pgtol=1e-10, factr=10.0)
    from scipy.optimize import minimize
    want = minimize(lambda x: 0.5 * x @ A @ x - b @ x, np.zeros(n),
                    jac=lambda x: A @ x - b, method="L-BFGS-B",
                    bounds=[(0, None)] * n,
                    options={"ftol": 1e-16, "gtol": 1e-12}).x
    np.testing.assert_allclose(np.asarray(res.x), want, atol=1e-6)


def test_lbfgsb_rosenbrock_box():
    from matlab_code_tpu.ops.lbfgsb import lbfgsb
    import jax

    def f(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    vag = jax.value_and_grad(f)
    res = lbfgsb(vag, jnp.zeros(4), -2.0, 2.0, m=8, maxiter=500,
                 pgtol=1e-10, factr=1.0)
    np.testing.assert_allclose(np.asarray(res.x), np.ones(4), atol=1e-4)


def test_spd_inverse_newton():
    """Matmul-only Newton-Hotelling inverse (inner_solve='newton')
    matches the Cholesky inverse; rcond estimate bounds the true rcond."""
    # single matrix, with and without the eigenvalue lower bound
    B = jnp.asarray(_spd(24))
    ref = np.linalg.inv(np.asarray(B))
    for lmin in (None, 24.0):
        X, rcond = LA.spd_inverse_newton(B, lmin=lmin)
        np.testing.assert_allclose(np.asarray(X), ref, rtol=5e-9, atol=5e-11)
    lam = np.linalg.eigvalsh(np.asarray(B))
    assert float(rcond) <= lam[0] / lam[-1] * 1.01
    assert float(rcond) > 0

    # K-batched with per-slice rho/2 bound (the PARAFAC2 Bk systems)
    K, R = 32, 16
    M = rng.standard_normal((K, R, R))
    C = np.einsum("krs,krt->kst", M, M) / R
    rho = np.trace(C, axis1=1, axis2=2) / R
    Bb = jnp.asarray(C + 0.5 * rho[:, None, None] * np.eye(R))
    Xb, rcondb = LA.spd_inverse_newton(Bb, lmin=jnp.asarray(0.5 * rho))
    refb = np.linalg.inv(np.asarray(Bb))
    np.testing.assert_allclose(np.asarray(Xb), refb, rtol=5e-8, atol=5e-10)
    assert rcondb.shape == (K,)


def test_polar_orth_ns_adaptive_zero_slice():
    """The adaptive NS polar exits early, keeps orthogonality to high
    accuracy, and maps an all-zero slice to zero (ragged padding)."""
    K, J, R = 5, 20, 4
    M = rng.standard_normal((K, J, R))
    M[3] = 0.0
    P = np.asarray(LA.polar_orth_ns(jnp.asarray(M), iters=40))
    ref = np.asarray(LA.polar_orth(jnp.asarray(M[:3])))
    np.testing.assert_allclose(P[:3], ref, rtol=1e-8, atol=1e-9)
    assert np.all(P[3] == 0)
    G = np.einsum("kjr,kjs->krs", P[[0, 1, 2, 4]], P[[0, 1, 2, 4]])
    np.testing.assert_allclose(G, np.broadcast_to(np.eye(R), G.shape),
                               atol=1e-10)
