"""C++ native kernels agree with the JAX implementations (golden cross-check)."""
import numpy as np
import jax.numpy as jnp
import pytest

native = pytest.importorskip("native")

from matlab_code_tpu.ops.tv import prox_tv as jax_prox_tv
from matlab_code_tpu.ops.isotonic import project_monotone, project_unimodal
from matlab_code_tpu.ops.prox import project_simplex_cols

rng = np.random.default_rng(11)


def test_tv_matches_jax():
    for n in (7, 20, 51):
        y = rng.standard_normal(n)
        for lam in (0.05, 0.4, 3.0):
            c = native.tv_denoise(y, lam)
            j = np.asarray(jax_prox_tv(jnp.asarray(y)[:, None], lam))[:, 0]
            np.testing.assert_allclose(c, j, atol=1e-10)


def test_tv_cols():
    Y = rng.standard_normal((25, 4))
    C = native.prox_tv(Y, 0.3)
    J = np.asarray(jax_prox_tv(jnp.asarray(Y), 0.3))
    np.testing.assert_allclose(C, J, atol=1e-10)


def test_isotonic_matches_jax():
    for n in (5, 17, 40):
        y = rng.standard_normal(n)
        c = native.isotonic(y)
        j = np.asarray(project_monotone(jnp.asarray(y)[:, None], True))[:, 0]
        np.testing.assert_allclose(c, j, atol=1e-10)
        c = native.isotonic(y, increasing=False)
        j = np.asarray(project_monotone(jnp.asarray(y)[:, None], False))[:, 0]
        np.testing.assert_allclose(c, j, atol=1e-10)


def test_unimodal_matches_jax():
    for n in (6, 15, 33):
        for nonneg in (False, True):
            y = rng.standard_normal(n)
            c = native.unimodal(y, nonneg)
            j = np.asarray(project_unimodal(jnp.asarray(y)[:, None],
                                            nonneg))[:, 0]
            np.testing.assert_allclose(c, j, atol=1e-10)


def test_simplex_matches_jax():
    y = rng.standard_normal(12)
    c = native.simplex_project(y, 1.0)
    j = np.asarray(project_simplex_cols(jnp.asarray(y)[:, None], 1.0))[:, 0]
    np.testing.assert_allclose(c, j, atol=1e-10)


def test_lbfgsb_native_quadratic():
    n = 15
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n)

    def fun(x):
        return 0.5 * x @ A @ x - b @ x, A @ x - b

    x, its = native.lbfgsb(fun, np.zeros(n), 0.0, np.inf, maxiter=300,
                           pgtol=1e-10, factr=10.0)
    from scipy.optimize import minimize
    want = minimize(lambda v: 0.5 * v @ A @ v - b @ v, np.zeros(n),
                    jac=lambda v: A @ v - b, method="L-BFGS-B",
                    bounds=[(0, None)] * n,
                    options={"ftol": 1e-16, "gtol": 1e-12}).x
    np.testing.assert_allclose(x, want, atol=1e-6)


def test_matlab_randn_cross_validation_independent_cpp():
    """The randn rejection paths, cross-validated
    against the INDEPENDENT C++ reconstruction in native/kernels.cc
    (sequential Matsumoto-Nishimura mt19937ar vs the Python module's
    vectorized twist; runtime long-double-solved ziggurat table vs the
    embedded 60-digit hex table; same MATLAB-Coder-emitted accept/reject
    structure).

    (a) The independently solved x-table reproduces the 60-digit table:
        >= 254 of 256 entries bit-identical, the rest within 1 ulp (the
        long-double bisection's accuracy boundary), and both derived
        constants (v/f(r), 1/r) bit-identical.
    (b) On the shared validated table, the two stream implementations
        agree BIT-EXACTLY over 1e7 draws — including 147,083 edge-wedge
        and 2,664 tail rejection events, each of which consumes extra
        uniforms, so a single bookkeeping slip would desync everything
        after it.  Repeated at two more seeds.
    (c) With each side using its OWN table, accept/reject decisions still
        agree everywhere (identical event counts, no desync) and values
        match to table-rounding noise (<= 4e-16 relative).
    This certifies the two reconstructions are consistent to the last bit;
    fidelity of the rejection paths to MATLAB itself remains bounded by
    the absence of published anchors (docs/PARITY.md)."""
    from matlab_code_tpu.utils.matlab_rng import MatlabRNG, _zig_tables
    from matlab_code_tpu.utils import matlab_rng as M

    W, A, _ = _zig_tables()
    xs_py = np.concatenate([A[:255], [A[255]]])
    # (a) table agreement
    xs_c, w255_c, invr_c = native.matlab_zig_table()
    assert int((xs_c == xs_py).sum()) >= 254
    np.testing.assert_array_equal(
        np.abs(xs_c - xs_py) <= np.spacing(xs_py), True)
    assert w255_c == W[255]
    assert invr_c == M._ZIG_INV_R
    # rand core: bit equality of genrand_res53 streams
    np.testing.assert_array_equal(native.matlab_rand_oracle(50000),
                                  MatlabRNG("default").rand(50000))
    # (b) shared-table bit-exact stream, 1e7 draws
    N = 10_000_000
    vc, counts = native.matlab_randn_oracle_with_table(
        N, xs_py, W[255], M._ZIG_INV_R)
    r = MatlabRNG("default")
    vp = r.randn(N)
    np.testing.assert_array_equal(vc, vp)
    assert counts == (r.slowpath_edge, r.slowpath_tail) == (147083, 2664)
    for s in (0, 42):
        vc, cc = native.matlab_randn_oracle_with_table(
            200000, xs_py, W[255], M._ZIG_INV_R, seed=s)
        rr = MatlabRNG(s)
        np.testing.assert_array_equal(vc, rr.randn(200000))
        assert cc == (rr.slowpath_edge, rr.slowpath_tail)
    # (c) independent-table stream: same decisions, values to rounding
    vi, ci = native.matlab_randn_oracle(1_000_000)
    assert ci == (14648, 270)
    np.testing.assert_allclose(vi, vp[:1_000_000], rtol=5e-16, atol=0)
