"""Backend-dependent choices: the 'auto' resolver, the one sparse MTTKRP,
the compile-cache rule, and chip_smoke.py's CPU behaviour and parity
comparison."""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from matlab_code_tpu.options import AUTO_CHOICES, AlgOptions, resolve_auto
from matlab_code_tpu.ops.tensor import mttkrp, mttkrp_sparse
from matlab_code_tpu.problem import SparseTensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(300, 257, 129), (64, 64, 64),
                                   (1000, 40, 40)])
def test_mttkrp_sparse_matches_dense(shape):
    """The gather/segment-sum MTTKRP equals the dense einsum on the same
    tensor, in every mode, through both entry points."""
    rng = np.random.default_rng(3)
    idx = np.unique((rng.integers(0, 1 << 30, size=(20000, 3))
                     % np.asarray(shape)).astype(np.int32), axis=0)
    val = rng.standard_normal(len(idx))
    dense = np.zeros(shape)
    dense[tuple(idx.T)] = val
    facs = [jnp.asarray(rng.standard_normal((d, 7))) for d in shape]
    X = SparseTensor(jnp.asarray(idx), jnp.asarray(val))
    for m in range(3):
        want = np.asarray(mttkrp(jnp.asarray(dense), facs, m))
        got = mttkrp_sparse(X.indices, X.values, facs, m, shape[m])
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10,
                                   atol=1e-11)
        np.testing.assert_allclose(np.asarray(mttkrp(X, facs, m)), want,
                                   rtol=1e-10, atol=1e-11)


def _spd(n, batch=()):
    rng = np.random.default_rng(n)
    M = rng.standard_normal(batch + (n, n))
    return np.swapaxes(M, -1, -2) @ M + n * np.eye(n)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_auto_choices(backend):
    """'auto' resolves to the backend's table entry; the resolved inner
    solve is exact on a single and on a K-batched system, and the resolved
    polar method gives the orthonormal polar factor."""
    from matlab_code_tpu.models.admm import make_spd_solver
    from matlab_code_tpu.ops.linalg import polar_orth, polar_orth_ns
    o = resolve_auto(AlgOptions(), backend)
    assert o.inner_solve == AUTO_CHOICES[backend]["inner_solve"]
    assert o.par2_polar == AUTO_CHOICES[backend]["par2_polar"]
    assert o.inner_solve in ("chol", "inverse", "newton")
    assert o.par2_polar in ("svd", "ns")
    if backend == "cpu":    # the bit-exact reference-parity path
        assert (o.inner_solve, o.par2_polar) == ("chol", "svd")
    rng = np.random.default_rng(0)
    for B in (_spd(6), _spd(6, (4,))):       # single and K-batched
        A = rng.standard_normal(B.shape[:-2] + (9, 6))
        right, rowleft, _ = make_spd_solver(jnp.asarray(B), o)
        want = np.linalg.solve(B, np.swapaxes(A, -1, -2))
        np.testing.assert_allclose(np.asarray(right(jnp.asarray(A))),
                                   np.swapaxes(want, -1, -2), rtol=1e-9)
    a = rng.standard_normal((4, 6))
    want = np.linalg.solve(_spd(6, (4,)), a[..., None])[..., 0]
    np.testing.assert_allclose(
        np.asarray(make_spd_solver(jnp.asarray(_spd(6, (4,))), o)[1](
            jnp.asarray(a))), want, rtol=1e-9)
    M = jnp.asarray(rng.standard_normal((3, 10, 4)))
    P = polar_orth(M) if o.par2_polar == "svd" else polar_orth_ns(M)
    np.testing.assert_allclose(np.asarray(P), np.asarray(polar_orth(M)),
                               atol=1e-9)


def test_auto_unknown_backend_raises():
    with pytest.raises(ValueError, match="no 'auto' choices for backend"):
        resolve_auto(AlgOptions(), "rocm")


def test_explicit_choices_are_kept_and_auto_must_resolve():
    o = AlgOptions(inner_solve="newton", par2_polar="ns")
    for backend in AUTO_CHOICES:
        assert resolve_auto(o, backend) == o
    from matlab_code_tpu.models.admm import make_spd_solver
    with pytest.raises(ValueError, match="not resolved"):
        make_spd_solver(jnp.eye(3), AlgOptions())


@pytest.mark.parametrize("env_dir", [None, "cache_from_env"])
def test_compile_cache_dir(env_dir, monkeypatch, tmp_path):
    """$JAX_COMPILATION_CACHE_DIR wins; otherwise <checkout>/.jax_cache."""
    from matlab_code_tpu.utils import compile_cache as cc
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert cc.compile_cache_dir() == want
    old = jax.config.jax_compilation_cache_dir
    try:
        assert cc.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def _small_type4():
    import __graft_entry__ as ge
    spec, data, state = ge._type4_problem(2)
    Hs = [data.coupl_trafo[m] for m in (0, 3, 6)]
    return spec, data, state, Hs, AlgOptions()


def _small_par2():
    from matlab_code_tpu import (ProblemSpec, DatasetSpec, CouplingSpec,
                                 ConstraintSpec, InitOptions)
    from matlab_code_tpu.models.init import init_coupled
    from matlab_code_tpu.utils.datagen import (create_coupled_data,
                                               normalize_data)
    NN = ConstraintSpec("non-negativity")
    spec = ProblemSpec(
        mode_sizes=(7, (9,) * 4, 4),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, None, NN))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.05,
        distr=["rand", "randn", "rand+0.1"], rng=6)
    data, _ = normalize_data(spec, data)
    state = init_coupled(spec, data, InitOptions(
        distr=("rand", "randn", "rand+0.1"), normalize=True,
        lambdas_init=((1, 1),)), key=5)
    return spec, data, state, AlgOptions()


@pytest.mark.parametrize("which", ["flagship", "par2"])
def test_chip_smoke_parity_against_oracle(which):
    """chip_smoke's parity comparison, on small problems in float64 on the
    CPU: the solver and the numpy oracle agree to rounding."""
    sys.path.insert(0, REPO)
    import chip_smoke
    if which == "flagship":
        dev = chip_smoke.flagship_parity(*_small_type4())
    else:
        dev = chip_smoke.par2_parity(*_small_par2())
    assert set(dev) == {"factors", "objective"}
    assert max(dev.values()) < 1e-9, dev
