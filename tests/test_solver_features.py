"""End-to-end coverage of remaining solver features: every constraint kind in
a full fit, nvecs init, bsum regularization, ridge, custom prox, display."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions, cmtf_aoadmm)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import fit
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data


def _cp_problem(constraint, distr0="rand", ridge=None):
    spec = ProblemSpec(
        mode_sizes=(12, 10, 11),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(constraint, None, None), ridge=ridge)
    data, Atrue, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.0, distr=[distr0, "randn", "randn"],
        rng=5)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=(distr0 if isinstance(distr0, str) else "rand",
                              "randn", "randn"),
                       normalize=True, lambdas_init=((1, 1),))
    return spec, data, init


ALL_CONSTRAINTS = [
    ConstraintSpec("non-negativity"),
    ConstraintSpec("box", (0.0, 1.0)),
    ConstraintSpec("simplex column-wise", (1.0,)),
    ConstraintSpec("simplex row-wise", (1.0,)),
    ConstraintSpec("non-decreasing"),
    ConstraintSpec("non-increasing"),
    ConstraintSpec("unimodality", (True,)),
    ConstraintSpec("l1-ball", (2.0,)),
    ConstraintSpec("l2-ball", (1.0,)),
    ConstraintSpec("non-negative l2-ball", (1.0,)),
    ConstraintSpec("non-negative l2-sphere", (1.0,)),
    ConstraintSpec("orthonormal"),
    ConstraintSpec("l1 regularization", (1e-3,)),
    ConstraintSpec("l0 regularization", (1e-4,)),
    ConstraintSpec("l2 regularization", (1e-3,)),
    ConstraintSpec("ridge", (1e-3,)),
    ConstraintSpec("GL smoothness", (1e-2,)),
    ConstraintSpec("TV regularization", (1e-3,)),
]


@pytest.mark.parametrize("con", ALL_CONSTRAINTS,
                         ids=[c.kind for c in ALL_CONSTRAINTS])
def test_every_constraint_in_full_fit(con):
    spec, data, init = _cp_problem(con)
    opts = AlgOptions(MaxOuterIters=60, AbsFuncTol=1e-9, OuterRelTol=1e-8)
    state0 = init_coupled(spec, data, init, key=2)
    state, out = fit(spec, data, state0, opts)
    assert np.isfinite(out.f_tensors)
    assert out.func_val_conv[-1] <= out.func_val_conv[0]


def test_custom_constraint():
    myprox = lambda x, rho: jnp.clip(x, 0.0, None)
    myreg = lambda x: 0.0 * jnp.sum(x)
    spec, data, init = _cp_problem(
        ConstraintSpec("custom", fns=(myprox, myreg)))
    opts = AlgOptions(MaxOuterIters=80, AbsFuncTol=1e-10, OuterRelTol=1e-9)
    state0 = init_coupled(spec, data, init, key=2)
    state, out = fit(spec, data, state0, opts)
    assert out.f_tensors < 1e-6
    assert float(jnp.min(state.constraint_fac[0])) >= 0.0


def test_nvecs_init():
    spec, data, init = _cp_problem(None)
    import dataclasses
    init = dataclasses.replace(init, nvecs=True)
    state0 = init_coupled(spec, data, init, key=2)
    opts = AlgOptions(MaxOuterIters=200, AbsFuncTol=1e-12, OuterRelTol=1e-11)
    state, out = fit(spec, data, state0, opts)
    # spectral init on noiseless data converges fast and deep
    assert out.f_tensors < 1e-9
    assert out.OuterIterations < 100


def test_nvecs_init_par2():
    spec = ProblemSpec(
        mode_sizes=(8, (9,) * 4, 4),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, None, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.0,
        distr=["randn", "randn", "rand+0.1"], rng=5)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("randn", "randn", "rand+0.1"), normalize=True,
                       nvecs=True, lambdas_init=((1, 1),))
    state0 = init_coupled(spec, data, init, key=2)
    # PAR2 nvecs: A from concatenated slices' Gram, Bk per-slice, C = ones
    assert np.allclose(np.asarray(state0.fac[2]), 1.0)
    opts = AlgOptions(MaxOuterIters=300, AbsFuncTol=1e-10, OuterRelTol=1e-9)
    state, out = fit(spec, data, state0, opts)
    assert out.f_tensors < 1e-6


def test_bsum_regularization():
    spec, data, init = _cp_problem(ConstraintSpec("non-negativity"))
    opts = AlgOptions(MaxOuterIters=150, AbsFuncTol=1e-10, OuterRelTol=1e-9,
                      bsum=True, bsum_weight=1e-3)
    state0 = init_coupled(spec, data, init, key=2)
    state, out = fit(spec, data, state0, opts)
    assert out.f_tensors < 1e-6


def test_ridge_modes():
    spec, data, init = _cp_problem(None, ridge=(1e-4, 1e-4, 1e-4))
    opts = AlgOptions(MaxOuterIters=150, AbsFuncTol=1e-10, OuterRelTol=1e-9)
    state0 = init_coupled(spec, data, init, key=2)
    state, out = fit(spec, data, state0, opts)
    assert np.isfinite(out.f_tensors)
    # objective includes the ridge penalty term (> pure LS residual)
    from matlab_code_tpu.ops.tensor import cp_frob_objective
    X = data.objects[0]
    pure = float(cp_frob_objective(X, [state.fac[m] for m in range(3)],
                                   jnp.sum(X * X), 1.0))
    ridge_pen = sum(1e-4 * float(jnp.sum(state.fac[m] ** 2))
                    for m in range(3))
    np.testing.assert_allclose(out.f_tensors, pure + ridge_pen, rtol=1e-5,
                               atol=1e-9)


def test_display_iter_smoke(capfd):
    spec, data, init = _cp_problem(None)
    opts = AlgOptions(MaxOuterIters=5, Display="iter", DisplayIters=2)
    state0 = init_coupled(spec, data, init, key=2)
    fit(spec, data, state0, opts)


def test_init_options_validation():
    """init_coupled rejects contradictory init options with clear errors:
    distr length must match the mode count, and a non-empty lambdas_init
    must agree with DatasetSpec.rank per dataset (the reference derives the
    init rank from length(lambdas_init), init_coupled_AOADMM_CMTF.m:17,52;
    here the spec is authoritative)."""
    import pytest
    from matlab_code_tpu.models.init import init_coupled
    from matlab_code_tpu.utils.datagen import create_coupled_data
    spec = ProblemSpec(
        mode_sizes=(8, 9, 10),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, None, None))
    data, _, _, _ = create_coupled_data(spec, lambdas=[[1, 1, 1]], noise=0.0,
                                        distr=["rand", "randn", "randn"],
                                        rng=3)
    with pytest.raises(ValueError, match="distr has 2 entries for 3 modes"):
        init_coupled(spec, data, InitOptions(distr=("rand", "randn"),
                                             lambdas_init=((1, 1, 1),)), key=1)
    with pytest.raises(ValueError, match="length 2 .* rank 3"):
        init_coupled(spec, data,
                     InitOptions(distr=("rand", "randn", "randn"),
                                 lambdas_init=((1, 1),)), key=1)
    with pytest.raises(ValueError, match="2 entries for 1 datasets"):
        init_coupled(spec, data,
                     InitOptions(distr=("rand", "randn", "randn"),
                                 lambdas_init=((1, 1, 1), (1, 1))), key=1)
    # valid options still build a full state
    st = init_coupled(spec, data,
                      InitOptions(distr=("rand", "randn", "randn"),
                                  lambdas_init=((1, 1, 1),)), key=1)
    assert st.fac[0].shape == (8, 3)


def test_zhat_cp_ktensor_unit_weights():
    """CP Zhat entries are ktensor-style {weights, factors} with implicit
    UNIT weights (cmtf_AOADMM.m:200 packages ktensor(U) -> lambda = ones)."""
    import numpy as np
    from matlab_code_tpu.models.solver import assemble_zhat
    from matlab_code_tpu.models.init import init_coupled
    from matlab_code_tpu import (ProblemSpec, DatasetSpec, CouplingSpec,
                                 InitOptions)
    spec = ProblemSpec(
        mode_sizes=(5, 6, 7),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None,) * 3)
    from matlab_code_tpu.problem import ProblemData
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    data = ProblemData(objects=(jnp.asarray(rng.uniform(size=(5, 6, 7))),),
                       coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    st = init_coupled(spec, data,
                      InitOptions(distr=("rand",) * 3, normalize=True,
                                  lambdas_init=((1, 1, 1),)), key=0)
    zhat = assemble_zhat(spec, st)
    np.testing.assert_array_equal(zhat[0]["weights"], np.ones(3))
    assert len(zhat[0]["factors"]) == 3


def test_matmul_precision_option():
    """AlgOptions.matmul_precision traces the whole solver under
    jax.default_matmul_precision.  On the CPU backend the precision
    attribute does not change the kernels, so 'highest' must reproduce the
    default run bitwise across fit/fit_stepwise — the test pins the
    plumb-through (trace-context handling, options cache-key recursion),
    not GPU numerics (chip_smoke.py measures 'default' against 'highest'
    on the card)."""
    import dataclasses as dc
    import pytest
    from matlab_code_tpu import (ProblemSpec, DatasetSpec, CouplingSpec,
                                 ConstraintSpec, AlgOptions, InitOptions)
    from matlab_code_tpu.models.init import init_coupled
    from matlab_code_tpu.models.solver import fit, fit_stepwise
    from matlab_code_tpu.utils.datagen import create_coupled_data, \
        normalize_data

    spec = ProblemSpec(
        mode_sizes=(12, 9, 10),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"), None, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.0, distr=["rand", "randn", "randn"],
        rng=7)
    data, _ = normalize_data(spec, data)
    st = init_coupled(spec, data,
                      InitOptions(distr=("rand", "randn", "randn"),
                                  normalize=True, lambdas_init=((1, 1),)),
                      key=1)
    opts = AlgOptions(MaxOuterIters=40, AbsFuncTol=1e-12)
    _, out_d = fit(spec, data, st, opts, validate=False)
    _, out_h = fit(spec, data, st,
                   dc.replace(opts, matmul_precision="highest"),
                   validate=False)
    np.testing.assert_array_equal(np.asarray(out_d.func_val_conv),
                                  np.asarray(out_h.func_val_conv))
    _, out_s = fit_stepwise(spec, data, st,
                            dc.replace(opts, matmul_precision="float32"),
                            validate=False)
    np.testing.assert_array_equal(np.asarray(out_d.func_val_conv),
                                  np.asarray(out_s.func_val_conv))
    # fit_multistart: the decorator must locate AlgOptions in third
    # position and forward the remaining signature untouched
    from matlab_code_tpu.models.multistart import fit_multistart
    io = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                     lambdas_init=((1, 1),))
    _, mo_d, f_d, _ = fit_multistart(spec, data, opts, io, n_starts=2,
                                     keys=[1, 2])
    _, mo_h, f_h, _ = fit_multistart(
        spec, data, dc.replace(opts, matmul_precision="highest"), io,
        n_starts=2, keys=[1, 2])
    np.testing.assert_array_equal(np.asarray(f_d), np.asarray(f_h))
    np.testing.assert_array_equal(np.asarray(mo_d.func_val_conv),
                                  np.asarray(mo_h.func_val_conv))
    with pytest.raises(ValueError, match="matmul_precision"):
        AlgOptions(matmul_precision="bf16")
