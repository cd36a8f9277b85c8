"""Auxiliary subsystems: checkpoint/resume, multistart, profiling, sharding."""
import os
import tempfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import fit
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data
from matlab_code_tpu.utils.checkpoint import save_state, load_state


def _small_problem(with_par2=True):
    if with_par2:
        spec = ProblemSpec(
            mode_sizes=(8, 9, 10, 8, (7,) * 4, 4),
            datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2,
                                  weight=0.5),
                      DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=2,
                                  weight=0.5)),
            coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                                  coupling_type=(0,)),
            constraints=(ConstraintSpec("non-negativity"), None, None,
                         ConstraintSpec("non-negativity"), None, None))
        distr = ["rand", "randn", "randn", "rand", "rand", "rand+0.1"]
    else:
        spec = ProblemSpec(
            mode_sizes=(8, 9, 10),
            datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
            coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0),
                                  coupling_type=()),
            constraints=(ConstraintSpec("non-negativity"), None, None))
        distr = ["rand", "randn", "randn"]
    data, Atrue, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]] * len(spec.datasets), noise=0.0, distr=distr,
        rng=3)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=tuple(distr), normalize=True,
                       lambdas_init=((1, 1),) * len(spec.datasets))
    return spec, data, init


def test_checkpoint_roundtrip_and_resume():
    spec, data, init = _small_problem()
    state0 = init_coupled(spec, data, init, key=2)
    opts = AlgOptions(MaxOuterIters=20, AbsFuncTol=0.0, OuterRelTol=0.0)
    state, out = fit(spec, data, state0, opts)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        save_state(path, state)
        restored = load_state(path)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # resuming continues the trajectory (objective non-increasing-ish)
    opts2 = AlgOptions(MaxOuterIters=20, AbsFuncTol=0.0, OuterRelTol=0.0)
    state2, out2 = fit(spec, data, restored, opts2)
    assert out2.f_tensors <= out.f_tensors + 1e-12


def test_multistart_matches_sequential():
    from matlab_code_tpu.models.multistart import fit_multistart
    from matlab_code_tpu.models.init import init_coupled as _init
    spec, data, init = _small_problem(with_par2=False)
    opts = AlgOptions(MaxOuterIters=60, AbsFuncTol=1e-10, OuterRelTol=1e-9)
    best_state, best_out, finals, stops = fit_multistart(
        spec, data, opts, init, n_starts=4, base_key=0)
    assert len(finals) == 4
    assert best_out.f_tensors == np.nanmin(finals)
    assert np.isfinite(best_out.f_tensors)
    # at least one start should solve this noiseless problem
    assert best_out.f_tensors < 1e-6

    # the best start's FitOutput equals a sequential fit from the same init
    import jax
    root = jax.random.PRNGKey(0)
    best = int(np.nanargmin(finals))
    st0 = _init(spec, data, init, key=jax.random.fold_in(root, best))
    st_seq, out_seq = fit(spec, data, st0, opts)
    assert out_seq.OuterIterations == best_out.OuterIterations
    np.testing.assert_allclose(best_out.func_val_conv, out_seq.func_val_conv,
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(best_out.innerIters, out_seq.innerIters)
    assert best_out.exit_flag == out_seq.exit_flag
    for m in range(spec.nb_modes):
        np.testing.assert_allclose(np.asarray(best_state.fac[m]),
                                   np.asarray(st_seq.fac[m]), rtol=1e-10,
                                   atol=1e-12)


def test_multistart_par2_delayed_constraint():
    """Multistart honors iter_start_PAR2Bkconstraint (two-phase split) and
    matches the sequential fit start-for-start."""
    from matlab_code_tpu.models.multistart import fit_multistart
    from matlab_code_tpu.models.init import init_coupled as _init
    import jax
    spec, data, init = _small_problem(with_par2=True)
    # constrain the Bk mode with a delayed start
    spec = ProblemSpec(
        mode_sizes=spec.mode_sizes, datasets=spec.datasets,
        coupling=spec.coupling,
        constraints=(ConstraintSpec("non-negativity"), None, None,
                     ConstraintSpec("non-negativity"),
                     ConstraintSpec("non-negativity"), None))
    opts = AlgOptions(MaxOuterIters=40, AbsFuncTol=1e-10, OuterRelTol=1e-9,
                      iter_start_PAR2Bkconstraint=10)
    best_state, best_out, finals, stops = fit_multistart(
        spec, data, opts, init, n_starts=3, base_key=0)
    root = jax.random.PRNGKey(0)
    best = int(np.nanargmin(finals))
    st0 = _init(spec, data, init, key=jax.random.fold_in(root, best))
    st_seq, out_seq = fit(spec, data, st0, opts)
    assert out_seq.OuterIterations == best_out.OuterIterations
    np.testing.assert_allclose(best_out.func_val_conv, out_seq.func_val_conv,
                               rtol=1e-11, atol=1e-13)


def test_profiling_utils():
    from matlab_code_tpu.utils.profiling import Timer, sweep_flops, \
        roofline_report
    spec, data, init = _small_problem()
    t = Timer()
    with t.phase("x"):
        pass
    assert "x" in t.summary()
    s = sweep_flops(spec)
    assert s["flops_per_sweep"] > 0
    rep = roofline_report(spec, 1e-3, device_kind="NVIDIA H100 80GB HBM3")
    assert "GFLOP" in rep and "tf32_flops" in rep
    # an unknown device is an error, never a default
    with pytest.raises(ValueError, match="no peak rates"):
        roofline_report(spec, 1e-3, device_kind="cpu")


def test_sharded_step_matches_single_device():
    """The sharded multi-device step computes the same numbers as the
    single-device step (8 virtual CPU devices) — dryrun_multichip asserts
    elementwise factor equality to 1e-10, not just finiteness."""
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_sharded_full_fit_matches_single_device():
    """A FULL fit() with the production shardings (CP data mode-sharded,
    PARAFAC2 slice-sharded over 8 virtual devices) reproduces the
    single-device trajectory and final factors."""
    import __graft_entry__ as ge
    from matlab_code_tpu.parallel.sharding import (
        make_mesh, data_shardings, state_shardings)
    spec, data, state, _ = ge._flagship(I0=16, J1=12, J2=16, K=8, Jb=10, R=3)
    opts = AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)

    st_ref, out_ref = fit(spec, data, state, opts)

    mesh = make_mesh(8)
    data_sh, sharded_modes = data_shardings(spec, data, mesh)
    state_sh = state_shardings(spec, state, mesh, sharded_modes)
    data_s = jax.device_put(data, data_sh)
    state_s = jax.device_put(state, state_sh)
    st_sh, out_sh = fit(spec, data_s, state_s, opts)

    np.testing.assert_allclose(out_sh.func_val_conv, out_ref.func_val_conv,
                               rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(out_sh.func_coupl_conv, out_ref.func_coupl_conv,
                               rtol=1e-9, atol=1e-12)
    for m in range(spec.nb_modes):
        np.testing.assert_allclose(np.asarray(st_sh.fac[m]),
                                   np.asarray(st_ref.fac[m]),
                                   rtol=1e-9, atol=1e-11)
    assert out_sh.OuterIterations == out_ref.OuterIterations


def test_public_api_exports():
    """Everything a reference user needs is importable from the package
    root: spec/option types, BOTH data container types (SparseTensor,
    Parafac2Tensor), and the driver entry points incl. multistart."""
    import matlab_code_tpu as mct
    for name in mct.__all__:
        assert getattr(mct, name) is not None
    for required in ("SparseTensor", "Parafac2Tensor", "fit_multistart",
                     "cmtf_aoadmm", "fit", "create_coupled_data"):
        assert required in mct.__all__


def test_plot_convergence_renders(tmp_path):
    """utils/plotting.plot_convergence renders the reference's three-panel
    figure (example_script1:154-189) from a FitOutput and writes a PNG;
    zero-valued stream points are dropped like MATLAB semilogy."""
    import matplotlib
    matplotlib.use("Agg")
    from matlab_code_tpu import (
        ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
        InitOptions, cmtf_aoadmm)
    from matlab_code_tpu.utils.datagen import create_coupled_data, \
        normalize_data
    from matlab_code_tpu.utils.plotting import plot_convergence
    spec = ProblemSpec(
        mode_sizes=(8, 9, 10),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"), None, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.0,
        distr=["rand", "randn", "randn"], rng=3)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       lambdas_init=((1, 1),))
    opts = AlgOptions(MaxOuterIters=12)
    _, _, _, out = cmtf_aoadmm(spec, data, opts, init_options=init, key=2)
    p = tmp_path / "conv.png"
    fig = plot_convergence(out, path=str(p))
    assert p.exists() and p.stat().st_size > 10000
    assert len(fig.axes) == 3
    import matplotlib.pyplot as plt
    plt.close(fig)
