"""Tests that need a GPU (marker `gpu`).  They skip elsewhere; chip_smoke.py
runs them in its own process on the card, where tests/conftest.py turns
float64 on."""
import numpy as np
import pytest

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import fit, compute_znorm_consts
from matlab_code_tpu.options import AUTO_CHOICES, resolve_auto
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data
from oracle import OracleCMTF   # tests/ is on sys.path under pytest


@pytest.mark.gpu
def test_auto_resolves_to_the_gpu_entry(gpu):
    o = resolve_auto(AlgOptions())
    assert {k: getattr(o, k) for k in AUTO_CHOICES["gpu"]} == \
        AUTO_CHOICES["gpu"]


@pytest.mark.gpu
def test_float64_fit_on_card_matches_oracle(gpu):
    """A coupled nonneg CP fit in float64 on the card follows the numpy
    oracle's trajectory as closely as the CPU run does
    (tests/test_oracle_parity.py::test_oracle_parity_coupled_cp)."""
    spec = ProblemSpec(
        mode_sizes=(8, 9, 10, 8, 11),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2,
                              weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4), rank=2, weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(0,)),
        constraints=(ConstraintSpec("non-negativity"), None,
                     ConstraintSpec("non-negativity"),
                     ConstraintSpec("non-negativity"), None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1], [1, 1]], noise=0.05,
        distr=["rand", "randn", "rand", "rand", "randn"], rng=6)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("rand", "randn", "rand", "rand", "randn"),
                       normalize=True, lambdas_init=((1, 1), (1, 1)))
    state0 = init_coupled(spec, data, init, key=5)
    assert state0.fac[0].dtype == np.float64
    assert next(iter(state0.fac[0].devices())).platform == "gpu"
    T = 15
    opts = AlgOptions(MaxOuterIters=T, AbsFuncTol=0.0, OuterRelTol=0.0)
    state, out = fit(spec, data, state0, opts)
    orc = OracleCMTF(
        Xs=[np.asarray(data.objects[0]), np.asarray(data.objects[1])],
        modes=[(0, 1, 2), (3, 4)], weights=[0.5, 0.5],
        constrained={0, 2, 3}, coupled_modes=(0, 3), state=state0)
    znorms = [float(z) for z in compute_znorm_consts(spec, data, opts)]
    traj = []
    for _ in range(T):
        orc.sweep(opts)
        traj.append(orc.objective(znorms))
    traj = np.asarray(traj)
    np.testing.assert_allclose(out.func_val_conv[1:], traj[:, 0],
                               rtol=1e-9, atol=1e-12)
    for m in range(5):
        np.testing.assert_allclose(np.asarray(state.fac[m]), orc.fac[m],
                                   rtol=1e-8, atol=1e-10)
