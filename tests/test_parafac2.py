"""PARAFAC2 fits: regular, ragged, constrained-Bk, tPARAFAC2, and
CP+PAR2 coupling — small analogues of example scripts 1/2/4/8/9/11/14."""
import numpy as np
import pytest

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu.utils.score import fms, fms_par2_B
from tests.helpers import run_problem, cp_fms


OPTS = AlgOptions(MaxOuterIters=3000, AbsFuncTol=1e-9, OuterRelTol=1e-9)


def _par2_fit(res, spec, p):
    """Fit% of a PAR2 dataset from the returned factors."""
    z = res["zhat"][p]
    X = res["data"].objects[p]
    num = 0.0
    den = 0.0
    sizes = spec.par2_slice_sizes(p)
    for k, J in enumerate(sizes):
        Xk = np.asarray(X.slices[k, :, :J])
        Mk = z["A"] @ np.diag(z["C"][k]) @ z["Bk"][k].T
        num += np.sum((Xk - Mk) ** 2)
        den += np.sum(Xk ** 2)
    return 100.0 * (1.0 - num / den)


def test_regular_par2_nonneg():
    # script-8 style: one regular PAR2, all modes nonneg
    K, J, I = 8, 15, 10
    spec = ProblemSpec(
        mode_sizes=(I, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"), None,
                     ConstraintSpec("non-negativity")))
    res = run_problem(spec, lambdas=[[1, 1, 1]],
                      distr=["rand", "rand", "rand+0.1"], opts=OPTS, key=2)
    assert res["out"].f_tensors < 1e-7
    assert res["out"].f_PAR2_couplings < 1e-3
    assert _par2_fit(res, spec, 0) > 99.99


def test_cp_par2_coupled_nonneg():
    # script-1 style: CP (0,1,2) + PAR2 (3,4,5), modes 0 & 3 exactly coupled
    K, J = 6, 12
    spec = ProblemSpec(
        mode_sizes=(10, 11, 12, 10, (J,) * K, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(0,)),
        constraints=(ConstraintSpec("non-negativity"), None, None,
                     ConstraintSpec("non-negativity"),
                     ConstraintSpec("non-negativity"),
                     ConstraintSpec("non-negativity")))
    res = run_problem(
        spec, lambdas=[[1, 1, 1], [1, 1, 1]],
        distr=["rand", "randn", "randn", "rand", "rand", "rand+0.1"],
        opts=OPTS, key=2)
    assert res["out"].f_tensors < 1e-7
    assert res["out"].f_couplings < 1e-3
    assert _par2_fit(res, spec, 1) > 99.9
    assert cp_fms(res, 0, spec, (0, 1, 2)) > 0.99
    np.testing.assert_allclose(res["state"].fac[0], res["state"].fac[3],
                               atol=1e-2)


def test_irregular_par2():
    # script-4 style: ragged slice sizes, nonneg C only
    sizes = (13, 17, 11, 19, 15)
    spec = ProblemSpec(
        mode_sizes=(9, sizes, len(sizes)),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, None, ConstraintSpec("non-negativity")))
    res = run_problem(spec, lambdas=[[1, 1, 1]],
                      distr=["randn", "randn", "rand+0.1"], opts=OPTS,
                      key=2, bk_style="orth")
    assert res["out"].f_tensors < 1e-7
    assert _par2_fit(res, spec, 0) > 99.99
    # padded rows of returned state stay exactly zero
    Bk = np.asarray(res["state"].fac[1])
    for k, J in enumerate(sizes):
        np.testing.assert_allclose(Bk[k, J:, :], 0.0, atol=1e-12)
    # FMS of recovered ragged Bk vs truth
    assert fms_par2_B(res["zhat"][0]["Bk"], res["Atrue"][1]) > 0.98


def test_par2_unimodal_bk_delayed_constraint():
    # script-9 style: unimodality on Bk, delayed start, rho scaling
    K, J, I = 6, 30, 8
    spec = ProblemSpec(
        mode_sizes=(I, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, ConstraintSpec("unimodality", (False,)),
                     ConstraintSpec("non-negativity")))
    opts = AlgOptions(MaxOuterIters=600, MaxInnerIters=10, AbsFuncTol=1e-9,
                      OuterRelTol=1e-9, iter_start_PAR2Bkconstraint=30,
                      increase_factor_rhoBk=10.0)
    res = run_problem(spec, lambdas=[[1, 1]],
                      distr=["randn", "rand", "rand+0.1"], opts=opts, key=2,
                      bk_style="unimodal")
    assert res["out"].f_tensors < 5e-2
    # every recovered Bk column is unimodal
    Bk = np.asarray(res["state"].constraint_fac[1])
    for k in range(K):
        for r in range(2):
            col = Bk[k, :, r]
            peak = int(np.argmax(col))
            assert np.all(np.diff(col[:peak + 1]) >= -1e-8)
            assert np.all(np.diff(col[peak:]) <= 1e-8)


def test_tparafac2_smoothness():
    # script-11 style: temporal smoothness on Bk
    K, J, I = 8, 12, 9
    spec = ProblemSpec(
        mode_sizes=(I, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, ConstraintSpec("tPARAFAC2", (10.0,)),
                     ConstraintSpec("non-negativity")))
    res = run_problem(spec, lambdas=[[1, 1]],
                      distr=["randn", "rand", "rand+0.1"], opts=OPTS, key=2,
                      bk_style="smooth", normalize=True)
    assert np.isfinite(res["out"].f_tensors)
    tv10 = np.sum(np.diff(np.asarray(res["state"].constraint_fac[1]),
                          axis=0) ** 2)

    # weak smoothing: near-exact fit
    spec_weak = ProblemSpec(
        mode_sizes=spec.mode_sizes, datasets=spec.datasets,
        coupling=spec.coupling,
        constraints=(None, ConstraintSpec("tPARAFAC2", (1e-6,)),
                     ConstraintSpec("non-negativity")))
    res_w = run_problem(spec_weak, lambdas=[[1, 1]],
                        distr=["randn", "rand", "rand+0.1"], opts=OPTS, key=2,
                        bk_style="smooth", normalize=True)
    assert _par2_fit(res_w, spec_weak, 0) > 99.9
    tv_weak = np.sum(np.diff(np.asarray(res_w["state"].constraint_fac[1]),
                             axis=0) ** 2)
    # stronger smoothing => smaller temporal variation of the Bk's
    assert tv10 < tv_weak


def test_par2_C_mode_coupled_type1():
    # script-14 style: coupling on the PAR2 C mode, type 1 (HC = Delta)
    K1, K2 = 12, 6
    J, I = 10, 8
    H_cp = np.zeros((K2, K1))
    for i in range(K2):
        H_cp[i, 2 * i] = 1.0
    H_c = np.eye(K2)
    spec = ProblemSpec(
        mode_sizes=(K1, 9, 8, I, (J,) * K2, K2),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=2,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 0, 0, 1),
                              coupling_type=(1,)),
        constraints=(None,) * 6)
    res = run_problem(spec, lambdas=[[1, 1], [1, 1]],
                      distr=["rand", "randn", "randn", "rand", "rand",
                             "rand+0.1"],
                      coupl_trafo=[H_cp, None, None, None, None, H_c],
                      opts=OPTS, key=2)
    assert res["out"].f_tensors < 1e-6
    assert res["out"].f_couplings < 1e-3


def test_prox_slicewise_ragged_matches_per_slice():
    """The size-bucketed ragged slice-wise prox equals applying the same prox
    per slice on exact-size matrices, for every row-coupled kind."""
    import jax.numpy as jnp
    from matlab_code_tpu.models.admm import prox_slicewise_ragged
    from matlab_code_tpu.ops.prox import make_prox

    sizes = (13, 17, 13, 11, 17, 17)
    K, Jmax, R = len(sizes), max(sizes), 3
    rng = np.random.default_rng(3)
    Bs = np.zeros((K, Jmax, R))
    for k, J in enumerate(sizes):
        Bs[k, :J] = rng.normal(size=(J, R))
    rho = jnp.asarray(rng.uniform(0.5, 2.0, size=K))
    Bsj = jnp.asarray(Bs)

    kinds = [ConstraintSpec("unimodality", (False,)),
             ConstraintSpec("unimodality", (True,)),
             ConstraintSpec("non-decreasing"),
             ConstraintSpec("non-increasing"),
             ConstraintSpec("simplex column-wise", (1.0,)),
             ConstraintSpec("TV regularization", (0.3,)),
             ConstraintSpec("l1-ball", (1.5,))]
    for cs in kinds:
        prox, _ = make_prox(cs, sizes[0])
        out = np.asarray(prox_slicewise_ragged(prox, Bsj, rho, sizes))
        for k, J in enumerate(sizes):
            ref = np.asarray(prox(jnp.asarray(Bs[k, :J]), rho[k]))
            np.testing.assert_allclose(out[k, :J], ref, rtol=1e-12,
                                       atol=1e-14, err_msg=cs.kind)
            np.testing.assert_allclose(out[k, J:], 0.0, atol=0.0,
                                       err_msg=cs.kind)


def test_irregular_par2_unimodal_bk():
    """Script-4 x script-9 hybrid: RAGGED slice sizes + unimodality on Bk
    (the reference supports this via per-slice proxes on true J_k,
    cmtf_fun_AOADMM.m:567-578)."""
    sizes = (26, 31, 24, 35, 29, 33)
    spec = ProblemSpec(
        mode_sizes=(8, sizes, len(sizes)),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, ConstraintSpec("unimodality", (False,)),
                     ConstraintSpec("non-negativity")))
    opts = AlgOptions(MaxOuterIters=800, MaxInnerIters=10, AbsFuncTol=1e-9,
                      OuterRelTol=1e-9, iter_start_PAR2Bkconstraint=30,
                      increase_factor_rhoBk=10.0)
    res = run_problem(spec, lambdas=[[1, 1]],
                      distr=["randn", "rand", "rand+0.1"], opts=opts, key=2,
                      bk_style="unimodal")
    assert res["out"].f_tensors < 5e-2
    Zb = np.asarray(res["state"].constraint_fac[1])
    for k, J in enumerate(sizes):
        # padded rows exactly zero
        np.testing.assert_allclose(Zb[k, J:, :], 0.0, atol=0.0)
        for r in range(2):
            col = Zb[k, :J, r]
            peak = int(np.argmax(col))
            assert np.all(np.diff(col[:peak + 1]) >= -1e-8)
            assert np.all(np.diff(col[peak:]) <= 1e-8)


def test_irregular_par2_tv_bk():
    """Ragged slices + TV regularization on Bk: converges and the padded
    rows stay exactly zero through the Condat prox."""
    sizes = (14, 19, 16, 21)
    spec = ProblemSpec(
        mode_sizes=(7, sizes, len(sizes)),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, ConstraintSpec("TV regularization", (1e-4,)),
                     ConstraintSpec("non-negativity")))
    opts = AlgOptions(MaxOuterIters=1500, AbsFuncTol=1e-9, OuterRelTol=1e-9)
    res = run_problem(spec, lambdas=[[1, 1]],
                      distr=["randn", "randn", "rand+0.1"], opts=opts, key=2,
                      bk_style="orth")
    assert res["out"].f_tensors < 1e-3
    assert _par2_fit(res, spec, 0) > 99.0
    Bk = np.asarray(res["state"].fac[1])
    for k, J in enumerate(sizes):
        np.testing.assert_allclose(Bk[k, J:, :], 0.0, atol=1e-12)


def test_par2_polar_ns_matches_svd():
    """par2_polar='ns' (matmul-only Newton-Schulz P_k) reproduces the
    'svd' fit: same trajectory to ~1e-8 and the same recovery."""
    import dataclasses
    K, J, I = 8, 15, 10
    spec = ProblemSpec(
        mode_sizes=(I, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"), None,
                     ConstraintSpec("non-negativity")))
    opts = AlgOptions(MaxOuterIters=60, AbsFuncTol=0.0, OuterRelTol=0.0)
    res_svd = run_problem(spec, lambdas=[[1, 1, 1]],
                          distr=["rand", "rand", "rand+0.1"], opts=opts, key=2)
    opts_ns = dataclasses.replace(opts, par2_polar="ns")
    res_ns = run_problem(spec, lambdas=[[1, 1, 1]],
                         distr=["rand", "rand", "rand+0.1"], opts=opts_ns,
                         key=2)
    np.testing.assert_allclose(res_ns["out"].func_val_conv,
                               res_svd["out"].func_val_conv,
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(res_ns["out"].func_PAR2_coupl,
                               res_svd["out"].func_PAR2_coupl,
                               rtol=1e-5, atol=1e-8)


def test_inner_solve_inverse_matches_chol():
    """inner_solve='inverse' (one matmul per inner iteration against the
    precomputed normal-matrix inverse) reproduces the 'chol'
    triangular-substitution fit across CP + PAR2 + coupling."""
    import dataclasses
    K, J, I0 = 6, 12, 8
    spec = ProblemSpec(
        mode_sizes=(I0, 10, 14, I0, (J,) * K, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3,
                              weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(0,)),
        constraints=(ConstraintSpec("non-negativity"), None, None,
                     ConstraintSpec("non-negativity"),
                     ConstraintSpec("non-negativity"),
                     ConstraintSpec("non-negativity")))
    opts = AlgOptions(MaxOuterIters=50, AbsFuncTol=0.0, OuterRelTol=0.0)
    res_c = run_problem(spec, lambdas=[[1] * 3] * 2,
                        distr=["rand", "randn", "randn", "rand", "rand",
                               "rand+0.1"], opts=opts, key=1)
    opts_i = dataclasses.replace(opts, inner_solve="inverse")
    res_i = run_problem(spec, lambdas=[[1] * 3] * 2,
                        distr=["rand", "randn", "randn", "rand", "rand",
                               "rand+0.1"], opts=opts_i, key=1)
    np.testing.assert_allclose(res_i["out"].func_val_conv,
                               res_c["out"].func_val_conv,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res_i["out"].func_coupl_conv,
                               res_c["out"].func_coupl_conv,
                               rtol=1e-7, atol=1e-10)


def test_inner_solve_newton_matches_chol():
    """inner_solve='newton' (matmul-only Newton-Hotelling inverse of the
    K-batched normal matrices) reproduces
    the 'chol' fit across CP + PAR2 + coupling."""
    import dataclasses
    K, J, I0 = 6, 12, 8
    spec = ProblemSpec(
        mode_sizes=(I0, 10, 14, I0, (J,) * K, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3,
                              weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(0,)),
        constraints=(ConstraintSpec("non-negativity"), None, None,
                     ConstraintSpec("non-negativity"),
                     ConstraintSpec("non-negativity"),
                     ConstraintSpec("non-negativity")))
    opts = AlgOptions(MaxOuterIters=50, AbsFuncTol=0.0, OuterRelTol=0.0)
    res_c = run_problem(spec, lambdas=[[1] * 3] * 2,
                        distr=["rand", "randn", "randn", "rand", "rand",
                               "rand+0.1"], opts=opts, key=1)
    opts_n = dataclasses.replace(opts, inner_solve="newton")
    res_n = run_problem(spec, lambdas=[[1] * 3] * 2,
                        distr=["rand", "randn", "randn", "rand", "rand",
                               "rand+0.1"], opts=opts_n, key=1)
    np.testing.assert_allclose(res_n["out"].func_val_conv,
                               res_c["out"].func_val_conv,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res_n["out"].func_coupl_conv,
                               res_c["out"].func_coupl_conv,
                               rtol=1e-7, atol=1e-10)


def test_ragged_bk_style_validation_and_smooth_extension():
    """Ragged slice sizes: bk_style 'shift'/'temporal' need one common J grid
    (the reference defines them only for equal sizes,
    create_coupled_data.m:64-72) and must raise a CLEAR error instead of
    producing mis-padded slices that crash deep inside fit(); 'smooth'
    extends naturally (same cubic subspace sampled on each slice's own
    grid) and the resulting problem fits to machine precision."""
    from matlab_code_tpu.utils.datagen import create_coupled_data
    sizes = (20, 24, 18, 22)
    spec = ProblemSpec(
        mode_sizes=(15, sizes, len(sizes)),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, None, ConstraintSpec("non-negativity")))
    for style in ("shift", "temporal"):
        with pytest.raises(ValueError, match="equal PARAFAC2 slice sizes"):
            create_coupled_data(spec, lambdas=[[1, 1, 1]], noise=0.0,
                                distr=["randn", "randn", "rand+0.1"],
                                rng=5, bk_style=style)
    res = run_problem(spec, lambdas=[[1, 1, 1]],
                      distr=["randn", "randn", "rand+0.1"], opts=OPTS,
                      key=2, bk_style="smooth")
    assert res["out"].f_tensors < 1e-7
    assert _par2_fit(res, spec, 0) > 99.99
    # each true Bk has its own J_k rows, and padded state rows stay zero
    assert [b.shape[0] for b in res["Atrue"][1]] == list(sizes)
    Bk = np.asarray(res["state"].fac[1])
    for k, J in enumerate(sizes):
        np.testing.assert_allclose(Bk[k, J:, :], 0.0, atol=1e-12)


def test_smooth_bks_normalize_columns_and_min_size():
    """_smooth_bks honors normalize_columns (per-column unit norms,
    create_coupled_data_smoothBks.m:77-81) and raises a clear error for
    slice sizes < 4 (the cubic basis needs >= 4 rows)."""
    from matlab_code_tpu.utils.datagen import create_coupled_data
    sizes = (12, 12, 12)
    spec = ProblemSpec(
        mode_sizes=(10, sizes, len(sizes)),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, None, None))
    _, Atrue, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1, 1]], noise=0.0,
        distr=["randn", "randn", "rand+0.1"], rng=5, bk_style="smooth",
        normalize_columns=True)
    for Bk in Atrue[1]:
        np.testing.assert_allclose(np.linalg.norm(np.asarray(Bk), axis=0),
                                   1.0, rtol=1e-12)
    tiny = ProblemSpec(
        mode_sizes=(10, (3, 3), 2),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, None, None))
    with pytest.raises(ValueError, match="slice size >= 4"):
        create_coupled_data(tiny, lambdas=[[1, 1]], noise=0.0,
                            distr=["randn", "randn", "rand+0.1"], rng=5,
                            bk_style="smooth")
