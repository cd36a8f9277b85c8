"""Production-scale benchmark: rank-64 triple fusion with a 0.5 GB tensor,
plus vmapped multi-start throughput (whole fits in parallel on one GPU).

Supplementary to bench.py; prints one JSON line per experiment, each with
the device it ran on.  Run: `python bench_large.py` (one process, one GPU).
"""
import functools
import json
import sys
import time

import numpy as np

print = functools.partial(print, flush=True)
import jax
import jax.numpy as jnp

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import (
    build_proxes, make_outer_step, init_cache)
from matlab_code_tpu.utils.compile_cache import enable_compile_cache
from matlab_code_tpu.utils.profiling import device_peaks


def large_problem(I=256, J1=1024, J2=512, M1=8192, R=64):
    spec = ProblemSpec(
        mode_sizes=(I, J1, J2, I, M1),
        datasets=(
            DatasetSpec(model="CP", modes=(0, 1, 2), rank=R, weight=0.5),
            DatasetSpec(model="CP", modes=(3, 4), rank=R, weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(0,)),
        constraints=tuple(ConstraintSpec("non-negativity")
                          for _ in range(5)))
    rng = np.random.default_rng(0)
    dt = jnp.result_type(float)
    facs = [jnp.asarray(rng.uniform(size=(s, R)).astype(dt))
            for s in spec.mode_sizes]   # small; big tensors built ON DEVICE
    X1, X2 = jax.jit(lambda f: (jnp.einsum("ir,jr,kr->ijk", f[0], f[1], f[2]),
                                f[3] @ f[4].T))(facs)
    from matlab_code_tpu.problem import ProblemData
    data = ProblemData(objects=(X1, X2),
                       coupl_trafo=(None,) * 5, coupl_trafo2=(None,) * 5)
    opts = AlgOptions(MaxOuterIters=10, MaxInnerIters=5)
    init = InitOptions(distr=("rand",) * 5, normalize=True,
                       lambdas_init=((1,) * R,) * 2)
    state = init_coupled(spec, data, init, key=1)
    return spec, data, state, opts


def run_iters(spec, data, state, opts, n_iters, peaks=None):
    """it/s of the full outer step, in-jit loop of n_iters sweeps per
    timed call.  With `peaks` (utils/profiling.device_peaks) also returns
    the per-iteration roofline lower bound from XLA's post-fusion cost
    model (bench._roofline_bound_us: max(FLOPs at the TF32 peak, bytes at
    the HBM peak); conservative — see its docstring) so the printed line can
    carry % of bound."""
    proxes, reg_fns = build_proxes(spec)
    step = make_outer_step(spec, opts, proxes, reg_fns, True)
    grams, colnorms = init_cache(spec, state)

    def n_steps_fn(state, data, grams, colnorms):
        def body(i, c):
            s, g, cn = c
            s, g, cn, *_ = step(s, data, g, cn)
            return (s, g, cn)
        return jax.lax.fori_loop(0, n_iters, body, (state, grams, colnorms))

    n_steps = jax.jit(n_steps_fn).lower(state, data, grams,
                                        colnorms).compile()
    out = jax.block_until_ready(n_steps(state, data, grams, colnorms))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(n_steps(state, data, grams, colnorms))
        best = min(best, (time.perf_counter() - t0) / n_iters)
    assert bool(jnp.all(jnp.isfinite(out[0].fac[0])))
    if peaks is None:
        return 1.0 / best
    from bench import _roofline_bound_us
    return 1.0 / best, _roofline_bound_us(n_steps, n_iters, peaks)


def par2_problem(I=256, J=256, K=512, R=32):
    """Regular PARAFAC2, 134 MB of slices: the K-batched Cholesky/polar-SVD
    sweep (ADMM_B_Parafac2) at production scale."""
    spec = ProblemSpec(
        mode_sizes=(I, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=R),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"), None,
                     ConstraintSpec("non-negativity")))
    rng = np.random.default_rng(0)
    dt = jnp.result_type(float)
    A = rng.uniform(size=(I, R)).astype(dt)
    C = rng.uniform(0.5, 1.5, size=(K, R)).astype(dt)
    B = rng.standard_normal((K, J, R)).astype(dt)
    X = jax.jit(lambda A, C, B: jnp.einsum("ir,kr,kjr->kij", A, C, B))(
        A, C, B)                         # 134 MB, built ON DEVICE
    from matlab_code_tpu.problem import ProblemData, Parafac2Tensor
    data = ProblemData(
        objects=(Parafac2Tensor(slices=X, mask=jnp.ones((K, J), bool)),),
        coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    opts = AlgOptions(MaxOuterIters=10, MaxInnerIters=5)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1,) * R,))
    state = init_coupled(spec, data, init, key=1)
    return spec, data, state, opts


def kl_problem(I=128, J=256, K=256, R=8):
    """Production-scale KL loss (Poisson counts): the L-BFGS-B inner-solve
    path, where every evaluation materializes the full model tensor
    (cmtf_fun_AOADMM.m:1368-1372)."""
    spec = ProblemSpec(
        mode_sizes=(I, J, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=R,
                              loss="KL"),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"),) * 3)
    rng = np.random.default_rng(0)
    dt = jnp.result_type(float)
    facs = [rng.uniform(size=(s, R)).astype(dt) for s in (I, J, K)]
    lam = rng.poisson(
        20.0 * np.einsum("ir,jr,kr->ijk", facs[0], facs[1], facs[2]))
    from matlab_code_tpu.problem import ProblemData
    data = ProblemData(objects=(jnp.asarray(lam, dt),),
                       coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    opts = AlgOptions(MaxOuterIters=10, MaxInnerIters=5)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1,) * R,))
    state = init_coupled(spec, data, init, key=1)
    return spec, data, state, opts


def sparse_problem(D=2048, NNZ=10_000_000, R=16, structured=False):
    """Sparse COO CP (the reference's sptensor path): 1e7 nonzeros of a
    2048^3 tensor, through the gather/segment-sum MTTKRP
    (ops/tensor.mttkrp_sparse)."""
    from matlab_code_tpu.problem import ProblemData, SparseTensor
    spec = ProblemSpec(
        mode_sizes=(D, D, D),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=R),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"),) * 3)
    rng = np.random.default_rng(0)
    dt = jnp.result_type(float)
    idx = np.unique(rng.integers(0, D, size=(NNZ, 3)).astype(np.int32),
                    axis=0)
    if structured:
        # sampled entries of a ground-truth nonneg CP model — the
        # convergent (tight-tolerance) regime where factor steps shrink
        # and the pairwise-perturbation accelerator engages.  (With added
        # noise the factors bounce at the noise floor at ~3%/sweep — a
        # regime where OuterRelTol would stop the fit and PP correctly
        # stays inactive.)
        F = [rng.uniform(size=(D, R)).astype(dt) for _ in range(3)]
        vals = (F[0][idx[:, 0]] * F[1][idx[:, 1]]
                * F[2][idx[:, 2]]).sum(1).astype(dt)
    else:
        vals = rng.uniform(size=len(idx)).astype(dt)
    st = SparseTensor(jnp.asarray(idx), jnp.asarray(vals))
    data = ProblemData(objects=(st,), coupl_trafo=(None,) * 3,
                       coupl_trafo2=(None,) * 3)
    opts = AlgOptions(MaxOuterIters=10, MaxInnerIters=5)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1,) * R,))
    state = init_coupled(spec, data, init, key=1)
    return spec, data, state, opts


def run_iters_pp(spec, data, state, opts, n_iters, warm_iters=5):
    """Steady-state it/s of PP-accelerated sweeps (models/pairwise.py).

    This measures the THROUGHPUT of a pairwise-perturbation sweep (dense
    einsums over cached partials instead of the gather data pass), so the
    caller's opts should force engagement (pp_start_tol=1.0)
    and suppress rebuilds (pp_refresh_tol large) — at bench scale the
    production gating (start 0.02) only engages after hundreds of
    convergent sweeps, which tests/test_pairwise.py pins separately.
    Returns (iters_per_s, pp_active_fraction) — the fraction asserts the
    timed sweeps really ran PP."""
    from matlab_code_tpu.models.pairwise import (
        eligible_pp_datasets, pp_init)
    proxes, reg_fns = build_proxes(spec)
    pp_ds = eligible_pp_datasets(spec, data, opts)
    assert pp_ds, "PP bench config must be PP-eligible"
    step = make_outer_step(spec, opts, proxes, reg_fns, True,
                           pp_datasets=pp_ds)
    grams, colnorms = init_cache(spec, state)
    pp0 = pp_init(spec, data, state, pp_ds)

    @jax.jit
    def n_steps(state, data, grams, colnorms, pp, n):
        def body(i, c):
            s, g, cn, pp, act = c
            s, g, cn, _, _, _, _, _, pp = step(s, data, g, cn, None, pp)
            act = act + jnp.where(pp[pp_ds[0]]["active"], 1, 0)
            return (s, g, cn, pp, act)
        return jax.lax.fori_loop(0, n, body,
                                 (state, grams, colnorms, pp, jnp.int32(0)))

    # warm: exact-regime sweeps to reach the converging tail
    state, grams, colnorms, pp, _ = jax.block_until_ready(n_steps(
        state, data, grams, colnorms, pp0, warm_iters))
    best = np.inf
    act = 0
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            n_steps(state, data, grams, colnorms, pp, n_iters))
        best = min(best, (time.perf_counter() - t0) / n_iters)
        act = int(out[4])
    assert bool(jnp.all(jnp.isfinite(out[0].fac[0])))
    return 1.0 / best, act / n_iters


def multistart_throughput(n_starts=8, iters=20):
    """Whole fits batched with vmap — fits/sec on one GPU."""
    from matlab_code_tpu.utils.datagen import create_coupled_data
    spec = ProblemSpec(
        mode_sizes=(64, 128, 96),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=8),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"), None, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1] * 8], noise=0.01,
        distr=["rand", "randn", "randn"], rng=0)
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       lambdas_init=((1,) * 8,))
    states = [init_coupled(spec, data, init, key=k) for k in range(n_starts)]
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    proxes, reg_fns = build_proxes(spec)
    step = make_outer_step(spec, AlgOptions(MaxOuterIters=iters), proxes,
                           reg_fns, True)

    def one(state, data):
        grams, colnorms = init_cache(spec, state)

        def body(i, c):
            s, g, cn = c
            s, g, cn, *_ = step(s, data, g, cn)
            return (s, g, cn)
        return jax.lax.fori_loop(0, iters, body, (state, grams, colnorms))[0]

    run = jax.jit(jax.vmap(one, in_axes=(0, None)))
    jax.block_until_ready(run(batched, data))
    t0 = time.perf_counter()
    jax.block_until_ready(run(batched, data))
    dt = time.perf_counter() - t0
    return n_starts * iters / dt, n_starts / dt


def main():
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_large.py measures a GPU; JAX found {dev.platform!r}")
    peaks = device_peaks(dev.device_kind)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    def emit(metric, value, unit, **extra):
        print(json.dumps({"metric": metric, "value": value, "unit": unit,
                          "device": device, **extra}))

    spec, data, state, opts = large_problem()
    it_s = run_iters(spec, data, state, opts, 300)
    gb = sum(data.objects[p].nbytes for p in range(2)) / 1e9
    print(f"# large workload: {gb:.2f} GB data, rank 64")
    emit("aoadmm_iters_per_s_large_r64", it_s, "outer_iters/s")
    spec, data, state, opts = par2_problem()
    it_s = run_iters(spec, data, state, opts, 100)
    gb = data.objects[0].slices.nbytes / 1e9
    print(f"# PARAFAC2 workload: {gb:.2f} GB slices, K=512, rank 32")
    emit("aoadmm_iters_per_s_par2_k512_r32", it_s, "outer_iters/s")
    spec, data, state, opts = kl_problem()
    it_s, bound = run_iters(spec, data, state, opts, 60, peaks=peaks)
    gb = np.asarray(data.objects[0]).nbytes / 1e9
    print(f"# KL workload: {gb:.2f} GB counts, rank 8 (L-BFGS-B inner solves)")
    extra = {}
    if bound:
        bound_us, fl, by = bound
        extra = {"pct_of_roofline_bound": 100.0 * bound_us / (1e6 / it_s),
                 "bound_us_per_iter": bound_us, "flops_per_iter": fl,
                 "bytes_per_iter": by,
                 "bound_model": "max(XLA-cost FLOPs at the TF32 peak, "
                                "bytes at the HBM peak); conservative"}
    emit("aoadmm_iters_per_s_kl_lbfgsb", it_s, "outer_iters/s", **extra)
    spec, data, state, opts = sparse_problem()
    it_g = run_iters(spec, data, state, opts, 20)
    nnz = np.asarray(data.objects[0].values).size
    print(f"# sparse workload: {nnz/1e6:.1f}M nnz of 2048^3, rank 16 "
          f"(gather MTTKRP)")
    emit("aoadmm_iters_per_s_sparse_10Mnnz_gather", it_g, "outer_iters/s")
    # pairwise-perturbation accelerator on the convergent structured sparse
    # workload (models/pairwise.py): exact-cost data passes only on partial
    # rebuilds; vs_baseline = speedup over the exact gather path on the
    # SAME structured problem
    import dataclasses
    spec, data, state, opts = sparse_problem(structured=True)
    it_exact = run_iters(spec, data, state, opts, 20)
    opts_pp = dataclasses.replace(opts, cp_pairwise_perturbation=True,
                                  pp_start_tol=1.0, pp_refresh_tol=1e9)
    it_pp, act = run_iters_pp(spec, data, state, opts_pp, 40)
    print(f"# PP active fraction during timed sweeps: {act:.2f}")
    assert act > 0.9, "PP bench must measure PP-active sweeps"
    emit("aoadmm_iters_per_s_sparse_10Mnnz_pp", it_pp, "outer_iters/s",
         vs_baseline=it_pp / it_exact)
    tot, fits = multistart_throughput(iters=100)
    emit("multistart_sweeps_per_s", tot,
         "start-iterations/s (8 parallel fits)")


if __name__ == "__main__":
    main()
