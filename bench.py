"""Benchmark: AO-ADMM iterations/s on the FLAGSHIP workload — the
EEM/NMR/LCMS configuration of example_script15 (three datasets sharing the
sample mode through a TYPE-4 selector coupling C_i = Delta H_i, all modes
nonneg), scaled to production size, on one GPU.  This exercises the
normal-equation Delta solve (cmtf_fun_AOADMM.m:904-983) that the real
workload pays for, not the cheap type-0 average path.

Run: `python bench.py` (one process, one GPU; exits non-zero on any other
platform).  Prints ONE JSON line {"metric", "value", "unit", "vs_baseline",
"device"} plus supporting lines (secondary type-0 workload, MTTKRP rates,
PARAFAC2, fit to tolerance).  vs_baseline is the speedup over a pure-numpy
CPU implementation of the identical sweep on the same host (the reference
publishes no numbers, BASELINE.md).  Every rate is printed beside the
device it was measured on; nothing is substituted for a missing run.
"""
import dataclasses
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import (
    build_proxes, make_outer_step, init_cache, fit)
from matlab_code_tpu.ops.tensor import mttkrp
from matlab_code_tpu.utils.compile_cache import enable_compile_cache
from matlab_code_tpu.utils.profiling import device_peaks

# flagship (script-15-class, type-4 selector coupling):
#   EEM-like   S x 512 x 256 3-way, rank 16 of 24 latent
#   NMR-like   S x 1024 x 64 3-way, rank 20 of 24 latent
#   LCMS-like  S x 4096 matrix,     rank 20 of 24 latent
S = 128
RTOT = 24
R1, R2, R3 = 16, 20, 20
# in-jit iterations per timed call (one dispatch and one sync per call)
N_ITERS = 300


def _selectors(rng):
    """Column-selector H_i (RTOT, R_i) like example_script15:47-51."""
    H1 = np.zeros((RTOT, R1))
    H1[np.arange(R1), np.arange(R1)] = 1.0
    H2 = np.zeros((RTOT, R2))
    H2[np.arange(R2), np.arange(R2)] = 1.0
    H3 = np.zeros((RTOT, R3))
    # permuted/partial block like the reference's T matrix
    cols = rng.permutation(RTOT)[:R3]
    H3[cols, np.arange(R3)] = 1.0
    return H1, H2, H3


def _flagship_truth():
    """Small ground-truth factors + selectors, generated on HOST with a fixed
    rng.  Only these (< 1 MB) are copied to the device; the big data tensors
    are assembled ON DEVICE (bench) and independently on host (numpy
    baseline)."""
    rng = np.random.default_rng(0)
    dt = np.dtype(jnp.result_type(float).name)
    H1, H2, H3 = _selectors(rng)
    Delta = rng.uniform(size=(S, RTOT)).astype(dt)
    sizes = {1: 512, 2: 256, 4: 1024, 5: 64, 7: 4096}
    ranks = {1: R1, 2: R1, 4: R2, 5: R2, 7: R3}
    f = {m: rng.uniform(size=(sizes[m], ranks[m])).astype(dt)
         for m in (1, 2, 4, 5, 7)}
    return (H1.astype(dt), H2.astype(dt), H3.astype(dt)), Delta, f


def build_problem():
    NN = ConstraintSpec("non-negativity")
    spec = ProblemSpec(
        mode_sizes=(S, 512, 256, S, 1024, 64, S, 4096),
        datasets=(
            DatasetSpec(model="CP", modes=(0, 1, 2), rank=R1, weight=1 / 3),
            DatasetSpec(model="CP", modes=(3, 4, 5), rank=R2, weight=1 / 3),
            DatasetSpec(model="CP", modes=(6, 7), rank=R3, weight=1 / 3)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0, 1, 0),
                              coupling_type=(4,)),
        constraints=(NN,) * 8)
    (H1, H2, H3), Delta, f = _flagship_truth()

    @jax.jit
    def assemble(Delta, H1, H2, H3, f1, f2, f4, f5, f7):
        X1 = jnp.einsum("ir,jr,kr->ijk", Delta @ H1, f1, f2)
        X2 = jnp.einsum("ir,jr,kr->ijk", Delta @ H2, f4, f5)
        X3 = (Delta @ H3) @ f7.T
        return (X1 / jnp.linalg.norm(X1), X2 / jnp.linalg.norm(X2),
                X3 / jnp.linalg.norm(X3))

    X1, X2, X3 = assemble(*map(jnp.asarray, (Delta, H1, H2, H3, f[1], f[2],
                                             f[4], f[5], f[7])))
    from matlab_code_tpu.problem import ProblemData
    data = ProblemData(
        objects=(X1, X2, X3),
        coupl_trafo=(jnp.asarray(H1), None, None,
                     jnp.asarray(H2), None, None,
                     jnp.asarray(H3), None),
        coupl_trafo2=(None,) * 8)
    opts = AlgOptions(MaxOuterIters=N_ITERS, MaxInnerIters=5)
    init = InitOptions(distr=("rand",) * 8, normalize=True,
                       lambdas_init=((1,) * R1, (1,) * R2, (1,) * R3))
    state = init_coupled(spec, data, init, key=1)
    return spec, data, state, opts, (H1, H2, H3)


def build_problem_type0():
    """Secondary workload: round-1's type-0 exact-coupling config."""
    I, J1, J2, M1, M2, R = 128, 512, 256, 4096, 2048, 16
    spec = ProblemSpec(
        mode_sizes=(I, J1, J2, I, M1, I, M2),
        datasets=(
            DatasetSpec(model="CP", modes=(0, 1, 2), rank=R, weight=1 / 3),
            DatasetSpec(model="CP", modes=(3, 4), rank=R, weight=1 / 3),
            DatasetSpec(model="CP", modes=(5, 6), rank=R, weight=1 / 3)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 1, 0),
                              coupling_type=(0,)),
        constraints=tuple(ConstraintSpec("non-negativity") for _ in range(7)))
    rng = np.random.default_rng(0)
    dt = np.dtype(jnp.result_type(float).name)
    facs = [jnp.asarray(rng.uniform(size=(s, R)).astype(dt))
            for s in spec.mode_sizes]  # small; big tensors built ON DEVICE

    @jax.jit
    def assemble(f):
        return (jnp.einsum("ir,jr,kr->ijk", f[0], f[1], f[2]),
                f[3] @ f[4].T, f[5] @ f[6].T)

    X1, X2, X3 = assemble(facs)
    from matlab_code_tpu.problem import ProblemData
    data = ProblemData(objects=(X1, X2, X3),
                       coupl_trafo=(None,) * 7, coupl_trafo2=(None,) * 7)
    opts = AlgOptions(MaxOuterIters=N_ITERS, MaxInnerIters=5)
    init = InitOptions(distr=("rand",) * 7, normalize=True,
                       lambdas_init=((1,) * R,) * 3)
    state = init_coupled(spec, data, init, key=1)
    return spec, data, state, opts


def bench_sweeps(spec, data, state, opts, measure_mttkrp=True):
    proxes, reg_fns = build_proxes(spec)
    step = make_outer_step(spec, opts, proxes, reg_fns, True)
    grams, colnorms = init_cache(spec, state)

    @jax.jit
    def n_steps(state, data, grams, colnorms):
        def body(i, c):
            state, grams, colnorms = c
            state, grams, colnorms, *_ = step(state, data, grams, colnorms)
            return (state, grams, colnorms)
        return jax.lax.fori_loop(0, N_ITERS, body, (state, grams, colnorms))

    out = jax.block_until_ready(n_steps(state, data, grams, colnorms))
    dt_iter = np.inf                              # best of 3
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(n_steps(state, data, grams, colnorms))
        dt_iter = min(dt_iter, (time.perf_counter() - t0) / N_ITERS)
    assert bool(jnp.all(jnp.isfinite(out[0].fac[0])))
    if not measure_mttkrp:
        return 1.0 / dt_iter, None, out[0]

    # MTTKRP throughput on the big tensor — loop INSIDE jit with a
    # jnp.sum data dependency between iterations, so per-call dispatch does
    # not enter the timing.  This 67 MB tensor is near the 50 MB L2 of an
    # H100; bench_mttkrp_hbm measures the device-memory-bound case.
    X = data.objects[0]
    p0 = spec.datasets[0]
    facs = [out[0].fac[m] for m in p0.modes]
    reps = 50

    @jax.jit
    def mtt_loop(X, facs):
        def body(i, c):
            b, c2, acc = c
            A0 = mttkrp(X, [facs[0], b, c2], 0)
            s = jnp.sum(A0)   # consume ALL of A0 so XLA cannot slice X
            return (b + 1e-30 * s, c2 + 1e-30 * s, acc + s)
        return jax.lax.fori_loop(
            0, reps, body, (facs[1], facs[2], jnp.zeros((), X.dtype)))

    jax.block_until_ready(mtt_loop(X, facs))
    t_mtt = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(mtt_loop(X, facs))
        t_mtt = min(t_mtt, (time.perf_counter() - t0) / reps)
    I, J1, J2 = X.shape
    R = p0.rank
    flops = 2 * I * J1 * J2 * R + 2 * I * J1 * R  # contraction chain
    return 1.0 / dt_iter, flops / t_mtt / 1e9, out[0]


def bench_mttkrp_hbm():
    """Roofline witness (BASELINE.md: MTTKRP >= 70% of HBM peak): mode-0
    einsum MTTKRP on a 537 MB tensor (256,1024,512) f32, R=16, generated ON
    DEVICE — ten times an H100's 50 MB L2, so every pass reads device
    memory.  In-jit loop with jnp.sum feedback so XLA can neither hoist nor
    slice X.  Returns GB/s."""
    I, J, K, R = 256, 1024, 512, 16
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    X = jax.random.normal(ks[0], (I, J, K), jnp.float32)
    B = jax.random.normal(ks[1], (J, R), jnp.float32)
    C = jax.random.normal(ks[2], (K, R), jnp.float32)
    jax.block_until_ready(X)
    reps = 60

    @jax.jit
    def loop(X, B, C):
        def body(i, c):
            B, C, acc = c
            A0 = jnp.einsum("ijk,jr,kr->ir", X, B, C, optimize=True)
            s = jnp.sum(A0)
            return (B + 1e-30 * s, C + 1e-30 * s, acc + s)
        return jax.lax.fori_loop(0, reps, body, (B, C, jnp.float32(0)))

    jax.block_until_ready(loop(X, B, C))
    best = np.inf
    for _ in range(6):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(X, B, C))
        best = min(best, (time.perf_counter() - t0) / reps)
    return X.size * 4 / 1e9 / best


def build_problem_par2():
    """PARAFAC2 production workload (K=512 slices of 256x256, R=32, nonneg
    A/C) — the K-batched ADMM_B_Parafac2 sweep (cmtf_fun_AOADMM.m:509-589)
    at the scale BASELINE.md tracks.  Data generated ON DEVICE."""
    from matlab_code_tpu.problem import ProblemData, Parafac2Tensor
    I, J, K, R = 256, 256, 512, 32
    spec = ProblemSpec(
        mode_sizes=(I, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=R),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"), None,
                     ConstraintSpec("non-negativity")))
    rng = np.random.default_rng(0)
    dt = jnp.result_type(float)
    A = jnp.asarray(rng.uniform(size=(I, R)).astype(dt))
    C = jnp.asarray(rng.uniform(0.5, 1.5, size=(K, R)).astype(dt))
    B = jnp.asarray(rng.standard_normal((K, J, R)).astype(dt))
    X = jax.jit(lambda A, C, B: jnp.einsum("ir,kr,kjr->kij", A, C, B))(
        A, C, B)
    data = ProblemData(
        objects=(Parafac2Tensor(slices=X, mask=jnp.ones((K, J), bool)),),
        coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    opts = AlgOptions(MaxOuterIters=100, MaxInnerIters=5)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1,) * R,))
    state = init_coupled(spec, data, init, key=1)
    return spec, data, state, opts


def _roofline_bound_us(compiled, n_iters, peaks, flops_key="tf32_flops"):
    """Per-iteration roofline lower bound (us) for a compiled n_iters-loop
    program, from XLA's own post-fusion cost model: bound = max(FLOPs at
    the `flops_key` peak, bytes at HBM peak) of `peaks`
    (utils/profiling.device_peaks).

    XLA's HloCostAnalysis visits every loop BODY once regardless of trip
    count, so the fori_loop program's totals already equal ~one outer
    iteration (verified against a hand count for the PAR2 K=512 sweep:
    3 x 2KIJR = 6.4 GFLOP of X-contractions + ~1.9 GFLOP of R-sized
    batched algebra vs 8.09 reported) — with the residual-driven INNER
    ADMM while-bodies also counted once instead of up to MaxInnerIters
    times, which only loosens the lower bound.  'bytes accessed' counts
    each fused op's operands/outputs, so cache reuse makes it an
    overestimate of HBM traffic (tightens nothing: the bound stays a
    bound; the printed '% of bound' is regression accountability, not a
    speed-of-light certificate).  Returns (bound_us,
    flops_per_iter, bytes_per_iter) or None when the backend exposes no
    cost analysis.  n_iters is unused (kept for call-site clarity)."""
    del n_iters
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        flops = float(ca["flops"])
        byts = float(ca["bytes accessed"])
    except Exception:
        return None
    bound = max(flops / peaks[flops_key], byts / peaks["hbm_bytes_per_s"])
    return bound * 1e6, flops, byts


def bench_par2(spec, data, state, opts, peaks, n_iters=100):
    proxes, reg_fns = build_proxes(spec)
    step = make_outer_step(spec, opts, proxes, reg_fns, True)
    grams, colnorms = init_cache(spec, state)

    def n_steps(state, data, grams, colnorms):
        def body(i, c):
            s, g, cn = c
            s, g, cn, *_ = step(s, data, g, cn)
            return (s, g, cn)
        return jax.lax.fori_loop(0, n_iters, body, (state, grams, colnorms))

    jitted = jax.jit(n_steps)
    compiled = jitted.lower(state, data, grams, colnorms).compile()
    bound = _roofline_bound_us(compiled, n_iters, peaks)
    out = jax.block_until_ready(compiled(state, data, grams, colnorms))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(state, data, grams, colnorms))
        best = min(best, (time.perf_counter() - t0) / n_iters)
    assert bool(jnp.all(jnp.isfinite(out[0].fac[0])))
    return 1.0 / best, out[0], bound


def bench_numpy_baseline(spec, data, state, opts, Hs, iters=3):
    """Identical type-4 coupled sweep in pure numpy on host CPU."""
    nb = spec.nb_modes
    facs = [np.asarray(state.fac[m], np.float64) for m in range(nb)]
    Z = [np.asarray(state.constraint_fac[m], np.float64) for m in range(nb)]
    U = [np.asarray(state.constraint_dual_fac[m], np.float64)
         for m in range(nb)]
    Delta = np.asarray(state.coupling_fac[0], np.float64)
    muD = [np.asarray(state.coupling_dual_fac[m], np.float64)
           if state.coupling_dual_fac[m] is not None else None
           for m in range(nb)]
    # rebuild the data tensors on HOST from the same small truth factors
    (tH1, tH2, tH3), tDelta, tf = _flagship_truth()
    Xs = []
    for C, fa, fb in (((tDelta @ tH1), tf[1], tf[2]),
                      ((tDelta @ tH2), tf[4], tf[5])):
        X = np.einsum("ir,jr,kr->ijk", C.astype(np.float64),
                      fa.astype(np.float64), fb.astype(np.float64),
                      optimize=True)
        Xs.append(X / np.linalg.norm(X))
    X3 = (tDelta @ tH3).astype(np.float64) @ tf[7].astype(np.float64).T
    Xs.append(X3 / np.linalg.norm(X3))
    H = {0: Hs[0], 3: Hs[1], 6: Hs[2]}
    grams = [f.T @ f for f in facs]
    datasets = [((0, 1, 2), Xs[0], 1 / 3), ((3, 4, 5), Xs[1], 1 / 3),
                ((6, 7), Xs[2], 1 / 3)]
    coupled = (0, 3, 6)

    def np_mttkrp(X, modes, local):
        if X.ndim == 3:
            sub = "ijk"
            ops = [f"{sub[i]}r" for i in range(3) if i != local]
            eq = f"ijk,{ops[0]},{ops[1]}->{sub[local]}r"
            rest = [facs[m] for i, m in enumerate(modes) if i != local]
            return np.einsum(eq, X, *rest, optimize=True)
        other = modes[1 - local]
        return (X @ facs[other]) if local == 0 else (X.T @ facs[other])

    t0 = time.perf_counter()
    for _ in range(iters):
        # uncoupled constrained modes (cid 0)
        for modes, X, w in datasets:
            for local, m in enumerate(modes):
                if m in coupled:
                    continue
                R = facs[m].shape[1]
                A = w * np_mttkrp(X, modes, local)
                C = np.ones((R, R))
                for i, mm in enumerate(modes):
                    if i != local:
                        C *= grams[mm]
                rho = np.trace(C) / R
                B = w * C + rho * np.eye(R)
                for _inner in range(opts.MaxInnerIters):
                    Ai = A + rho / 2 * (Z[m] - U[m])
                    f = np.linalg.solve(B, Ai.T).T
                    Z[m] = np.maximum(f + U[m], 0)
                    U[m] = U[m] + f - Z[m]
                facs[m] = f
                grams[m] = f.T @ f
        # coupled modes: type-4 ADMM (cmtf_fun_AOADMM.m:904-983)
        pre = {}
        for modes, X, w in datasets:
            for local, m in enumerate(modes):
                if m not in coupled:
                    continue
                R = facs[m].shape[1]
                A = w * np_mttkrp(X, modes, local)
                C = np.ones((R, R))
                for i, mm in enumerate(modes):
                    if i != local:
                        C *= grams[mm]
                rho = np.trace(C) / R
                B = w * C + rho * np.eye(R)   # coupling + constraint terms
                pre[m] = (A, B, rho)
        for _inner in range(opts.MaxInnerIters):
            for m in coupled:
                A, B, rho = pre[m]
                Ai = A + rho / 2 * (Delta @ H[m] - muD[m]) \
                    + rho / 2 * (Z[m] - U[m])
                facs[m] = np.linalg.solve(B, Ai.T).T
            # Delta from normal equations AA = sum rho H H^T
            AA = sum(pre[m][2] * (H[m] @ H[m].T) for m in coupled)
            BB = sum(pre[m][2] * (facs[m] + muD[m]) @ H[m].T
                     for m in coupled)
            Delta = np.linalg.solve(AA.T, BB.T).T
            for m in coupled:
                muD[m] = muD[m] + facs[m] - Delta @ H[m]
                Z[m] = np.maximum(facs[m] + U[m], 0)
                U[m] = U[m] + facs[m] - Z[m]
        for m in coupled:
            grams[m] = facs[m].T @ facs[m]
    return (time.perf_counter() - t0) / iters


def main():
    """Every segment runs inline, in this one process; any failure raises."""
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    peaks = device_peaks(dev.device_kind)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"# device: {device}", flush=True)
    spec, data, state, opts, Hs = build_problem()
    iters_per_s, mttkrp_gflops, _ = bench_sweeps(spec, data, state, opts)
    print(f"# mttkrp_gflops_per_s: {mttkrp_gflops:.1f} (67 MB tensor, R=16)")

    gbs = bench_mttkrp_hbm()
    print(f"# mttkrp_hbm_gb_per_s: {gbs:.1f} (537 MB X, R=16; "
          f"{100 * gbs / (peaks['hbm_bytes_per_s'] / 1e9):.1f}% of the "
          f"{dev.device_kind} data-sheet HBM peak)", flush=True)

    sp2, d2, st2, op2 = build_problem_par2()
    par2_iters_per_s, _, bound = bench_par2(sp2, d2, st2, op2, peaks)
    del sp2, d2, st2, op2
    print(f"# par2_k512_iters_per_s: {par2_iters_per_s:.1f} "
          f"(K=512 256x256 slices, R=32, nonneg)", flush=True)
    if bound is not None:
        pct = 100.0 * bound[0] / (1e6 / par2_iters_per_s)
        print(f"# par2_k512_pct_of_bound: {pct:.1f} (bound {bound[0]:.0f} "
              f"us/iter = max(XLA-cost {bound[1] / 1e9:.2f} GFLOP/iter at "
              f"the TF32 peak, {bound[2] / 1e9:.2f} GB/iter at the HBM "
              f"peak); post-fusion bytes, conservative)")

    # full production fit() to tolerance on the flagship — the wall clock a
    # reference user pays (example_script15_realdata.m:101-135 protocol).
    # TimeAtItChunk=0: one fused dispatch; stopping runs on device.  Full
    # float32 matmuls: whether TF32 reaches this tolerance is measured by
    # chip_smoke.py.
    op_fit = dataclasses.replace(opts, MaxOuterIters=12000, AbsFuncTol=1e-4,
                                 OuterRelTol=1e-10, TimeAtItChunk=0,
                                 matmul_precision="highest")
    t0 = time.perf_counter()
    _, out_fit = fit(spec, data, state, op_fit, validate=False)
    cold = time.perf_counter() - t0
    _, out_warm = fit(spec, data, state, op_fit, validate=False)
    print(f"# fit_wallclock_s: {out_warm.time_total:.3f} warm, {cold:.1f} "
          f"cold incl. compile (flagship, tol 1e-4/1e-10, precision "
          f"'highest'); stopped at iter {out_fit.OuterIterations}, exit "
          f"{out_fit.exit_flag}", flush=True)

    np_iters_per_s = 1.0 / bench_numpy_baseline(spec, data, state, opts, Hs)
    print(f"# numpy_cpu_iters_per_s: {np_iters_per_s:.3f}")
    spec0, data0, state0, opts0 = build_problem_type0()
    iters_per_s_t0, _, _ = bench_sweeps(spec0, data0, state0, opts0,
                                        measure_mttkrp=False)
    print(f"# secondary_type0_iters_per_s: {iters_per_s_t0:.3f}")
    print(json.dumps({
        "metric": "aoadmm_iters_per_s_eem_nmr_lcms_type4",
        "value": iters_per_s,
        "unit": "outer_iters/s",
        "vs_baseline": iters_per_s / np_iters_per_s,
        "device": device,
    }))


if __name__ == "__main__":
    main()
