"""Smoke run of the coupled AO-ADMM fit on one GPU, through `fit()`.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --four-cards   # four GPUs: fit(mesh=) vs fit() only

One process drives the card(s).  Each phase prints one line: what it ran,
the sizes, the matmul precision, compile and warm seconds and the result of
its check.  The last line is `{"ok": true, "device": {...}}`, printed only
when every phase passed; any failure exits non-zero without it.  On a
platform other than "gpu" the script exits 1 before running anything.

Phases (one GPU):
  flagship[highest|default]  script-15-class type-4 selector fusion (three
      datasets, ~103 MB f32, all modes nonneg) fitted to the script-15
      tolerances; fails only on non-finite output.
  par2       PARAFAC2, K=512 slices of 256x256, R=32, 50 outer iterations.
  large      rank-64 dense triple fusion (~0.55 GB), 20 outer iterations.
  parity     3 outer iterations of the flagship and of PAR2 with inner
      tolerances 0 (both sides run exactly MaxInnerIters) against the
      independent float64 numpy oracle (tests/oracle.py); gated at
      PARITY_RTOL under 'highest', reported under 'default'.
  gpu-tests  the tests marked `gpu` (tests/test_gpu.py), in this process.

The compile cache lives in $JAX_COMPILATION_CACHE_DIR, else in
<checkout>/.jax_cache; a second run of this script compiles less.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# f32 parity bound, relative: unit roundoff u = 6e-8, MTTKRP sums over up to
# 1.3e5 positive terms (tree reductions: growth ~log2 n = 17), and the ADMM
# normal-equation solves amplify by their condition number (~1e2 for these
# Gram-Hadamard + rho/2 I systems) over 3 outer x 5 inner iterations:
# 6e-8 * 17 * 1e2 * 5 ~ 5e-4.
PARITY_RTOL = 5e-4
# fit(mesh=) against fit() on one card: the psum changes only the reduction
# order, as in __graft_entry__._dryrun_pass's float32 tolerance.
MESH_RTOL = 1e-4

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration",
                   "/jax/compilation_cache/cache_retrieval_time_sec")
_compile_s = [0.0]


def _on_duration(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration


def report(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def _oracle():
    """tests/oracle.py, loaded by path: another installed package may own
    the top-level name `tests`."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "oracle.py")
    spec = importlib.util.spec_from_file_location("aoadmm_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finite(tree):
    import jax
    return all(bool(np.all(np.isfinite(np.asarray(x))))
               for x in jax.tree.leaves(tree))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def timed_fit(spec, data, state, opts, **kw):
    """fit() twice: cold (with compile) and warm.  Returns (state, out,
    cold_s, warm_s, compile_s)."""
    from matlab_code_tpu.models.solver import fit
    c0 = _compile_s[0]
    t0 = time.perf_counter()
    st, out = fit(spec, data, state, opts, validate=False, **kw)
    cold = time.perf_counter() - t0
    compile_s = _compile_s[0] - c0
    t0 = time.perf_counter()
    st, out = fit(spec, data, state, opts, validate=False, **kw)
    return st, out, cold, time.perf_counter() - t0, compile_s


# ---------------------------------------------------------------------------
# parity against the float64 numpy oracle
# ---------------------------------------------------------------------------


def _parity_opts(opts, T, precision):
    return dataclasses.replace(
        opts, MaxOuterIters=T, AbsFuncTol=0.0, OuterRelTol=0.0,
        innerRelPrTol_coupl=0.0, innerRelPrTol_constr=0.0,
        innerRelDualTol_coupl=0.0, innerRelDualTol_constr=0.0,
        TimeAtItChunk=0, matmul_precision=precision)


def flagship_parity(spec, data, state0, Hs, opts, T=3,
                    precision="highest") -> dict:
    """T outer iterations of a type-4 selector-coupled CP fusion through
    fit() on the default device and through tests/oracle.OracleCoupledH in
    float64 on the host, from the same init.  Returns the largest relative
    deviations: 'factors' (every factor and Delta, Frobenius) and
    'objective' (f_tensors and f_couplings per iteration)."""
    from matlab_code_tpu.models.solver import fit
    OracleCoupledH = _oracle().OracleCoupledH
    o = _parity_opts(opts, T, precision)
    st, out = fit(spec, data, state0, o, validate=False)
    Xs = [np.asarray(X, np.float64) for X in data.objects]
    coupled = [m for m in range(spec.nb_modes)
               if spec.coupling.lin_coupled_modes[m]]
    orc = OracleCoupledH(
        Xs=Xs, modes=[ds.modes for ds in spec.datasets],
        weights=[ds.weight for ds in spec.datasets], ctype=4,
        Hs={m: np.asarray(H, np.float64) for m, H in zip(coupled, Hs)},
        constrained={m for m in range(spec.nb_modes)
                     if spec.is_constrained(m)}, state=state0)
    znorms = [float(np.sum(X * X)) for X in Xs]
    traj = []
    for _ in range(T):
        orc.sweep(o)
        traj.append(orc.objective(znorms))
    traj = np.asarray(traj)
    fac = max(_rel(st.fac[m], orc.base.fac[m]) for m in range(spec.nb_modes))
    fac = max(fac, _rel(st.coupling_fac[0], orc.base.Delta))
    obj = max(float(np.max(np.abs(got[1:] - ref) / np.abs(ref)))
              for got, ref in ((out.func_val_conv, traj[:, 0]),
                               (out.func_coupl_conv, traj[:, 1])))
    return {"factors": fac, "objective": obj}


def par2_parity(spec, data, state0, opts, T=3, precision="highest") -> dict:
    """T outer iterations of a single PARAFAC2 dataset through fit() and
    through tests/oracle.OracleParafac2 in float64.  Compares quantities that
    do not depend on the P_k sign conventions: A, C, every B_k, the
    objective and the PAR2 coupling stream."""
    from matlab_code_tpu.models.solver import fit
    OracleParafac2 = _oracle().OracleParafac2
    o = _parity_opts(opts, T, precision)
    st, out = fit(spec, data, state0, o, validate=False)
    slices = np.asarray(data.objects[0].slices, np.float64)
    orc = OracleParafac2(list(slices), state0, weight=spec.datasets[0].weight)
    znorm = float(np.sum(slices * slices))
    traj = []
    for _ in range(T):
        orc.sweep(o)
        traj.append(orc.objective(znorm))
    traj = np.asarray(traj)
    fac = max(_rel(st.fac[0], orc.A), _rel(st.fac[2], orc.C),
              _rel(st.fac[1], np.stack(orc.B)))
    obj = max(float(np.max(np.abs(got[1:] - ref) / np.abs(ref)))
              for got, ref in ((out.func_val_conv, traj[:, 0]),
                               (out.func_PAR2_coupl, traj[:, 1])))
    return {"factors": fac, "objective": obj}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_flagship(problem):
    spec, data, state, opts, _ = problem
    for prec in ("highest", "default"):
        o = dataclasses.replace(opts, MaxOuterIters=12000, AbsFuncTol=1e-4,
                                OuterRelTol=1e-10, TimeAtItChunk=0,
                                matmul_precision=prec)
        st, out, cold, warm, comp = timed_fit(spec, data, state, o)
        ok = np.isfinite(out.f_tensors) and _finite(st.fac)
        # per-stream verdicts (f_tensors/f_couplings/f_constraints/f_PAR2)
        exit_flag = ("/".join(out.exit_flag.values())
                     if isinstance(out.exit_flag, dict)
                     else json.dumps(out.exit_flag))
        report(f"flagship[{prec}]",
               sizes="128x512x256+128x1024x64+128x4096,R=16/20/20,type4",
               precision=prec, compile_s=f"{comp:.2f}",
               cold_s=f"{cold:.2f}", warm_s=f"{warm:.3f}",
               iters=out.OuterIterations, exit=exit_flag,
               f_tensors=f"{out.f_tensors:.6e}",
               reached_tol=out.f_tensors < 1e-4,
               result="finite" if ok else "NON-FINITE")
        if not ok:
            raise RuntimeError(f"flagship[{prec}] produced non-finite output")


def phase_par2(problem):
    from matlab_code_tpu.options import resolve_auto
    spec, data, state, opts = problem
    o = dataclasses.replace(opts, MaxOuterIters=50, AbsFuncTol=0.0,
                            OuterRelTol=0.0, TimeAtItChunk=0)
    st, out, cold, warm, comp = timed_fit(spec, data, state, o)
    r = resolve_auto(o)
    ok = np.isfinite(out.f_tensors) and _finite(st.fac)
    report("par2", sizes="K=512,256x256,R=32", precision="default",
           inner_solve=r.inner_solve, par2_polar=r.par2_polar,
           compile_s=f"{comp:.2f}", cold_s=f"{cold:.2f}",
           warm_s=f"{warm:.3f}", it_per_s=f"{50 / warm:.1f}",
           f_tensors=f"{out.f_tensors:.6e}",
           result="finite" if ok else "NON-FINITE")
    if not ok:
        raise RuntimeError("par2 produced non-finite output")


def phase_large():
    import bench_large
    spec, data, state, opts = bench_large.large_problem()
    o = dataclasses.replace(opts, MaxOuterIters=20, AbsFuncTol=0.0,
                            OuterRelTol=0.0, TimeAtItChunk=0)
    st, out, cold, warm, comp = timed_fit(spec, data, state, o)
    ok = np.isfinite(out.f_tensors) and _finite(st.fac)
    gb = sum(X.nbytes for X in data.objects) / 1e9
    report("large", sizes=f"256x1024x512+256x8192,R=64,{gb:.2f}GB",
           precision="default", compile_s=f"{comp:.2f}",
           cold_s=f"{cold:.2f}", warm_s=f"{warm:.3f}",
           it_per_s=f"{20 / warm:.1f}", f_tensors=f"{out.f_tensors:.6e}",
           result="finite" if ok else "NON-FINITE")
    if not ok:
        raise RuntimeError("large produced non-finite output")


def phase_parity(flag, par2):
    spec, data, state, opts, Hs = flag
    res = {}
    for prec in ("highest", "default"):
        t0 = time.perf_counter()
        res[prec] = (flagship_parity(spec, data, state, Hs, opts,
                                     precision=prec),
                     par2_parity(*par2, precision=prec))
        report(f"parity[{prec}]", sizes="flagship+PAR2-K512,T=3,inner=5",
               precision=prec, seconds=f"{time.perf_counter() - t0:.1f}",
               flagship=json.dumps(res[prec][0]),
               par2=json.dumps(res[prec][1]),
               gate=(f"<= {PARITY_RTOL}" if prec == "highest"
                     else "reported only"))
    worst = max(max(d.values()) for d in res["highest"])
    if worst > PARITY_RTOL:
        raise RuntimeError(f"parity at 'highest' off by {worst:.3e} > "
                           f"{PARITY_RTOL}")


def phase_gpu_tests():
    import pytest

    class Count:
        passed, failed, skipped = 0, 0, 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1
            elif report.failed:
                Count.failed += 1
            elif report.skipped:
                Count.skipped += 1

    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", "tests/test_gpu.py"],
                     plugins=[Count()])
    report("gpu-tests", tests="tests/test_gpu.py -m gpu",
           passed=Count.passed, failed=Count.failed, skipped=Count.skipped,
           seconds=f"{time.perf_counter() - t0:.1f}")
    if rc != 0 or Count.failed or Count.skipped or not Count.passed:
        raise RuntimeError(f"gpu tests: rc={rc}")


def phase_four_cards():
    """fit(mesh=) over a 4-device mesh against fit() on one card, bulk psum
    and ring-pipelined collectives; then the nnz-partitioned sparse path."""
    import jax
    import bench
    import __graft_entry__ as ge
    from matlab_code_tpu.parallel.sharding import (
        make_mesh, data_shardings, state_shardings)
    spec, data, state, opts, _ = bench.build_problem()
    o = dataclasses.replace(opts, MaxOuterIters=5, AbsFuncTol=0.0,
                            OuterRelTol=0.0, TimeAtItChunk=0,
                            matmul_precision="highest")
    st_ref, out_ref, cold, warm, comp = timed_fit(spec, data, state, o)
    report("one-card", sizes="flagship,T=5", precision="highest",
           device=str(st_ref.fac[0].sharding.device_set),
           compile_s=f"{comp:.2f}", warm_s=f"{warm:.3f}")
    mesh = make_mesh(4)
    data_sh, sharded = data_shardings(spec, data, mesh)
    d_sh = jax.device_put(data, data_sh)
    s_sh = jax.device_put(state, state_shardings(spec, state, mesh, sharded))
    shard_devs = [sorted(s.device.id for s in X.addressable_shards)
                  for X in d_sh.objects]
    shard_shapes = [X.addressable_shards[0].data.shape for X in d_sh.objects]
    if any(d != [0, 1, 2, 3] for d in shard_devs):
        raise RuntimeError(f"data shards not on four devices: {shard_devs}")
    for pipelined in (False, True):
        om = dataclasses.replace(o, mesh_pipelined_collectives=pipelined)
        st, out, cold, warm, comp = timed_fit(spec, d_sh, s_sh, om,
                                              mesh=mesh)
        fac = max(_rel(st.fac[m], st_ref.fac[m])
                  for m in range(spec.nb_modes))
        obj = float(np.max(np.abs(out.func_val_conv - out_ref.func_val_conv)
                           / np.abs(out_ref.func_val_conv)))
        out_devs = sorted({d.id for d in st.fac[0].sharding.device_set})
        report(f"four-cards[pipelined={pipelined}]", sizes="flagship,T=5",
               precision="highest", data_shard_devices=shard_devs,
               data_shard_shapes=shard_shapes, factor_devices=out_devs,
               compile_s=f"{comp:.2f}", warm_s=f"{warm:.3f}",
               factors_rel=f"{fac:.3e}", objective_rel=f"{obj:.3e}",
               gate=f"<= {MESH_RTOL}")
        if max(fac, obj) > MESH_RTOL or out_devs != [0, 1, 2, 3]:
            raise RuntimeError(f"fit(mesh=) pipelined={pipelined} differs "
                               f"from fit(): {fac:.3e}, {obj:.3e}, "
                               f"{out_devs}")
    t0 = time.perf_counter()
    ge._dryrun_sparse(4, MESH_RTOL)
    report("four-cards[sparse]", sizes="12x11x10 COO, nnz/4 per device",
           precision="default", tolerance=MESH_RTOL, result="match",
           seconds=f"{time.perf_counter() - t0:.1f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only fit(mesh=) over four GPUs against fit()")
    args = ap.parse_args(argv)
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found platform "
              f"{dev.platform!r} ({dev.device_kind})", file=sys.stderr)
        return 1
    n_need = 4 if args.four_cards else 1
    if len(jax.devices()) < n_need:
        print(f"chip_smoke: needs {n_need} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 1
    import bench
    from matlab_code_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    report("card", nvidia_smi=json.dumps(smi.splitlines()),
           device_kind=json.dumps(dev.device_kind),
           jax=jax.__version__, devices=len(jax.devices()),
           xla_flags=json.dumps(os.environ.get("XLA_FLAGS", "")),
           compile_cache=cache)
    t_start = time.perf_counter()
    failed = []

    def run(name, fn, *a):
        try:
            fn(*a)
        except Exception as e:          # report every phase, then fail
            traceback.print_exc()
            report(name, result=f"FAILED {type(e).__name__}: {e}")
            failed.append(name)

    if args.four_cards:
        run("four-cards", phase_four_cards)
    else:
        flag = bench.build_problem()
        run("flagship", phase_flagship, flag)
        par2 = bench.build_problem_par2()
        run("par2", phase_par2, par2)
        run("large", phase_large)
        run("parity", phase_parity, flag, par2)
        del flag, par2
        run("gpu-tests", phase_gpu_tests)
    report("total", seconds=f"{time.perf_counter() - t_start:.1f}",
           failed=failed or "none")
    if failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
