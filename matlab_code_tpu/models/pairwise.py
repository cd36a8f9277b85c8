"""Pairwise-perturbation MTTKRP acceleration (Ma & Solomonik,
arXiv:2010.12056) for 3-way Frobenius CP datasets.

The MTTKRP is the only per-sweep operation that reads the data tensor; once
the factors move slowly (late ALS/AO-ADMM sweeps), it can be evaluated to
FIRST ORDER from cached *pairwise partials* — the data tensor contracted
with one reference factor:

    T01[i,j,r] = sum_k X[i,j,k] Cr[k,r]      (and T02, T12 analogously)

    M0 ~ sum_j T01[i,j,r] B[j,r]  +  sum_k T02[i,k,r] (C - Cr)[k,r]
    M1 ~ sum_i T01[i,j,r] A[i,r]  +  sum_k T12[j,k,r] (C - Cr)[k,r]
    M2 ~ sum_i T02[i,k,r] A[i,r]  +  sum_j T12[j,k,r] (B - Br)[j,r]

with error O(||dF||^2) per MTTKRP — each evaluation is dense einsums over
(D_a, D_b, R) partials instead of a pass over the data.  The win is largest
for sparse COO tensors, whose exact data pass is a gather and scatter-add
over every nonzero.

Gating (this module's policy, options.pp_start_tol / pp_refresh_tol):
sweeps run EXACT until the sweep-over-sweep factor step falls below
pp_start_tol; then the partials are built and sweeps switch to PP; the
partials are rebuilt (one exact-cost pass) whenever the accumulated
perturbation vs the reference factors exceeds pp_refresh_tol.  As the fit
converges the perturbation shrinks, so rebuilds stop and the approximation
error vanishes — PP-accelerated fits reach the same solutions (pinned by
tests/test_pairwise.py).

APPROXIMATE and opt-in (`AlgOptions.cp_pairwise_perturbation`); the exact
MTTKRP (ops/tensor.mttkrp: einsum or sparse gather, cmtf_fun_AOADMM.m:97)
remains the default and the golden/oracle-parity contract.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from matlab_code_tpu.ops.tensor import mttkrp
from matlab_code_tpu.options import AlgOptions
from matlab_code_tpu.problem import ProblemSpec, ProblemData, SparseTensor, CP

HP = lax.Precision.HIGHEST   # keep PP einsum error at O(d^2), not TF32


def eligible_pp_datasets(spec: ProblemSpec, data: ProblemData,
                         options: AlgOptions, mesh=None) -> tuple:
    """Datasets the PP approximation applies to: 3-way CP, Frobenius loss,
    no missing mask (EM imputation mutates the data each iteration, which
    would silently stale the partials).  Disabled under an explicit mesh
    (the partials are unsharded; combine with fit(mesh=) is future work)."""
    if not options.cp_pairwise_perturbation or mesh is not None:
        return ()
    out = []
    for p, ds in enumerate(spec.datasets):
        if ds.model != CP or len(ds.modes) != 3 or ds.loss != "Frobenius":
            continue
        if data.miss and data.miss[p] is not None:
            continue
        X = data.objects[p]
        if not (isinstance(X, SparseTensor) or getattr(X, "ndim", 0) == 3):
            continue
        out.append(p)
    return tuple(out)


def _zeros_like_partials(spec, data, p):
    ds = spec.datasets[p]
    I, J, K = (spec.mode_sizes[m] for m in ds.modes)
    R = ds.rank
    X = data.objects[p]
    dt = (X.values if isinstance(X, SparseTensor) else X).dtype
    return (jnp.zeros((I, J, R), dt), jnp.zeros((I, K, R), dt),
            jnp.zeros((J, K, R), dt))


def pp_init(spec: ProblemSpec, data: ProblemData, state,
            pp_datasets: tuple) -> dict:
    """{p: cache} for the eligible datasets: zero partials, refs = current
    factors, inactive and unseeded (the first sweep only records refs)."""
    caches = {}
    for p in pp_datasets:
        ds = spec.datasets[p]
        T01, T02, T12 = _zeros_like_partials(spec, data, p)
        caches[p] = {
            "T01": T01, "T02": T02, "T12": T12,
            "ref0": state.fac[ds.modes[0]],
            "ref1": state.fac[ds.modes[1]],
            "ref2": state.fac[ds.modes[2]],
            "active": jnp.bool_(False),
            "seeded": jnp.bool_(False),
        }
    return caches


def _build_partials(spec, data, p, refs):
    """T01/T02/T12 from the data tensor and reference factors (one exact
    data pass per partial; the sparse path is the gather/segment-sum class,
    amortized over the PP sweeps between rebuilds)."""
    ds = spec.datasets[p]
    X = data.objects[p]
    r0, r1, r2 = refs
    if isinstance(X, SparseTensor):
        idx, val = X.indices, X.values
        I, J, K = (spec.mode_sizes[m] for m in ds.modes)

        def part(a, b, F, c, Da, Db):
            contrib = val[:, None] * F[idx[:, c]]
            seg = idx[:, a].astype(jnp.int64) * Db + idx[:, b] \
                if Da * Db > 2**31 - 1 else idx[:, a] * Db + idx[:, b]
            out = jax.ops.segment_sum(contrib, seg, num_segments=Da * Db)
            return out.reshape(Da, Db, -1)

        return (part(0, 1, r2, 2, I, J), part(0, 2, r1, 1, I, K),
                part(1, 2, r0, 0, J, K))
    return (jnp.einsum("ijk,kr->ijr", X, r2, precision=HP),
            jnp.einsum("ijk,jr->ikr", X, r1, precision=HP),
            jnp.einsum("ijk,ir->jkr", X, r0, precision=HP))


def pp_sweep_update(spec: ProblemSpec, data: ProblemData, state, p: int,
                    cache: dict, options: AlgOptions) -> dict:
    """Sweep-start gating: measure the relative factor perturbation vs the
    cached references and (a) enter PP / rebuild the partials when the
    policy says so, or (b) keep tracking.  Runs under lax.cond so the
    expensive rebuild executes only when taken."""
    ds = spec.datasets[p]
    facs = tuple(state.fac[m] for m in ds.modes)
    ds_d = []
    for i in range(3):
        ref = cache[f"ref{i}"]
        den = jnp.maximum(jnp.linalg.norm(ref), 1e-300)
        ds_d.append(jnp.linalg.norm(facs[i] - ref) / den)
    d = jnp.max(jnp.stack(ds_d))
    build = cache["seeded"] & jnp.where(
        cache["active"],
        d > options.pp_refresh_tol,   # active: refresh on drift
        d < options.pp_start_tol)     # inactive: enter PP once steps small

    def build_branch(_):
        T01, T02, T12 = _build_partials(spec, data, p, facs)
        return {"T01": T01, "T02": T02, "T12": T12,
                "ref0": facs[0], "ref1": facs[1], "ref2": facs[2],
                "active": jnp.bool_(True), "seeded": jnp.bool_(True)}

    def track_branch(_):
        keep = cache["active"]   # active: refs pin the partials; else track
        return {"T01": cache["T01"], "T02": cache["T02"],
                "T12": cache["T12"],
                "ref0": jnp.where(keep, cache["ref0"], facs[0]),
                "ref1": jnp.where(keep, cache["ref1"], facs[1]),
                "ref2": jnp.where(keep, cache["ref2"], facs[2]),
                "active": cache["active"], "seeded": jnp.bool_(True)}

    return lax.cond(build, build_branch, track_branch, None)


def pp_mttkrp(spec, X, facs, p, cache, local, options):
    """Mode-`local` MTTKRP of dataset p at the CURRENT factors `facs`:
    first-order PP evaluation when active, exact dispatch otherwise."""
    A, B, C = facs

    def pp_eval(_):
        if local == 0:
            return (jnp.einsum("ijr,jr->ir", cache["T01"], B, precision=HP)
                    + jnp.einsum("ikr,kr->ir", cache["T02"],
                                 C - cache["ref2"], precision=HP))
        if local == 1:
            return (jnp.einsum("ijr,ir->jr", cache["T01"], A, precision=HP)
                    + jnp.einsum("jkr,kr->jr", cache["T12"],
                                 C - cache["ref2"], precision=HP))
        return (jnp.einsum("ikr,ir->kr", cache["T02"], A, precision=HP)
                + jnp.einsum("jkr,jr->kr", cache["T12"],
                             B - cache["ref1"], precision=HP))

    def exact_eval(_):
        return mttkrp(X, list(facs), local)

    return lax.cond(cache["active"], pp_eval, exact_eval, None)
