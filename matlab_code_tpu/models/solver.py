"""The AO-ADMM solver: outer alternating-optimization sweep + fit driver.

JAX equivalent of functions/cmtf_fun_AOADMM.m (outer loop :87-476) and
functions/cmtf_AOADMM.m (driver).  The whole outer loop runs as ONE jitted
lax.while_loop per (problem spec, options): problem structure — models,
coupling ids/types, constraint kinds, losses — is resolved at trace time, so
the compiled program is straight-line batched linear algebra (MTTKRP einsums,
batched Cholesky/SVD) with two nested lax.while_loops (outer AO + inner ADMM).

The `iter_start_PAR2Bkconstraint` knob (cmtf_fun_AOADMM.m:7-9, script 9)
changes program structure at a known iteration, so the fit is split into (at
most) two jitted phases with the Bk-constraint statically off/on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from matlab_code_tpu.problem import (
    ProblemSpec, ProblemData, CP, PAR2, check_data_input, has_missing)
from matlab_code_tpu.state import SolverState, tuple_set
from matlab_code_tpu.options import (
    AlgOptions, resolve_auto, with_matmul_precision)
from matlab_code_tpu.ops import losses
from matlab_code_tpu.ops.prox import make_prox
from matlab_code_tpu.ops.tensor import gram, ktensor_full
from matlab_code_tpu.ops.linalg import (
    chol_lower, solve_with_chol, solve_spd_left, rsolve, block_diag)
from matlab_code_tpu.models.updates import (
    ModePre, cp_mode_precompute, par2A_precompute, par2B_precompute,
    par2C_precompute, refresh_gram, par2_gram_Bk, nonfrob_rho,
    refresh_colnorm_init, refresh_colnorm_update)
from matlab_code_tpu.models.admm import (
    admm_constrained_only, admm_b_parafac2, admm_coupled, make_spd_solver,
    _chol_rcond_bad)
from matlab_code_tpu.models.objective import func_eval, par2_model_slices
from matlab_code_tpu.models.lbfgs_bridge import make_lbfgs_step


# ---------------------------------------------------------------------------
# trace-time builders
# ---------------------------------------------------------------------------


def build_proxes(spec: ProblemSpec):
    prox_fns = [None] * spec.nb_modes
    reg_fns = [None] * spec.nb_modes
    for m in range(spec.nb_modes):
        if spec.is_constrained(m):
            sz = spec.mode_sizes[m]
            if isinstance(sz, (tuple, list)):
                sz = sz[0]  # Bk mode: reference uses sz{m}(1) (constraints_to_prox.m:70)
            prox_fns[m], reg_fns[m] = make_prox(spec.constraints[m], sz)
    return tuple(prox_fns), tuple(reg_fns)


def init_cache(spec: ProblemSpec, state: SolverState):
    """Initial Grams / column norms (cmtf_fun_AOADMM.m:62-81)."""
    grams = []
    colnorms = []
    for m in range(spec.nb_modes):
        p = spec.which_p(m)
        ds = spec.datasets[p]
        role = spec.mode_role(m)
        if ds.loss == "Frobenius" and role in ("cp", "par2_A"):
            grams.append(gram(state.fac[m]))
            colnorms.append(0.0)
        elif ds.loss == "Frobenius" and role == "par2_B":
            grams.append(par2_gram_Bk(state.fac[m]))
            colnorms.append(0.0)
        elif ds.loss != "Frobenius":
            grams.append(None)
            colnorms.append(refresh_colnorm_init(state, m))
        else:  # par2_C: never consumed as a gram
            grams.append(None)
            colnorms.append(0.0)
    dt = state.fac[0].dtype
    return tuple(grams), jnp.asarray(
        [jnp.asarray(c, dt) for c in colnorms])


def compute_znorm_consts(spec: ProblemSpec, data: ProblemData,
                         options: AlgOptions):
    """Per-dataset data constants (cmtf_AOADMM.m:124-189)."""
    from matlab_code_tpu.problem import SparseTensor
    out = []
    for p, ds in enumerate(spec.datasets):
        X = data.objects[p]
        msk = data.miss[p]
        if ds.model == PAR2:
            Xs = jnp.where(msk, X.slices, 0.0) if msk is not None else X.slices
            out.append(jnp.sum(Xs * Xs))
        elif isinstance(X, SparseTensor):
            out.append(jnp.sum(X.values * X.values))
        else:
            out.append(losses.znorm_const(ds.loss, X, options.eps_log,
                                          ds.loss_param, msk))
    return tuple(out)


# ---------------------------------------------------------------------------
# the outer sweep (one AO iteration)
# ---------------------------------------------------------------------------


def make_outer_step(spec: ProblemSpec, options: AlgOptions, proxes, reg_fns,
                    bk_constraint_active: bool, mttkrp_impls=None,
                    pp_datasets=()):
    """mttkrp_impls: optional {(p, local_mode): fn} explicit-collective
    MTTKRPs (parallel/shard_mttkrp.py build_sharded_mttkrps).

    pp_datasets: datasets whose MTTKRPs go through the pairwise-perturbation
    approximation (models/pairwise.py, options.cp_pairwise_perturbation).
    When non-empty, outer_step takes a `pp` cache pytree as a sixth argument
    and returns it (updated) as a ninth output.

    'auto' options resolve here for callers that skip fit()."""
    options = resolve_auto(options)
    lbfgs_steps = {}
    for p, ds in enumerate(spec.datasets):
        if ds.loss != "Frobenius":
            for m in ds.modes:
                lbfgs_steps[m] = make_lbfgs_step(spec, p, m, options)
    adaptive = options.adaptive_rho_nonfrob and spec.has_non_frobenius()

    def outer_step(state, data, grams, colnorms, rho_scale=None, pp=None):
        """Returns (state, grams, colnorms, rho_scale, cached, inner_its,
        lbfgs_its, illcond[, pp])."""
        impls = mttkrp_impls
        if pp_datasets and pp is not None:
            from matlab_code_tpu.models.pairwise import (
                pp_sweep_update, pp_mttkrp)
            pp = {p: pp_sweep_update(spec, data, state, p, pp[p], options)
                  for p in pp_datasets}
            impls = dict(mttkrp_impls) if mttkrp_impls else {}
            for p in pp_datasets:
                for local in range(3):
                    impls[(p, local)] = (
                        lambda X, facs, p=p, local=local: pp_mttkrp(
                            spec, X, facs, p, pp[p], local, options))
        inner_its: dict[int, Any] = {}
        lbfgs_its: dict[int, Any] = {}
        cached: dict[int, Any] = {}
        partials: dict[int, Any] = {}   # per-sweep dimension-tree cache
        illc = jnp.bool_(False)

        def chol_checked(B):
            nonlocal illc
            L = chol_lower(B)
            if options.IllCondTol > 0:
                illc = illc | _chol_rcond_bad(L, options.IllCondTol)
            return L

        def spd_checked(B, lmin=None):
            """(right, rowleft) solver pair for an assembled SPD normal
            matrix, accumulating the ill-conditioning flag."""
            nonlocal illc
            right, rowleft, bad = make_spd_solver(
                B, options, illtol=options.IllCondTol, lmin=lmin)
            illc = illc | bad
            return right, rowleft

        def balance_rho(m, res):
            """Residual-balancing update of the per-mode rho factor (Boyd
            et al. 2011 sec 3.4.1) — extension, options.adaptive_rho_nonfrob."""
            nonlocal rho_scale
            if not adaptive:
                return
            pr, dr = res
            f = jnp.where(pr > 10.0 * dr, 2.0, jnp.where(dr > 10.0 * pr,
                                                         0.5, 1.0))
            rho_scale = rho_scale.at[m].set(
                jnp.clip(rho_scale[m] * f, 1e-6, 1e6))

        for cid in spec.coupling_ids():
            cmodes = spec.coupled_modes_of(cid)
            pres: dict[int, ModePre] = {}
            bmasks: dict[int, Any] = {}
            for p in sorted({spec.which_p(m) for m in cmodes}):
                ds = spec.datasets[p]
                p_modes = [m for m in cmodes if spec.which_p(m) == p]
                frob = ds.loss == "Frobenius"
                for m in p_modes:
                    role = spec.mode_role(m)
                    constrained = spec.is_constrained(m)
                    R = ds.rank
                    if role == "cp":
                        if frob:
                            impl = (impls or {}).get(
                                (p, ds.modes.index(m)))
                            pre = cp_mode_precompute(spec, data, state, grams,
                                                     p, m, options, partials,
                                                     mttkrp_impl=impl)
                            cached[p] = (pre.last_mttkrp, pre.last_had,
                                         ds.modes.index(m))
                        else:
                            rho_nf = nonfrob_rho(colnorms, m)
                            if adaptive:
                                rho_nf = rho_nf * rho_scale[m]
                            pre = ModePre(None, None, rho_nf, None, None)
                        if cid == 0:
                            if not constrained:
                                if frob:
                                    if options.IllCondTol > 0:
                                        # the unregularized normal matrix is
                                        # where MATLAB's nearlySingularMatrix
                                        # would fire (cmtf_fun_AOADMM.m:134)
                                        illc = illc | _chol_rcond_bad(
                                            chol_lower(pre.B),
                                            options.IllCondTol)
                                    fac = rsolve(pre.A, pre.B)
                                    state = state.replace(
                                        fac=tuple_set(state.fac, m, fac))
                                else:
                                    state, nit = lbfgs_steps[m](
                                        state, data, False, -1, pre.rho)
                                    lbfgs_its[m] = nit
                                inner_its[m] = jnp.int32(1)
                            else:
                                if frob:
                                    eye = jnp.eye(R, dtype=pre.A.dtype)
                                    solve, _ = spd_checked(
                                        pre.B + 0.5 * pre.rho * eye,
                                        lmin=0.5 * pre.rho)
                                else:
                                    solve = None
                                state, nin, lb, res = admm_constrained_only(
                                    spec, state, m, p, pre.A, solve, pre.rho,
                                    options, proxes,
                                    lbfgs_steps.get(m), data)
                                inner_its[m] = nin
                                if not frob:
                                    lbfgs_its[m] = lb
                                    balance_rho(m, res)
                            if frob:
                                grams = refresh_gram(spec, state, grams, m)
                            else:
                                colnorms = colnorms.at[m].set(
                                    refresh_colnorm_update(state, m))
                        else:
                            pres[m] = pre
                    elif role == "par2_A":
                        pre = par2A_precompute(spec, data, state, grams, p, m,
                                               options)
                        cached[p] = (pre.last_mttkrp, pre.last_had, 0)
                        if cid == 0:
                            if not constrained:
                                if options.IllCondTol > 0:
                                    illc = illc | _chol_rcond_bad(
                                        chol_lower(pre.B), options.IllCondTol)
                                fac = rsolve(pre.A, pre.B)
                                state = state.replace(
                                    fac=tuple_set(state.fac, m, fac))
                                inner_its[m] = jnp.int32(1)
                            else:
                                eye = jnp.eye(R, dtype=pre.A.dtype)
                                solve, _ = spd_checked(
                                    pre.B + 0.5 * pre.rho * eye,
                                    lmin=0.5 * pre.rho)
                                state, nin, _, _ = admm_constrained_only(
                                    spec, state, m, p, pre.A, solve, pre.rho,
                                    options, proxes)
                                inner_its[m] = nin
                        else:
                            pres[m] = pre
                        # gram refreshed unconditionally (cmtf_fun_AOADMM.m:190)
                        grams = refresh_gram(spec, state, grams, m)
                    elif role == "par2_B":
                        active = constrained and bk_constraint_active
                        A, Bk, rho = par2B_precompute(
                            spec, data, state, grams, p, m, options,
                            constraint_active=active, partials=partials)
                        solve, _ = spd_checked(Bk, lmin=0.5 * rho)
                        cached[p] = (None, None, 1)
                        state, nin = admm_b_parafac2(
                            spec, state, m, p, A, solve, rho, options, proxes,
                            constraint_active=active,
                            sizes=spec.par2_slice_sizes(p))
                        inner_its[m] = nin
                        grams = refresh_gram(spec, state, grams, m)
                    else:  # par2_C
                        pre = par2C_precompute(spec, data, state, grams, p, m,
                                               options, partials=partials)
                        cached[p] = (None, None, 2)
                        if cid == 0:
                            if not constrained:
                                if options.IllCondTol > 0:
                                    illc = illc | _chol_rcond_bad(
                                        chol_lower(pre.B), options.IllCondTol)
                                fac = jnp.linalg.solve(
                                    pre.B, pre.A[:, :, None])[:, :, 0]
                                state = state.replace(
                                    fac=tuple_set(state.fac, m, fac))
                                inner_its[m] = jnp.int32(1)
                            else:
                                eye = jnp.eye(R, dtype=pre.A.dtype)
                                Bk = pre.B + 0.5 * pre.rho[:, None, None] * eye
                                _, solve = spd_checked(Bk, lmin=0.5 * pre.rho)
                                state, nin, _, _ = admm_constrained_only(
                                    spec, state, m, p, pre.A, solve, pre.rho,
                                    options, proxes)
                                inner_its[m] = nin
                        else:
                            pres[m] = pre

            if cid != 0:
                ctype = spec.coupling.coupling_type[cid - 1]
                As, Ls, Bs, B2s, rhos = {}, {}, {}, {}, {}
                solvers = {}
                for m in cmodes:
                    p = spec.which_p(m)
                    ds = spec.datasets[p]
                    pre = pres[m]
                    As[m], rhos[m] = pre.A, pre.rho
                    Ls[m] = None
                    if ds.loss != "Frobenius":
                        continue
                    par2C = spec.mode_role(m) == "par2_C"
                    constrained = spec.is_constrained(m)
                    R = ds.rank
                    H = data.coupl_trafo[m] if data.coupl_trafo else None
                    dt = pre.A.dtype
                    eye = jnp.eye(R, dtype=dt)
                    if ctype in (1, 5):
                        if par2C:
                            # kron-vectorized system (cmtf_fun_AOADMM.m:283-297)
                            K = spec.par2_K(p)
                            rhoC = jnp.mean(pre.rho)
                            Bk = pre.B + 0.0
                            HcI = jnp.kron(H, eye)
                            B2 = block_diag(Bk) + 0.5 * rhoC * (HcI.T @ HcI)
                            if constrained:
                                B2 = B2 + 0.5 * rhoC * jnp.eye(K * R, dtype=dt)
                            Ls[m] = chol_checked(B2)
                        else:
                            B2 = 0.5 * pre.rho * (H.T @ H)
                            if constrained:
                                B2 = B2 + 0.5 * pre.rho * jnp.eye(
                                    H.shape[1], dtype=dt)
                            Bs[m], B2s[m] = pre.B, B2
                    elif ctype == 2:
                        HHt = H @ H.T
                        if par2C:
                            B = pre.B + 0.5 * pre.rho[:, None, None] * HHt
                            if constrained:
                                B = B + 0.5 * pre.rho[:, None, None] * eye
                        else:
                            B = pre.B + 0.5 * pre.rho * HHt
                            if constrained:
                                B = B + 0.5 * pre.rho * eye
                        lmin = 0.5 * pre.rho if constrained else None
                        right, rowleft = spd_checked(B, lmin=lmin)
                        solvers[m] = rowleft if par2C else right
                    else:  # 0, 3, 4
                        if par2C:
                            B = pre.B + 0.5 * pre.rho[:, None, None] * eye
                            if constrained:
                                B = B + 0.5 * pre.rho[:, None, None] * eye
                        else:
                            B = pre.B + 0.5 * pre.rho * eye
                            if constrained:
                                B = B + 0.5 * pre.rho * eye
                        right, rowleft = spd_checked(B, lmin=0.5 * pre.rho)
                        solvers[m] = rowleft if par2C else right
                state, nin, lb, res = admm_coupled(
                    spec, state, data, cmodes, cid, ctype, As, Ls, Bs, B2s,
                    rhos, options, proxes, lbfgs_steps, solvers=solvers)
                for m in cmodes:
                    inner_its[m] = nin
                    p = spec.which_p(m)
                    if spec.datasets[p].loss == "Frobenius":
                        if spec.mode_role(m) != "par2_C":
                            grams = refresh_gram(spec, state, grams, m)
                    else:
                        lbfgs_its[m] = lb[m]
                        balance_rho(m, res)
                        colnorms = colnorms.at[m].set(
                            refresh_colnorm_update(state, m))

        if pp is not None:
            return (state, grams, colnorms, rho_scale, cached, inner_its,
                    lbfgs_its, illc, pp)
        return (state, grams, colnorms, rho_scale, cached, inner_its,
                lbfgs_its, illc)

    return outer_step


# ---------------------------------------------------------------------------
# EM imputation (cmtf_fun_AOADMM.m:408-441)
# ---------------------------------------------------------------------------


def em_impute(spec: ProblemSpec, data: ProblemData, state: SolverState):
    """Replace missing entries with the current model; returns
    (data, f_rel_missing)."""
    num = 0.0
    den = 0.0
    objects = list(data.objects)
    for p, ds in enumerate(spec.datasets):
        msk = data.miss[p]
        if msk is None:
            continue
        if ds.model == CP:
            M = ktensor_full([state.fac[j] for j in ds.modes])
            X = objects[p]
            d = jnp.where(msk, 0.0, M - X)
            num = num + jnp.sum(d * d)
            den = den + jnp.sum(jnp.where(msk, 0.0, X) ** 2)
            objects[p] = jnp.where(msk, X, M)
        else:
            Mk = par2_model_slices(spec, state, p)
            X = objects[p]
            d = jnp.where(msk, 0.0, Mk - X.slices)
            num = num + jnp.sum(d * d)
            den = den + jnp.sum(jnp.where(msk, 0.0, X.slices) ** 2)
            new_slices = jnp.where(msk, X.slices, Mk)
            objects[p] = type(X)(slices=new_slices, mask=X.mask)
    frm = jnp.where(den > 0, jnp.sqrt(num / jnp.maximum(den, 1e-300)),
                    jnp.sqrt(num))
    import dataclasses
    return dataclasses.replace(data, objects=tuple(objects)), frm


# ---------------------------------------------------------------------------
# stopping (functions/evaluate_stopping_conditions.m)
# ---------------------------------------------------------------------------


def stopping(f4, f4_old, options: AlgOptions):
    def stream_stop(f, f_old):
        rel = jnp.where(f_old > 0, jnp.abs(f_old - f) / jnp.where(
            f_old > 0, f_old, 1.0), jnp.abs(f_old - f))
        return (f < options.AbsFuncTol) | (rel < options.OuterRelTol)

    s = stream_stop(f4[0], f4_old[0])
    for i in range(1, 4):
        s = s & stream_stop(f4[i], f4_old[i])
    return s


# ---------------------------------------------------------------------------
# phase runner (jitted)
# ---------------------------------------------------------------------------


_RUNNER_CACHE: dict = {}
_RUNNER_CACHE_MAX = 32   # LRU bound: compiled runners pin device memory


def _get_phase_runner(spec: ProblemSpec, options: AlgOptions,
                      bk_active: bool, miss_flag: bool, mesh=None, data=None):
    """Compiled multi-iteration runner.  `last_it` is a TRACED argument, so
    one compiled program serves any chunk length (used by fit() both for the
    full phase and for time_at_it chunking).  When `mesh` is given, CP
    MTTKRPs run through the explicit shard_map collectives."""
    key = (spec, options, bk_active, miss_flag, mesh)
    if key in _RUNNER_CACHE:
        _RUNNER_CACHE[key] = _RUNNER_CACHE.pop(key)   # mark most-recent
        return _RUNNER_CACHE[key]
    proxes, reg_fns = build_proxes(spec)
    impls = None
    if mesh is not None:
        from matlab_code_tpu.parallel.shard_mttkrp import \
            build_sharded_mttkrps
        impls = build_sharded_mttkrps(
            spec, data, mesh,
            pipelined=options.mesh_pipelined_collectives)
    from matlab_code_tpu.models.pairwise import eligible_pp_datasets
    pp_datasets = eligible_pp_datasets(spec, data, options, mesh)
    outer_step = make_outer_step(spec, options, proxes, reg_fns, bk_active,
                                 mttkrp_impls=impls, pp_datasets=pp_datasets)
    nb_modes = spec.nb_modes

    def run(state, data, znorms, hist, f4, frm, it0, last_it, grams,
            colnorms, rho_scale, pp):

        def cond(c):
            (state, data, grams, colnorms, rho_scale, f4, frm, hist, it,
             stop, illc, pp) = c
            return (it <= last_it) & (~stop)

        def body(c):
            (state, data, grams, colnorms, rho_scale, f4, frm, hist, it,
             stop, illc, pp) = c
            if pp_datasets:
                (state, grams, colnorms, rho_scale, cached, inner_its,
                 lbfgs_its, illc_new, pp) = outer_step(
                    state, data, grams, colnorms, rho_scale, pp)
            else:
                (state, grams, colnorms, rho_scale, cached, inner_its,
                 lbfgs_its, illc_new) = outer_step(
                    state, data, grams, colnorms, rho_scale)
            if miss_flag:
                data, frm = em_impute(spec, data, state)
            f4_new = func_eval(spec, data, state, grams, znorms, reg_fns,
                               cached=cached, options=options)
            stop_new = stopping(f4_new, f4, options)
            if miss_flag:
                stop_new = stop_new & (frm < options.OuterRelTol)
            # guard against non-finite streams (ill-conditioned systems) and
            # the early Cholesky rcond check (cmtf_fun_AOADMM.m:83-84)
            bad = ~jnp.isfinite(sum(f4_new))
            illc = illc | illc_new
            stop_new = stop_new | bad | illc
            hist = dict(hist)
            hist["f_tensors"] = hist["f_tensors"].at[it].set(f4_new[0])
            hist["f_couplings"] = hist["f_couplings"].at[it].set(f4_new[1])
            hist["f_constraints"] = hist["f_constraints"].at[it].set(f4_new[2])
            hist["f_par2"] = hist["f_par2"].at[it].set(f4_new[3])
            if miss_flag:
                hist["f_rel_missing"] = hist["f_rel_missing"].at[it].set(frm)
            inner_col = jnp.zeros((nb_modes,), jnp.int32)
            for m, v in inner_its.items():
                inner_col = inner_col.at[m].set(v)
            hist["inner_iters"] = hist["inner_iters"].at[:, it].set(inner_col)
            if "lbfgsb_iters" in hist:
                lb_col = jnp.zeros((nb_modes,), jnp.int32)
                for m, v in lbfgs_its.items():
                    lb_col = lb_col.at[m].set(v)
                hist["lbfgsb_iters"] = hist["lbfgsb_iters"].at[:, it].set(
                    lb_col)
            if options.Display == "iter":
                f_total = sum(f4_new)

                def _print(args):
                    jax.debug.print(
                        "{:6d} {:12.8f} {:12.8f} {:12.8f} {:12.8f} {:12.8f}",
                        args[0], args[1], args[2], args[3], args[4], args[5])
                    return 0

                lax.cond(jnp.mod(it, options.DisplayIters) == 0,
                         _print, lambda a: 0,
                         (it, f_total, f4_new[0], f4_new[1], f4_new[2],
                          f4_new[3]))
            return (state, data, grams, colnorms, rho_scale, f4_new, frm,
                    hist, it + 1, stop_new, illc, pp)

        carry = (state, data, grams, colnorms, rho_scale, f4, frm, hist, it0,
                 jnp.bool_(False), jnp.bool_(False), pp)
        (state, data, grams, colnorms, rho_scale, f4, frm, hist, it, stop,
         illc, pp) = lax.while_loop(cond, body, carry)
        return (state, data, f4, frm, hist, it, stop, illc, grams, colnorms,
                rho_scale, pp)

    fn = jax.jit(run)
    _RUNNER_CACHE[key] = fn
    while len(_RUNNER_CACHE) > _RUNNER_CACHE_MAX:
        _RUNNER_CACHE.pop(next(iter(_RUNNER_CACHE)))
    return fn


# ---------------------------------------------------------------------------
# fit driver
# ---------------------------------------------------------------------------


@dataclass
class FitOutput:
    """The reference's `out` struct (cmtf_fun_AOADMM.m:480-494)."""
    f_tensors: float
    f_couplings: float
    f_constraints: float
    f_PAR2_couplings: float
    f_rel_missing: float
    exit_flag: Any
    OuterIterations: int
    func_val_conv: np.ndarray
    func_coupl_conv: np.ndarray
    func_constr_conv: np.ndarray
    func_PAR2_coupl: np.ndarray
    func_rel_missing: np.ndarray | None
    innerIters: np.ndarray
    time_total: float
    time_at_it: np.ndarray | None = None
    lbfgsb_iterations: np.ndarray | None = None


def _warn_loss_data(spec: ProblemSpec, data: ProblemData) -> None:
    """Data-vs-loss sanity warnings (cmtf_AOADMM.m:162-175):
    KL expects count data, IS expects positive data."""
    import warnings
    for p, ds in enumerate(spec.datasets):
        if ds.loss not in ("KL", "IS"):
            continue
        X = data.objects[p]
        vals = np.asarray(X if not hasattr(X, "slices") else X.slices)
        if ds.loss == "KL":
            if np.any(vals < 0) or np.any(vals != np.round(vals)):
                warnings.warn(f"Using 'KL' but dataset {p} is not count data")
        else:
            if np.any(vals <= 0):
                warnings.warn(f"Using 'IS' but dataset {p} is not positive")


def _has_bk_constraint(spec: ProblemSpec) -> bool:
    for p, ds in enumerate(spec.datasets):
        if ds.model == PAR2 and spec.is_constrained(ds.modes[1]):
            return True
    return False


@with_matmul_precision
def fit_stepwise(spec: ProblemSpec, data: ProblemData, state: SolverState,
                 options: AlgOptions, validate: bool = True):
    """Host-stepped variant of fit(): one jitted outer sweep per call, with
    stopping evaluated on the host and true per-iteration wall times recorded
    (the reference's out.time_at_it, cmtf_fun_AOADMM.m:455).  One dispatch
    and one host sync of overhead per iteration vs the fully fused fit()."""
    if validate:
        check_data_input(spec, data)
        _warn_loss_data(spec, data)
    options = resolve_auto(options)
    miss_flag = has_missing(data)
    znorms = compute_znorm_consts(spec, data, options)
    proxes, reg_fns = build_proxes(spec)

    bk = _has_bk_constraint(spec)
    from matlab_code_tpu.models.pairwise import (
        eligible_pp_datasets, pp_init)
    pp_ds = eligible_pp_datasets(spec, data, options)
    steps = {}
    for active in ({False, True} if bk else {True}):
        step = make_outer_step(spec, options, proxes, reg_fns, active,
                               pp_datasets=pp_ds)

        def one(state, data, grams, colnorms, rho_scale, pp, step=step):
            if pp_ds:
                (state, grams, colnorms, rho_scale, cached, inner, lb,
                 illc, pp) = step(state, data, grams, colnorms, rho_scale,
                                  pp)
            else:
                (state, grams, colnorms, rho_scale, cached, inner, lb,
                 illc) = step(state, data, grams, colnorms, rho_scale)
            if miss_flag:
                data, frm = em_impute(spec, data, state)
            else:
                frm = jnp.asarray(np.nan)
            f4 = func_eval(spec, data, state, grams, znorms, reg_fns,
                           cached=cached, options=options)
            inner_col = jnp.zeros((spec.nb_modes,), jnp.int32)
            for mm, v in inner.items():
                inner_col = inner_col.at[mm].set(v)
            lb_col = jnp.zeros((spec.nb_modes,), jnp.int32)
            for mm, v in lb.items():
                lb_col = lb_col.at[mm].set(v)
            return (state, data, grams, colnorms, rho_scale, f4, frm,
                    inner_col, lb_col, illc, pp)

        steps[active] = jax.jit(one)

    grams, colnorms = init_cache(spec, state)
    pp = pp_init(spec, data, state, pp_ds)
    rho_scale = jnp.ones((spec.nb_modes,),
                         np.asarray(state.fac[0]).dtype)
    illc = False
    f4 = func_eval(spec, data, state, grams, znorms, reg_fns, None, options)
    f4 = tuple(float(v) for v in f4)
    hist = [f4]
    times = [0.0]
    inner_hist = [np.zeros((spec.nb_modes,), np.int32)]
    lb_hist = [np.zeros((spec.nb_modes,), np.int32)]
    frm = float("nan")
    frm_hist = [frm]
    t0 = time.perf_counter()
    it = 1
    stop = False
    while it <= options.MaxOuterIters and not stop:
        active = (not bk) or it >= max(options.iter_start_PAR2Bkconstraint, 0)
        (state, data, grams, colnorms, rho_scale, f4_new, frm_t, inner_col,
         lb_col, illc_t, pp) = steps[active](state, data, grams, colnorms,
                                             rho_scale, pp)
        inner_hist.append(np.asarray(inner_col))
        lb_hist.append(np.asarray(lb_col))
        f4_new = tuple(float(v) for v in f4_new)
        frm = float(frm_t)
        frm_hist.append(frm)
        stop = bool(stopping(f4_new, f4, options))
        if miss_flag:
            stop = stop and frm < options.OuterRelTol
        if not all(np.isfinite(f4_new)):
            stop = True
        if bool(illc_t):
            illc = True
            stop = True
        hist.append(f4_new)
        times.append(time.perf_counter() - t0)
        f4 = f4_new
        it += 1
    n_iter = it - 1
    if pp_ds:
        # exact final objective after PP-approximate iterations (see fit())
        f4 = tuple(float(v) for v in func_eval(
            spec, data, state, grams, znorms, reg_fns, None, options))
        hist[-1] = f4
    harr = np.asarray(hist)
    if illc:
        exit_flag = "illconditioned lin system"
    elif n_iter >= options.MaxOuterIters and not stop:
        exit_flag = "maxIterations"
    elif not all(np.isfinite(f4)):
        exit_flag = "illconditioned lin system"
    else:
        names = ("f_tensors", "f_couplings", "f_constraints",
                 "f_PAR2_couplings")
        exit_flag = {n: ("AbsFuncTol" if v < options.AbsFuncTol
                         else "RelFuncTol") for n, v in zip(names, f4)}
    out = FitOutput(
        f_tensors=f4[0], f_couplings=f4[1], f_constraints=f4[2],
        f_PAR2_couplings=f4[3], f_rel_missing=frm,
        exit_flag=exit_flag, OuterIterations=n_iter,
        func_val_conv=harr[:, 0], func_coupl_conv=harr[:, 1],
        func_constr_conv=harr[:, 2], func_PAR2_coupl=harr[:, 3],
        func_rel_missing=(np.asarray(frm_hist) if miss_flag else None),
        innerIters=np.stack(inner_hist, axis=1),
        time_total=times[-1], time_at_it=np.asarray(times),
        lbfgsb_iterations=(np.stack(lb_hist, axis=1)
                           if spec.has_non_frobenius() else None))
    return state, out


@with_matmul_precision
def fit(spec: ProblemSpec, data: ProblemData, state: SolverState,
        options: AlgOptions, validate: bool = True, mesh=None):
    """Run AO-ADMM to convergence.  Returns (state, FitOutput).

    mesh: optional jax.sharding.Mesh — route every shardable >=3-way CP
    MTTKRP through the explicit shard_map collective path (psum of partial
    MTTKRPs over the mesh axis, parallel/shard_mttkrp.py) instead of letting
    XLA derive the partitioning from input shardings.  SparseTensor datasets
    go through the nnz-partitioned gather + psum path.

    The 'auto' options resolve here, once, for the default backend
    (options.resolve_auto)."""
    if validate:
        check_data_input(spec, data)
        _warn_loss_data(spec, data)
    options = resolve_auto(options)
    miss_flag = has_missing(data)
    znorms = compute_znorm_consts(spec, data, options)
    # .dtype (not np.asarray) so a cross-process sharded factor (multi-host
    # fit via parallel/distributed.py) is never pulled to the host here
    dt = np.dtype(state.fac[0].dtype)
    T = options.MaxOuterIters

    proxes, reg_fns = build_proxes(spec)
    grams0, _ = init_cache(spec, state)
    f4 = func_eval(spec, data, state, grams0, znorms, reg_fns, cached=None,
                   options=options)
    f4 = tuple(jnp.asarray(v, dt) for v in f4)
    frm = jnp.asarray(np.nan, dt)

    hist = {
        "f_tensors": jnp.zeros((T + 1,), dt).at[0].set(f4[0]),
        "f_couplings": jnp.zeros((T + 1,), dt).at[0].set(f4[1]),
        "f_constraints": jnp.zeros((T + 1,), dt).at[0].set(f4[2]),
        "f_par2": jnp.zeros((T + 1,), dt).at[0].set(f4[3]),
        "inner_iters": jnp.zeros((spec.nb_modes, T + 1), jnp.int32),
    }
    if miss_flag:
        hist["f_rel_missing"] = jnp.full((T + 1,), np.nan, dt)
    if spec.has_non_frobenius():
        hist["lbfgsb_iters"] = jnp.zeros((spec.nb_modes, T + 1), jnp.int32)

    if options.Display in ("iter", "final"):
        # header row (cmtf_fun_AOADMM.m:44-51)
        print(" Iter  f total      f tensors      f couplings    "
              "f constraints    f PAR2 couplings")
        print("------ ------------ -------------  -------------- "
              "---------------- ----------------")

    start = options.iter_start_PAR2Bkconstraint
    if _has_bk_constraint(spec) and start > 1:
        phases = [(min(start - 1, T), False), (T, True)]
    else:
        phases = [(T, True)]

    grams, colnorms = init_cache(spec, state)
    rho_scale = jnp.ones((spec.nb_modes,), dt)
    from matlab_code_tpu.models.pairwise import (
        eligible_pp_datasets, pp_init)
    pp = pp_init(spec, data, state,
                 eligible_pp_datasets(spec, data, options, mesh))
    chunk = options.TimeAtItChunk  # 0 = one runner call per phase
    time_marks = [(0, 0.0)]        # (iteration, elapsed) at chunk boundaries

    t0 = time.perf_counter()
    it = jnp.int32(1)
    stop = False
    illc = False
    for last_it, active in phases:
        if stop or int(it) > last_it:
            continue
        runner = _get_phase_runner(spec, options, active, miss_flag,
                                   mesh=mesh, data=data)
        while not stop and int(it) <= last_it:
            chunk_end = min(last_it, int(it) + chunk - 1) if chunk > 0 \
                else last_it
            (state, data, f4, frm, hist, it, stop_t, illc_t, grams,
             colnorms, rho_scale, pp) = runner(
                state, data, znorms, hist, f4, frm, it,
                jnp.int32(chunk_end), grams, colnorms, rho_scale, pp)
            stop = bool(stop_t)
            illc = illc or bool(illc_t)
            time_marks.append((int(it) - 1, time.perf_counter() - t0))
    jax.block_until_ready(state.fac[0])
    t_total = time.perf_counter() - t0

    n_iter = int(it) - 1
    if pp:
        # pairwise perturbation was in play: the cached-MTTKRP objective is
        # approximate during PP-active iterations — recompute the FINAL
        # objective exactly (one full eval) and patch the histories.
        f4 = func_eval(spec, data, state, grams, znorms, reg_fns,
                       cached=None, options=options)
        for k, i in zip(("f_tensors", "f_couplings", "f_constraints",
                         "f_par2"), range(4)):
            hist[k] = hist[k].at[n_iter].set(f4[i])
    f4 = tuple(float(v) for v in f4)
    # per-iteration wall times (out.time_at_it, cmtf_fun_AOADMM.m:455):
    # measured at chunk boundaries (every TimeAtItChunk iterations), linearly
    # interpolated within a chunk
    time_at_it = np.zeros((n_iter + 1,))
    for (i0, u0), (i1, u1) in zip(time_marks, time_marks[1:]):
        if i1 > i0:
            time_at_it[i0:i1 + 1] = np.linspace(u0, u1, i1 - i0 + 1)
    if illc:
        exit_flag = "illconditioned lin system"
    elif n_iter >= T and not stop:
        exit_flag = "maxIterations"
    elif not all(np.isfinite(f4)):
        exit_flag = "illconditioned lin system"
    else:
        names = ("f_tensors", "f_couplings", "f_constraints",
                 "f_PAR2_couplings")
        exit_flag = {n: ("AbsFuncTol" if v < options.AbsFuncTol
                         else "RelFuncTol") for n, v in zip(names, f4)}

    out = FitOutput(
        f_tensors=f4[0], f_couplings=f4[1], f_constraints=f4[2],
        f_PAR2_couplings=f4[3],
        f_rel_missing=float(frm) if miss_flag else float("nan"),
        exit_flag=exit_flag, OuterIterations=n_iter,
        func_val_conv=np.asarray(hist["f_tensors"][:n_iter + 1]),
        func_coupl_conv=np.asarray(hist["f_couplings"][:n_iter + 1]),
        func_constr_conv=np.asarray(hist["f_constraints"][:n_iter + 1]),
        func_PAR2_coupl=np.asarray(hist["f_par2"][:n_iter + 1]),
        func_rel_missing=(np.asarray(hist["f_rel_missing"][:n_iter + 1])
                          if miss_flag else None),
        innerIters=np.asarray(hist["inner_iters"][:, :n_iter + 1]),
        time_total=t_total, time_at_it=time_at_it,
        lbfgsb_iterations=(np.asarray(hist["lbfgsb_iters"][:, :n_iter + 1])
                           if "lbfgsb_iters" in hist else None))

    if options.Display in ("iter", "final"):
        print(f"{n_iter:6d} {sum(f4):12.8f} {f4[0]:12.8f} {f4[1]:12.8f} "
              f"{f4[2]:12.8f} {f4[3]:12.8f}")
    return state, out


def cmtf_aoadmm(spec: ProblemSpec, data: ProblemData, options: AlgOptions,
                init: SolverState | None = None, init_options=None,
                key=None, validate: bool = True, mesh=None):
    """High-level driver (functions/cmtf_AOADMM.m): initializes if needed,
    fits, and assembles per-dataset factor estimates.

    mesh: optional jax.sharding.Mesh, forwarded to fit() — data/state are
    laid out with parallel/sharding.py's shardings and MTTKRPs run through
    the explicit shard_map collectives (parallel/shard_mttkrp.py).

    Returns (Zhat, state, init_state, out) where Zhat[p] is
      {'weights': None, 'factors': [...]}           for CP datasets,
      {'A': ..., 'Bk': [...], 'C': ...}             for PAR2 datasets.
    """
    import jax
    from matlab_code_tpu.models.init import init_coupled
    if init is None:
        if init_options is None:
            raise ValueError("init_options are missing in cmtf_aoadmm")
        init = init_coupled(spec, data, init_options, key=key)
    state0 = init
    if mesh is not None:
        from matlab_code_tpu.parallel.sharding import (
            data_shardings, state_shardings)
        data_sh, sharded_modes = data_shardings(spec, data, mesh)
        data = jax.device_put(data, data_sh)
        state0 = jax.device_put(
            state0, state_shardings(spec, state0, mesh, sharded_modes))
    state, out = fit(spec, data, state0, options, validate=validate,
                     mesh=mesh)
    return assemble_zhat(spec, state), state, state0, out


def assemble_zhat(spec: ProblemSpec, state: SolverState):
    """Per-dataset factor estimates from a solver state (the `Zhat` output
    packaging of cmtf_AOADMM.m:197-206)."""
    zhat = []
    for p, ds in enumerate(spec.datasets):
        if ds.model == CP:
            # ktensor(U) packaging carries implicit unit weights
            # (cmtf_AOADMM.m:200: ktensor(Fac.fac(Z.modes{p})) -> lambda=1)
            zhat.append({"weights": np.ones(ds.rank),
                         "factors": [np.asarray(state.fac[j])
                                     for j in ds.modes]})
        else:
            sizes = spec.par2_slice_sizes(p)
            Bk = [np.asarray(state.fac[ds.modes[1]][k, :j, :])
                  for k, j in enumerate(sizes)]
            zhat.append({"A": np.asarray(state.fac[ds.modes[0]]),
                         "Bk": Bk,
                         "C": np.asarray(state.fac[ds.modes[2]])})
    return zhat
