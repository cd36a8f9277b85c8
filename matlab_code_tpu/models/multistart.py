"""Multi-start fitting: all random starts run in ONE vmapped jitted program.

The reference runs its 20 random starts sequentially
(example_script15:113-130); here the starts are batched over the leading
axis of the state pytree, so the MTTKRPs and batched solves of every start
execute as one larger fused program (SURVEY.md §2.3 'embarrassingly
parallel: one init per device group / vmap over seeds').

Semantics match a sequential loop of single fits exactly:
  * `iter_start_PAR2Bkconstraint` is honored via the same two-phase runner
    split as fit() (cmtf_fun_AOADMM.m:7-9),
  * each start STOPS at its own stopping iteration — its state/history are
    frozen from then on (lane masking), and the whole batched loop exits as
    soon as every start has stopped, so no sweeps are wasted past the
    slowest start's convergence,
  * the best start (min final f_tensors, example_script15:126-130) is
    returned with a full FitOutput (histories, innerIters, exit_flag).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from matlab_code_tpu.problem import ProblemSpec, ProblemData, has_missing
from matlab_code_tpu.options import (AlgOptions, InitOptions,
                                     with_matmul_precision)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import (
    build_proxes, make_outer_step, init_cache, compute_znorm_consts,
    em_impute, stopping, FitOutput, _has_bk_constraint)
from matlab_code_tpu.models.objective import func_eval


def _lane_where(stopped, old, new):
    """Per-start freeze: keep `old` where the lane has stopped."""
    def sel(a, b):
        if a is None:
            return None
        m = stopped.reshape(stopped.shape + (1,) * (a.ndim - 1))
        return jnp.where(m, a, b)
    return jax.tree_util.tree_map(sel, old, new, is_leaf=lambda x: x is None)


def _stopping_v(f4_new, f4_old, options):
    """Vectorized stopping over the start axis; f4 are (S, 4) arrays."""
    def one(fn, fo):
        return stopping(tuple(fn), tuple(fo), options)
    return jax.vmap(one)(f4_new, f4_old)


@with_matmul_precision
def fit_multistart(spec: ProblemSpec, data: ProblemData, options: AlgOptions,
                   init_options: InitOptions, n_starts: int, base_key=0,
                   delta_shapes=None, keys=None, mesh=None):
    """Returns (best_state, best_out, all_f_tensors, stop_iters).

    best_out is a full FitOutput of the best start, evaluated at its own
    stopping iteration (identical numbers to a sequential early-stopped run).

    keys: optional explicit per-start init keys (each anything init_coupled
    accepts, e.g. ints); overrides the base_key fold_in scheme so the S
    starts reproduce S sequential `cmtf_aoadmm(..., key=keys[s])` runs
    exactly (the reference's best-of-N protocol, example_script15.m:113-135).

    mesh: optional jax.sharding.Mesh — shard the START axis over the mesh
    (SURVEY §2.3 'one init per device group'): every S-leading pytree leaf
    is placed with axis 0 partitioned and the problem data replicated, so
    each device runs its own subset of starts with NO cross-device
    collectives except the scalar all-stopped reduction.  n_starts must be
    divisible by the mesh size.  Numbers are identical to the unsharded
    run (the start lanes never interact).
    """
    if keys is not None:
        keys = list(keys)
        if len(keys) != n_starts:
            raise ValueError(f"got {len(keys)} keys for {n_starts} starts")
    else:
        if isinstance(base_key, str):
            import hashlib
            base_key = int(hashlib.sha256(base_key.encode()).hexdigest()[:8],
                           16)
        root = jax.random.PRNGKey(int(base_key))
        keys = [jax.random.fold_in(root, s) for s in range(n_starts)]
    states = [init_coupled(spec, data, init_options, key=k,
                           delta_shapes=delta_shapes) for k in keys]
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    proxes, reg_fns = build_proxes(spec)
    miss_flag = has_missing(data)
    znorms = compute_znorm_consts(spec, data, options)
    T = options.MaxOuterIters
    nb = spec.nb_modes
    S = n_starts
    dt = np.asarray(states[0].fac[0]).dtype

    bk = _has_bk_constraint(spec)
    start_it = options.iter_start_PAR2Bkconstraint
    if bk and start_it > 1:
        phases = [(min(start_it - 1, T), False), (T, True)]
    else:
        phases = [(T, True)]

    # per-start caches / initial objective, batched via vmap
    def init_one(state):
        grams, colnorms = init_cache(spec, state)
        f4 = func_eval(spec, data, state, grams, znorms, reg_fns, None,
                       options)
        return grams, colnorms, jnp.stack(f4)

    grams, colnorms, f4 = jax.jit(jax.vmap(init_one))(batched)
    rho_scale = jnp.ones((S, nb), dt)
    if miss_flag:
        vdata = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (S,) + x.shape) if x is not None
            else None, data, is_leaf=lambda x: x is None)
    else:
        vdata = None

    hist = jnp.zeros((S, 4, T + 1), dt).at[:, :, 0].set(f4)
    inner_h = jnp.zeros((S, nb, T + 1), jnp.int32)
    lb_h = (jnp.zeros((S, nb, T + 1), jnp.int32)
            if spec.has_non_frobenius() else None)
    frm = jnp.full((S,), np.nan, dt)
    # per-lane f_rel_missing history (out.func_rel_missing,
    # cmtf_fun_AOADMM.m:489) — tracked only for EM problems
    frm_h = jnp.full((S, T + 1), np.nan, dt) if miss_flag else None
    stopped = jnp.zeros((S,), bool)
    illc_l = jnp.zeros((S,), bool)
    stop_iter = jnp.full((S,), T, jnp.int32)

    def make_phase(active):
        step = make_outer_step(spec, options, proxes, reg_fns, active)

        def sweep_one(state, dat, grams, colnorms, rho_scale):
            (state, grams, colnorms, rho_scale, cached, inner, lb,
             illc) = step(state, dat, grams, colnorms, rho_scale)
            if miss_flag:
                dat, f_rm = em_impute(spec, dat, state)
            else:
                f_rm = jnp.asarray(np.nan, dt)
            f4n = func_eval(spec, dat, state, grams, znorms, reg_fns,
                            cached=cached, options=options)
            inner_col = jnp.zeros((nb,), jnp.int32)
            for mm, v in inner.items():
                inner_col = inner_col.at[mm].set(v)
            lb_col = jnp.zeros((nb,), jnp.int32)
            for mm, v in lb.items():
                lb_col = lb_col.at[mm].set(v)
            return (state, dat, grams, colnorms, rho_scale, jnp.stack(f4n),
                    f_rm, inner_col, lb_col, illc)

        dax = 0 if miss_flag else None
        vsweep = jax.vmap(sweep_one, in_axes=(0, dax, 0, 0, 0))

        def run(state, vdata, grams, colnorms, rho_scale, f4, frm, frm_h,
                hist, inner_h, lb_h, stopped, illc_l, stop_iter, it0,
                last_it):
            def cond(c):
                it, stopped = c[-2], c[-5]
                return (it <= last_it) & (~jnp.all(stopped))

            def body(c):
                (state, vdata, grams, colnorms, rho_scale, f4, frm, frm_h,
                 hist, inner_h, lb_h, stopped, illc_l, stop_iter, it, _) = c
                new = vsweep(state, vdata if miss_flag else data, grams,
                             colnorms, rho_scale)
                (nstate, ndata, ngrams, ncolnorms, nrho, f4n, frmn,
                 inner_col, lb_col, illc_n) = new
                # freeze lanes that had already stopped
                nstate = _lane_where(stopped, state, nstate)
                ngrams = _lane_where(stopped, grams, ngrams)
                ncolnorms = _lane_where(stopped, colnorms, ncolnorms)
                nrho = _lane_where(stopped, rho_scale, nrho)
                f4n = _lane_where(stopped, f4, f4n)
                frmn = jnp.where(stopped, frm, frmn)
                if miss_flag:
                    ndata = _lane_where(stopped, vdata, ndata)
                else:
                    ndata = vdata
                # per-start stopping on this iteration's streams
                stop_now = _stopping_v(f4n, f4, options)
                if miss_flag:
                    stop_now = stop_now & (frmn < options.OuterRelTol)
                bad = ~jnp.all(jnp.isfinite(f4n), axis=1)
                illc_n = jnp.where(stopped, illc_l, illc_l | illc_n)
                stop_now = stop_now | bad | illc_n
                # record history for active lanes only
                act = ~stopped
                if frm_h is not None:
                    frm_h = frm_h.at[:, it].set(
                        jnp.where(act, frmn, np.nan))
                hist = hist.at[:, :, it].set(
                    jnp.where(act[:, None], f4n, 0.0))
                inner_h = inner_h.at[:, :, it].set(
                    jnp.where(act[:, None], inner_col, 0))
                if lb_h is not None:
                    lb_h2 = lb_h.at[:, :, it].set(
                        jnp.where(act[:, None], lb_col, 0))
                else:
                    lb_h2 = lb_h
                stop_iter = jnp.where(act, it, stop_iter)
                stopped = stopped | stop_now
                return (nstate, ndata, ngrams, ncolnorms, nrho, f4n, frmn,
                        frm_h, hist, inner_h, lb_h2, stopped, illc_n,
                        stop_iter, it + 1, jnp.int32(last_it))

            c0 = (state, vdata, grams, colnorms, rho_scale, f4, frm, frm_h,
                  hist, inner_h, lb_h, stopped, illc_l, stop_iter, it0,
                  jnp.int32(last_it))
            return lax.while_loop(cond, body, c0)

        return jax.jit(run, static_argnames=())

    it = jnp.int32(1)
    carry = (batched, vdata, grams, colnorms, rho_scale, f4, frm, frm_h,
             hist, inner_h, lb_h, stopped, illc_l, stop_iter, it,
             jnp.int32(0))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from matlab_code_tpu.parallel.sharding import DATA_AXIS
        n_dev = mesh.devices.size
        if S % n_dev:
            raise ValueError(
                f"n_starts={S} must be divisible by the mesh size {n_dev}")

        def shard_S(x):
            if x is None:
                return None
            spec_ = PartitionSpec(DATA_AXIS, *([None] * (x.ndim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec_))

        sharded = tuple(
            jax.tree_util.tree_map(shard_S, c,
                                   is_leaf=lambda x: x is None)
            for c in carry[:14])
        carry = sharded + carry[14:]
    import time as _time
    # AOT-compile every phase that can run BEFORE starting the timer, so
    # time_at_it measures execution only (fit()/fit_stepwise likewise keep
    # trace+compile out of their per-iteration marks; compile can dwarf
    # execution and would smear across every iteration).
    runs = [(last_it, make_phase(active)) for last_it, active in phases]
    for last_it, run in runs:
        if last_it >= int(carry[-2]):
            run.lower(*carry[:-2], carry[-2], last_it).compile()
    t0 = _time.perf_counter()
    for last_it, run in runs:
        if int(carry[-2]) > last_it or bool(jnp.all(carry[-5])):
            continue
        carry = run(*carry[:-2], carry[-2], last_it)

    (states_f, _, _, _, _, f4, frm, frm_h, hist, inner_h, lb_h, stopped,
     illc_l, stop_iter, it, _) = carry
    jax.block_until_ready(stop_iter)
    t_total = _time.perf_counter() - t0   # wall time of ALL starts together
    hist = np.asarray(hist)
    stop_iter = np.asarray(stop_iter)
    stopped = np.asarray(stopped)
    illc_l = np.asarray(illc_l)
    inner_h = np.asarray(inner_h)
    frm = np.asarray(frm)

    stop_iters = [int(s) for s in stop_iter]
    finals = np.asarray([hist[s, 0, stop_iters[s]] for s in range(S)])
    best = int(np.nanargmin(finals))
    best_state = jax.tree_util.tree_map(
        lambda x: x[best] if x is not None else None, states_f,
        is_leaf=lambda x: x is None)

    n_it = stop_iters[best]
    # per-iteration wall times for the best lane: the vmapped batch runs all
    # lanes together, so the per-lane share is the global per-iteration time
    # (t_total / max iterations executed) over this lane's first n_it
    # iterations — a uniform-rate interpolation, like fit()'s chunked marks
    max_it = max(max(stop_iters), 1)
    time_at_it = np.arange(n_it + 1) * (t_total / max_it)
    f4b = tuple(float(hist[best, i, n_it]) for i in range(4))
    if illc_l[best] or not all(np.isfinite(f4b)):
        exit_flag = "illconditioned lin system"
    elif not stopped[best]:
        exit_flag = "maxIterations"
    else:
        names = ("f_tensors", "f_couplings", "f_constraints",
                 "f_PAR2_couplings")
        exit_flag = {n: ("AbsFuncTol" if v < options.AbsFuncTol
                         else "RelFuncTol") for n, v in zip(names, f4b)}
    best_out = FitOutput(
        f_tensors=f4b[0], f_couplings=f4b[1], f_constraints=f4b[2],
        f_PAR2_couplings=f4b[3],
        f_rel_missing=float(frm[best]) if miss_flag else float("nan"),
        exit_flag=exit_flag, OuterIterations=n_it,
        func_val_conv=hist[best, 0, :n_it + 1],
        func_coupl_conv=hist[best, 1, :n_it + 1],
        func_constr_conv=hist[best, 2, :n_it + 1],
        func_PAR2_coupl=hist[best, 3, :n_it + 1],
        func_rel_missing=(np.asarray(frm_h)[best, :n_it + 1]
                          if miss_flag else None),
        innerIters=inner_h[best, :, :n_it + 1],
        time_total=t_total, time_at_it=time_at_it,
        lbfgsb_iterations=(np.asarray(lb_h)[best, :, :n_it + 1]
                           if lb_h is not None else None))
    return best_state, best_out, finals, stop_iters
