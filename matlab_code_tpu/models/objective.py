"""Objective / residual-stream evaluation (CMTF_AOADMM_func_eval,
cmtf_fun_AOADMM.m:1213-1363).

Returns the four streams (f_tensors, f_couplings, f_constraints,
f_PAR2_couplings) the stopping rule watches.  The CP-Frobenius data term uses
the cached-MTTKRP trick (no extra data pass); non-Frobenius losses materialize
the model tensor exactly like the reference.
"""
from __future__ import annotations

import jax.numpy as jnp

from matlab_code_tpu.ops.tensor import ktensor_full, mttkrp, gram, hadamard_grams
from matlab_code_tpu.ops import losses
from matlab_code_tpu.problem import ProblemSpec, ProblemData, CP, PAR2

_fro = jnp.linalg.norm


def _safe_div(a, b):
    return jnp.where(b > 0, a / jnp.where(b > 0, b, 1.0), a)


def par2_model_slices(spec, state, p):
    """(K, I, Jmax) model slices A diag(c_k) B_k^T."""
    ds = spec.datasets[p]
    A = state.fac[ds.modes[0]]
    Bk = state.fac[ds.modes[1]]
    C = state.fac[ds.modes[2]]
    return jnp.einsum("ir,kr,kjr->kij", A, C, Bk, optimize=True)


def func_eval(spec: ProblemSpec, data: ProblemData, state, grams,
              znorm_consts, reg_fns, cached=None, options=None):
    """The four objective streams.

    reg_fns: per-mode regularizer penalty callables (or None), built by
      make_prox at trace time (the reference's Z.reg_func).
    cached: None (fresh eval, iter 0) or a dict
      {p: (last_mttkrp, last_had, last_m_static)} for CP-Frobenius datasets /
      PAR2 datasets (last_m_static in {0,1,2} local role index).
    """
    has_missing = any(msk is not None for msk in data.miss)
    fps = []
    for p, ds in enumerate(spec.datasets):
        X = data.objects[p]
        if ds.model == CP:
            if ds.loss == "Frobenius":
                if has_missing and data.miss[p] is not None:
                    # (cmtf_fun_AOADMM.m:1224-1226)
                    M = jnp.where(data.miss[p],
                                  ktensor_full([state.fac[j] for j in ds.modes]),
                                  0.0)
                    fp = ds.weight * (znorm_consts[p]
                                      - 2.0 * jnp.sum(X * M) + jnp.sum(M * M))
                elif cached is not None and p in cached:
                    last_mk, last_had, last_m = cached[p]
                    mlast = ds.modes[last_m]
                    f2 = jnp.sum(last_mk * state.fac[mlast])
                    f3 = jnp.sum(last_had * grams[mlast])
                    fp = ds.weight * (znorm_consts[p] - 2.0 * f2 + f3)
                else:
                    # fresh eval, cp_func.m:37-56 / pca_func.m:29-39
                    facs = [state.fac[j] for j in ds.modes]
                    mk = mttkrp(X, facs, 0)
                    f2 = jnp.sum(mk * facs[0])
                    f3 = jnp.sum(hadamard_grams([gram(U) for U in facs]))
                    fp = ds.weight * (znorm_consts[p] - 2.0 * f2 + f3)
            else:
                M = ktensor_full([state.fac[j] for j in ds.modes])
                fp = ds.weight * (znorm_consts[p] + jnp.sum(
                    losses.loss_fh(ds.loss, X, M, options.eps_log,
                                   ds.loss_param)))
        else:  # PAR2
            if has_missing and data.miss[p] is not None:
                Mk = par2_model_slices(spec, state, p)
                D = jnp.where(data.miss[p], X.slices - Mk, 0.0)
                fp = jnp.sum(D * D)
            elif cached is not None and p in cached and cached[p][2] == 0:
                last_mk, last_had, _ = cached[p]
                mA = ds.modes[0]
                f2 = jnp.sum(last_mk * state.fac[mA])
                f3 = jnp.sum(last_had * grams[mA])
                fp = znorm_consts[p] - 2.0 * f2 + f3
            else:
                Mk = par2_model_slices(spec, state, p)
                D = X.slices - Mk
                # padded columns are zero in both -> contribute nothing
                fp = jnp.sum(D * D)
            fp = ds.weight * fp
        fps.append(fp)
    f_tensors = sum(fps)

    # regularizer penalties (cmtf_fun_AOADMM.m:1272-1288)
    for m in range(spec.nb_modes):
        rf = reg_fns[m] if reg_fns else None
        if rf is not None:
            role = spec.mode_role(m)
            if role == "par2_B":
                if spec.constraints[m].kind == "tPARAFAC2":
                    f_tensors = f_tensors + rf(state.fac[m])
                else:
                    # slice-wise sum over k, each on its TRUE J_k rows so
                    # ragged padding never enters the penalty
                    # (cmtf_fun_AOADMM.m:1281-1284 applies reg_func{m} to the
                    # true-size B{k})
                    Bs = state.fac[m]
                    p = spec.which_p(m)
                    sizes = spec.par2_slice_sizes(p)
                    f_tensors = f_tensors + sum(
                        rf(Bs[k, :J]) for k, J in enumerate(sizes))
            else:
                f_tensors = f_tensors + rf(state.fac[m])

    if spec.ridge is not None:
        for m in range(spec.nb_modes):
            if spec.ridge[m]:
                f_tensors = f_tensors + spec.ridge[m] * jnp.sum(state.fac[m] ** 2)

    # coupling gaps (cmtf_fun_AOADMM.m:1302-1329)
    cps = []
    for cid in range(1, spec.coupling.n_couplings + 1):
        ctype = spec.coupling.coupling_type[cid - 1]
        Delta = state.coupling_fac[cid - 1]
        acc = 0.0
        for mm in spec.coupled_modes_of(cid):
            fac = state.fac[mm]
            H = data.coupl_trafo[mm] if data.coupl_trafo else None
            H2 = data.coupl_trafo2[mm] if data.coupl_trafo2 else None
            if ctype == 0:
                acc = acc + _fro(fac - Delta) / _fro(fac)
            elif ctype == 1:
                t = H @ fac
                acc = acc + _fro(t - Delta) / _fro(t)
            elif ctype == 2:
                t = fac @ H
                acc = acc + _fro(t - Delta) / _fro(t)
            elif ctype == 3:
                acc = acc + _fro(fac - H @ Delta) / _fro(fac)
            elif ctype == 4:
                acc = acc + _fro(fac - Delta @ H) / _fro(fac)
            else:
                t = H @ fac
                acc = acc + _fro(t - Delta @ H2) / _fro(t)
        cps.append(acc)
    if cps:
        cparr = jnp.stack([jnp.asarray(c) for c in cps])
        nnzc = jnp.sum(cparr != 0)
        f_couplings = jnp.where(nnzc > 0, jnp.sum(cparr) / jnp.maximum(nnzc, 1),
                                jnp.sum(cparr))
    else:
        f_couplings = jnp.asarray(0.0)

    # constraint gaps (cmtf_fun_AOADMM.m:1331-1348)
    fcs = []
    for m in range(spec.nb_modes):
        if spec.is_constrained(m):
            Z = state.constraint_fac[m]
            fac = state.fac[m]
            if spec.mode_role(m) == "par2_B":
                K = fac.shape[0]
                v = jnp.sum(_fro(fac - Z, axis=(1, 2))
                            / _fro(fac, axis=(1, 2))) / K
            else:
                v = _fro(fac - Z) / _fro(fac)
            fcs.append(v)
    if fcs:
        fcarr = jnp.stack(fcs)
        nnzc = jnp.sum(fcarr != 0)
        f_constraints = jnp.where(nnzc > 0,
                                  jnp.sum(fcarr) / jnp.maximum(nnzc, 1),
                                  jnp.sum(fcarr))
    else:
        f_constraints = jnp.asarray(0.0)

    # PARAFAC2 internal coupling gaps (cmtf_fun_AOADMM.m:1350-1362)
    f_par2 = jnp.asarray(0.0)
    any_par2 = False
    for p, ds in enumerate(spec.datasets):
        if ds.model == PAR2:
            any_par2 = True
            facB = state.fac[ds.modes[1]]
            PDB = jnp.einsum("kjr,rs->kjs", state.P[p], state.DeltaB[p])
            K = facB.shape[0]
            f_par2 = f_par2 + jnp.sum(
                _fro(facB - PDB, axis=(1, 2)) / _fro(facB, axis=(1, 2)))
    if any_par2:
        # the reference divides by K of the LAST dataset's second mode
        # (leftover loop variable, cmtf_fun_AOADMM.m:1361) — replicated.
        last_sz = spec.mode_sizes[spec.datasets[-1].modes[1]]
        div = len(last_sz) if isinstance(last_sz, (tuple, list)) else 1
        f_par2 = jnp.where(f_par2 > 0, f_par2 / div, f_par2)

    return f_tensors, f_couplings, f_constraints, f_par2
