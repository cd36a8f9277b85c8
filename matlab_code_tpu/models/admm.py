"""Inner ADMM loops: constrained-only, PARAFAC2-Bk, and the six coupled
variants (coupling types 0-5).

JAX equivalents of the nested functions in cmtf_fun_AOADMM.m:509-1075.
Each loop is a lax.while_loop carrying the full SolverState; per-slice /
per-row PARAFAC2 work is batched over K (vmap-free einsums + batched
cholesky/SVD), and problem structure (which modes, which roles, which
constraint) is resolved at trace time so XLA sees straight-line code.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from matlab_code_tpu.ops.linalg import (
    chol_lower, solve_with_chol, solve_spd_left, spd_inverse_from_chol,
    spd_inverse_newton, polar_orth, polar_orth_ns)
from matlab_code_tpu.problem import ProblemSpec
from matlab_code_tpu.state import SolverState, tuple_set

_fro = jnp.linalg.norm


def _safe_div(a, b):
    """a/b, but a when b == 0 (the residual-scaling convention at
    cmtf_fun_AOADMM.m:1087-1092)."""
    return jnp.where(b > 0, a / jnp.where(b > 0, b, 1.0), a)


# ---------------------------------------------------------------------------
# constraint prox step + residuals
# ---------------------------------------------------------------------------


def make_update_constraint(spec: ProblemSpec, proxes):
    """Z = prox(fac + mu, rho); mu += fac - Z (cmtf_fun_AOADMM.m:1420-1429).
    PAR2-C modes use max(rho) over the per-row penalties (:1423-1424)."""
    def upd(state: SolverState, m: int, rho):
        prox = proxes[m]
        oldZ = state.constraint_fac[m]
        role = spec.mode_role(m)
        rho_eff = jnp.max(rho) if role == "par2_C" else rho
        Z = prox(state.fac[m] + state.constraint_dual_fac[m], rho_eff)
        dual = state.constraint_dual_fac[m] + state.fac[m] - Z
        state = state.replace(
            constraint_fac=tuple_set(state.constraint_fac, m, Z),
            constraint_dual_fac=tuple_set(state.constraint_dual_fac, m, dual))
        return state, oldZ
    return upd


def _chol_rcond_bad(L, tol: float):
    """Early ill-conditioning check on a Cholesky factor (or batch of them):
    the rcond estimate (min/max diagonal)^2 below tol, or non-finite.  The
    analogue of the reference's nearlySingularMatrix promotion
    (cmtf_fun_AOADMM.m:83-84)."""
    d = jnp.abs(jnp.diagonal(L, axis1=-2, axis2=-1))
    r = (jnp.min(d) / jnp.max(d)) ** 2
    return ~jnp.isfinite(r) | (r < tol)


def make_spd_solver(Bmat, options, illtol: float = 0.0, lmin=None):
    """Build the inner-ADMM solver pair for the assembled SPD normal matrix
    (built ONCE per outer iteration, outside the inner while_loop, so
    factorization / inversion amortizes over inner iterations).

    Returns (right, rowleft, illc):
      right(A):  solve X B = A with A row-shaped (the reference's (A/L')/L,
                 cmtf_fun_AOADMM.m:608-609)
      rowleft(A): row-batched B_k x_k = a_k, A (K, R) -> (K, R) (the PAR2-C
                 per-row systems, cmtf_fun_AOADMM.m:602-606)
      illc:      ill-conditioning flag (the nearlySingularMatrix analogue,
                 cmtf_fun_AOADMM.m:83-84); always False when illtol == 0.

    Method per options.inner_solve (see AlgOptions; 'auto' must already be
    resolved, options.resolve_auto): 'chol' factorizes and substitutes per
    call; 'inverse' factorizes and inverts once; 'newton' inverts by
    matmul-only Newton-Hotelling.  lmin: optional eigenvalue lower bound
    (the + rho/2 I terms of the ADMM systems) sharpening the Newton initial
    scaling.
    """
    method = options.inner_solve
    if method not in ("chol", "inverse", "newton"):
        raise ValueError(f"inner_solve {method!r} is not resolved; pass "
                         f"options through options.resolve_auto first")
    # An explicit inverse stands in for two triangular solves, which run in
    # full precision; so it is applied at HIGHEST, never in TF32/bf16 (on a
    # GPU under 'default' that lower precision kept the flagship fit from
    # converging, PERF.md).
    hi = lax.Precision.HIGHEST
    if method == "newton":
        Binv, rcond = spd_inverse_newton(Bmat, lmin=lmin)
        if illtol > 0:
            illc = jnp.any(~jnp.isfinite(rcond) | (rcond < illtol))
        else:
            illc = jnp.bool_(False)
    else:
        L = chol_lower(Bmat)
        illc = _chol_rcond_bad(L, illtol) if illtol > 0 else jnp.bool_(False)
        if method == "chol":
            return (lambda A: solve_with_chol(L, A),
                    lambda A: solve_spd_left(L, A[..., None])[..., 0], illc)
        Binv = spd_inverse_from_chol(L)
    return (lambda A: jnp.matmul(A, Binv, precision=hi),
            lambda A: jnp.matmul(Binv, A[..., None], precision=hi)[..., 0],
            illc)


def eval_res_constr(spec: ProblemSpec, state: SolverState, modes, oldZ: dict):
    """Relative primal/dual constraint residuals averaged over `modes`
    (cmtf_fun_AOADMM.m:1079-1096)."""
    pr = 0.0
    dr = 0.0
    for mm in modes:
        fac, Z = state.fac[mm], state.constraint_fac[mm]
        pr = pr + _fro(fac - Z) / _fro(fac)
        scaling = _fro(state.constraint_dual_fac[mm])
        dr = dr + _safe_div(_fro(Z - oldZ[mm]), scaling)
    return pr / len(modes), dr / len(modes)


# ---------------------------------------------------------------------------
# ADMM: constrained, uncoupled mode (cmtf_fun_AOADMM.m:591-623)
# ---------------------------------------------------------------------------


def admm_constrained_only(spec: ProblemSpec, state: SolverState, m: int, p: int,
                          A, solve, rho, options, proxes, lbfgs_step=None,
                          data=None):
    """Returns (state, inner_iters, lbfgsb_total).  solve: prebuilt
    right/rowleft solver from make_spd_solver (None for non-Frobenius)."""
    upd = make_update_constraint(spec, proxes)
    role = spec.mode_role(m)
    frob = spec.datasets[p].loss == "Frobenius"

    def cond(c):
        state, it, pr, dr, lb = c
        return (it <= options.MaxInnerIters) & (
            (pr > options.innerRelPrTol_constr) |
            (dr > options.innerRelDualTol_constr))

    def body(c):
        state, it, pr, dr, lb = c
        if frob:
            if role == "par2_C":
                # row-wise batched solve (cmtf_fun_AOADMM.m:602-606)
                A_inner = A + 0.5 * rho[:, None] * (
                    state.constraint_fac[m] - state.constraint_dual_fac[m])
            else:
                A_inner = A + 0.5 * rho * (
                    state.constraint_fac[m] - state.constraint_dual_fac[m])
            fac = solve(A_inner)
            state = state.replace(fac=tuple_set(state.fac, m, fac))
        else:
            state, nit = lbfgs_step(state, data, constrained=True,
                                    coupling_type=-1, rho=rho)
            lb = lb + nit
        state, oldZ = upd(state, m, rho)
        pr, dr = eval_res_constr(spec, state, (m,), {m: oldZ})
        return (state, it + 1, pr, dr, lb)

    inf = jnp.inf
    init = (state, jnp.int32(1), jnp.asarray(inf), jnp.asarray(inf), jnp.int32(0))
    state, it, pr, dr, lb = lax.while_loop(cond, body, init)
    return state, it - 1, lb, (pr, dr)


# ---------------------------------------------------------------------------
# ADMM: PARAFAC2 Bk (cmtf_fun_AOADMM.m:509-589)
# ---------------------------------------------------------------------------


def admm_b_parafac2(spec: ProblemSpec, state: SolverState, m: int, p: int,
                    A, solve, rho, options, proxes, constraint_active: bool,
                    sizes=None):
    """The PARAFAC2-specific inner loop, batched over slices.

    A: (K, Jmax, R); solve: prebuilt K-batched right solver from
    make_spd_solver; rho: (K,).  sizes: static tuple of the true slice
    sizes J_k, or None for regular (equal-size) slices — ragged slices get
    the size-bucketed prox so row-coupled projections never see the zero
    padding.
    """
    K = spec.par2_K(p)
    constrained = spec.is_constrained(m) and constraint_active
    ragged = sizes is not None and len(set(sizes)) > 1
    # P_k polar method ('auto' already resolved, options.resolve_auto)
    method = options.par2_polar
    if method not in ("svd", "ns"):
        raise ValueError(f"par2_polar {method!r} is not resolved; pass "
                         f"options through options.resolve_auto first")
    polar = polar_orth if method == "svd" else partial(
        polar_orth_ns, iters=options.par2_polar_iters)
    if constrained:
        kind = spec.constraints[m].kind
        upd_joint = kind == "tPARAFAC2"
        prox = proxes[m]

    def cond(c):
        state, it, prc, drc, prk, drk = c
        return (it <= options.MaxInnerIters) & (
            (prk > options.innerRelPrTol_coupl) |
            (prc > options.innerRelPrTol_constr) |
            (drk > options.innerRelDualTol_coupl) |
            (drc > options.innerRelDualTol_constr))

    def body(c):
        state, it, prc, drc, prk, drk = c
        P_, DB, mu = state.P[p], state.DeltaB[p], state.mu_DeltaB[p]
        A_inner = A + 0.5 * rho[:, None, None] * (
            jnp.einsum("kjr,rs->kjs", P_, DB) - mu)
        if constrained:
            A_inner = A_inner + 0.5 * rho[:, None, None] * (
                state.constraint_fac[m] - state.constraint_dual_fac[m])
        facB = solve(A_inner)
        # P_k = polar((B_k + mu_k) DeltaB^T)  (cmtf_fun_AOADMM.m:532-534)
        oldP = P_
        P_ = polar(jnp.einsum("kjr,sr->kjs", facB + mu, DB))
        # DeltaB = sum_k rho_k P_k^T (B_k + mu_k) / sum rho_k  (:536-544)
        oldDB = DB
        DB = jnp.einsum("k,kjr,kjs->rs", rho, P_, facB + mu) / jnp.sum(rho)
        PDB = jnp.einsum("kjr,rs->kjs", P_, DB)
        mu = mu + facB - PDB
        state = state.replace(
            fac=tuple_set(state.fac, m, facB),
            P=tuple_set(state.P, p, P_),
            DeltaB=tuple_set(state.DeltaB, p, DB),
            mu_DeltaB=tuple_set(state.mu_DeltaB, p, mu))

        prc_, drc_ = jnp.asarray(0.0), jnp.asarray(0.0)
        if constrained:
            oldZ = state.constraint_fac[m]
            if upd_joint:
                Z = prox(facB + state.constraint_dual_fac[m], rho)
            elif ragged:
                Z = prox_slicewise_ragged(
                    prox, facB + state.constraint_dual_fac[m], rho, sizes)
            else:
                Z = prox_slicewise(prox, facB + state.constraint_dual_fac[m], rho)
            dual = state.constraint_dual_fac[m] + facB - Z
            state = state.replace(
                constraint_fac=tuple_set(state.constraint_fac, m, Z),
                constraint_dual_fac=tuple_set(state.constraint_dual_fac, m, dual))
            nrm_f = _fro(facB, axis=(1, 2))
            prc_ = jnp.sum(_fro(facB - Z, axis=(1, 2)) / nrm_f) / K
            scal = _fro(dual, axis=(1, 2))
            drc_ = jnp.sum(_safe_div(_fro(oldZ - Z, axis=(1, 2)), scal)) / K

        nrm_f = _fro(facB, axis=(1, 2))
        prk_ = jnp.sum(_fro(facB - PDB, axis=(1, 2)) / nrm_f) / K
        oldPDB = jnp.einsum("kjr,rs->kjs", oldP, oldDB)
        scal = _fro(mu, axis=(1, 2))
        drk_ = jnp.sum(_safe_div(_fro(oldPDB - PDB, axis=(1, 2)), scal)) / K
        return (state, it + 1, prc_, drc_, prk_, drk_)

    inf = jnp.asarray(jnp.inf)
    init = (state, jnp.int32(1), inf, inf, inf, inf)
    state, it, *_ = lax.while_loop(cond, body, init)
    return state, it - 1


def prox_slicewise(prox, Bs, rho):
    """Apply a matrix prox per slice k with its own rho_k
    (cmtf_fun_AOADMM.m:567-578)."""
    return jax.vmap(prox)(Bs, rho)


def prox_slicewise_ragged(prox, Bs, rho, sizes):
    """Slice-wise prox on RAGGED padded slices: each slice k is proxed on its
    true J_k rows only, exactly like the reference's per-slice
    Z.prox_operators{m}(B{k}, rho(k)) on true-size matrices
    (cmtf_fun_AOADMM.m:567-578).

    Slice sizes are static (ProblemSpec.mode_sizes), so slices are bucketed
    by size at trace time and each bucket runs one vmapped prox on exact
    shapes — row-coupled projections (PAVA/unimodality, simplex, TV, ...)
    never see the zero padding, and padded rows stay exactly zero.

    Bs: (K, Jmax, R) padded; rho: (K,); sizes: static tuple of J_k.
    """
    out = jnp.zeros_like(Bs)
    buckets: dict[int, list[int]] = {}
    for k, J in enumerate(sizes):
        buckets.setdefault(int(J), []).append(k)
    for J, ks in sorted(buckets.items()):
        idx = jnp.asarray(ks)
        sub = Bs[idx, :J, :]
        res = jax.vmap(prox)(sub, rho[idx])
        out = out.at[idx, :J, :].set(res)
    return out


# ---------------------------------------------------------------------------
# coupled-ADMM machinery (cases 0..5, cmtf_fun_AOADMM.m:625-1075)
# ---------------------------------------------------------------------------


def _is_par2C(spec, m):
    return spec.mode_role(m) == "par2_C"


def _factor_update_case(spec, state, data, m, cid, ctype, A, L, B, B2, rho,
                        constrained, solve=None):
    """One coupled-factor update for mode m (Frobenius loss)."""
    from matlab_code_tpu.ops.linalg import sylvester_sym, block_diag
    Delta = state.coupling_fac[cid - 1]
    dual = state.coupling_dual_fac[m]
    H = data.coupl_trafo[m] if data.coupl_trafo else None
    H2 = data.coupl_trafo2[m] if data.coupl_trafo2 else None
    par2C = _is_par2C(spec, m)

    if ctype in (1, 5):
        target = Delta if ctype == 1 else Delta @ H2
        if par2C:
            # vectorized kron solve (cmtf_fun_AOADMM.m:710-722, 998-1010);
            # row-major ravel of (K, R) matches MATLAB's reshape(M',[],1).
            K, R = state.fac[m].shape
            rhoC = jnp.mean(rho)
            A_large = A.reshape(K * R)
            HcI = jnp.kron(H, jnp.eye(R, dtype=A.dtype))
            v = (target - dual).reshape(-1)
            A_inner = A_large + 0.5 * rhoC * (HcI.T @ v)
            if constrained:
                A_inner = A_inner + 0.5 * rhoC * (
                    state.constraint_fac[m] - state.constraint_dual_fac[m]
                ).reshape(-1)
            fac = solve_spd_left(L, A_inner[:, None])[:, 0].reshape(K, R)
        else:
            A_inner = A + 0.5 * rho * (H.T @ (target - dual))
            if constrained:
                A_inner = A_inner + 0.5 * rho * (
                    state.constraint_fac[m] - state.constraint_dual_fac[m])
            fac = sylvester_sym(B2, B, A_inner)
        return fac

    # ctypes 0/2/3/4 (PAR2-C rows get a per-row rho broadcast)
    rho_b = rho[:, None] if par2C else rho
    if ctype == 0:
        extra = Delta - dual
    elif ctype == 2:
        extra = (Delta - dual) @ H.T
    elif ctype == 3:
        extra = H @ Delta - dual
    else:  # 4
        extra = Delta @ H - dual
    A_inner = A + 0.5 * rho_b * extra
    if constrained:
        A_inner = A_inner + 0.5 * rho_b * (
            state.constraint_fac[m] - state.constraint_dual_fac[m])
    return solve(A_inner)


def _delta_update(spec, state, data, cmodes, cid, ctype, rhos):
    """Consensus Delta update for each coupling type
    (cmtf_fun_AOADMM.m:660-675, 737-749, 807-815, 872-881, 938-963, 1026-1054)."""
    Delta = state.coupling_fac[cid - 1]
    dt = Delta.dtype

    if ctype == 0:
        num = jnp.zeros_like(Delta)
        sum_rho = jnp.asarray(0.0, dt)
        for jj in cmodes:
            r = rhos[jj]
            contrib = state.fac[jj] + state.coupling_dual_fac[jj]
            num = num + (r[:, None] if _is_par2C(spec, jj) else r) * contrib
            sum_rho = sum_rho + r
        return num / (sum_rho[:, None] if jnp.ndim(sum_rho) else sum_rho)

    if ctype == 1:
        num = jnp.zeros_like(Delta)
        sum_rho = jnp.asarray(0.0, dt)
        for jj in cmodes:
            r = jnp.sum(rhos[jj])   # sum(rho{jj}) (cmtf_fun_AOADMM.m:742)
            num = num + r * (data.coupl_trafo[jj] @ state.fac[jj]
                             + state.coupling_dual_fac[jj])
            sum_rho = sum_rho + r
        return num / sum_rho

    if ctype == 2:
        num = jnp.zeros_like(Delta)
        sum_rho = jnp.asarray(0.0, dt)
        for jj in cmodes:
            r = rhos[jj]
            contrib = state.fac[jj] @ data.coupl_trafo[jj] \
                + state.coupling_dual_fac[jj]
            num = num + (r[:, None] if _is_par2C(spec, jj) else r) * contrib
            sum_rho = sum_rho + r
        return num / (sum_rho[:, None] if jnp.ndim(sum_rho) else sum_rho)

    if ctype == 3:
        H0 = data.coupl_trafo[cmodes[0]]
        AA = jnp.zeros((H0.shape[1], H0.shape[1]), dt)
        BB = jnp.zeros((H0.shape[1], state.fac[cmodes[0]].shape[1]), dt)
        for jj in cmodes:
            H = data.coupl_trafo[jj]
            r = rhos[jj]
            rH = (r[:, None] * H) if _is_par2C(spec, jj) else r * H
            AA = AA + H.T @ rH
            contrib = state.fac[jj] + state.coupling_dual_fac[jj]
            BB = BB + H.T @ ((r[:, None] if _is_par2C(spec, jj) else r) * contrib)
        return jnp.linalg.solve(AA, BB)

    if ctype == 4:
        H0 = data.coupl_trafo[cmodes[0]]
        D = H0.shape[0]
        AA = jnp.zeros((D, D), dt)
        BB = jnp.zeros((state.fac[cmodes[0]].shape[0], D), dt)
        AA_PAR2 = None
        for jj in cmodes:
            H = data.coupl_trafo[jj]
            r = rhos[jj]
            if _is_par2C(spec, jj):
                AA_PAR2 = r[:, None, None] * (H @ H.T)[None]   # (K, D, D)
            else:
                AA = AA + r * (H @ H.T)
            contrib = state.fac[jj] + state.coupling_dual_fac[jj]
            BB = BB + ((r[:, None] if _is_par2C(spec, jj) else r) * contrib) @ H.T
        if AA_PAR2 is not None:
            # row-wise solves Delta(k,:) (AA + AA_PAR2_k) = BB(k,:)
            sys = AA[None] + AA_PAR2
            return jnp.linalg.solve(
                jnp.swapaxes(sys, -1, -2), BB[:, :, None])[:, :, 0]
        return jnp.linalg.solve(AA.T, BB.T).T

    # ctype == 5: NOTE the reference uses rho of the LAST coupled mode (the
    # leftover loop variable `mm`) for every term (cmtf_fun_AOADMM.m:1032);
    # replicated literally.
    rhoC = jnp.mean(rhos[cmodes[-1]])
    H20 = data.coupl_trafo2[cmodes[0]]
    D2 = H20.shape[0]
    AA = jnp.zeros((D2, D2), dt)
    BB = jnp.zeros((data.coupl_trafo[cmodes[0]].shape[0], D2), dt)
    AA_PAR2 = None
    for jj in cmodes:
        H, H2 = data.coupl_trafo[jj], data.coupl_trafo2[jj]
        r = rhos[jj]
        if _is_par2C(spec, jj):
            AA_PAR2 = r[:, None, None] * (H2 @ H2.T)[None]
        else:
            AA = AA + rhoC * (H2 @ H2.T)
        BB = BB + rhoC * (H @ state.fac[jj]
                          + state.coupling_dual_fac[jj]) @ H2.T
    if AA_PAR2 is not None:
        sys = AA[None] + AA_PAR2
        return jnp.linalg.solve(jnp.swapaxes(sys, -1, -2), BB[:, :, None])[:, :, 0]
    return jnp.linalg.solve(AA.T, BB.T).T


def _dual_update(spec, state, data, m, cid, ctype):
    Delta = state.coupling_fac[cid - 1]
    dual = state.coupling_dual_fac[m]
    H = data.coupl_trafo[m] if data.coupl_trafo else None
    H2 = data.coupl_trafo2[m] if data.coupl_trafo2 else None
    fac = state.fac[m]
    if ctype == 0:
        return dual + fac - Delta
    if ctype == 1:
        return dual + H @ fac - Delta
    if ctype == 2:
        return dual + fac @ H - Delta
    if ctype == 3:
        return dual + fac - H @ Delta
    if ctype == 4:
        return dual + fac - Delta @ H
    return dual + H @ fac - Delta @ H2


def _coupling_transform(spec, state, data, m, ctype):
    """transform(fac) whose gap to Delta defines the primal residual."""
    fac = state.fac[m]
    if ctype in (0, 3, 4):
        return fac
    H = data.coupl_trafo[m]
    if ctype in (1, 5):
        return H @ fac
    return fac @ H


def eval_res_coupling(spec, state, data, cmodes, cid, ctype, oldDelta):
    """Relative primal/dual coupling residuals (cmtf_fun_AOADMM.m:1099-1210)."""
    Delta = state.coupling_fac[cid - 1]
    pr = 0.0
    dr = 0.0
    for mm in cmodes:
        t = _coupling_transform(spec, state, data, mm, ctype)
        if ctype in (0, 1, 2):
            gap = t - Delta
            nrm = _fro(t) if ctype in (1, 2) else _fro(state.fac[mm])
            dgap = Delta - oldDelta
        elif ctype == 3:
            H = data.coupl_trafo[mm]
            gap = state.fac[mm] - H @ Delta
            nrm = _fro(state.fac[mm])
            dgap = H @ (Delta - oldDelta)
        elif ctype == 4:
            H = data.coupl_trafo[mm]
            gap = state.fac[mm] - Delta @ H
            nrm = _fro(state.fac[mm])
            dgap = (Delta - oldDelta) @ H
        else:  # 5
            H, H2 = data.coupl_trafo[mm], data.coupl_trafo2[mm]
            gap = H @ state.fac[mm] - Delta @ H2
            nrm = _fro(state.fac[mm])
            dgap = (Delta - oldDelta) @ H2
        pr = pr + _fro(gap) / nrm
        dr = dr + _safe_div(_fro(dgap), _fro(state.coupling_dual_fac[mm]))
    return pr / len(cmodes), dr / len(cmodes)


def admm_coupled(spec: ProblemSpec, state: SolverState, data, cmodes, cid,
                 ctype, As, Ls, Bs, B2s, rhos, options, proxes,
                 lbfgs_steps=None, solvers=None):
    """Unified coupled-ADMM loop covering cases 0-5
    (cmtf_fun_AOADMM.m:625-1075).  As/Ls/Bs/B2s/rhos: dicts keyed by mode.
    solvers: per-mode right/rowleft solver fns prebuilt by make_spd_solver
    OUTSIDE the while_loop (so inverse/newton factorization amortizes over
    inner iterations); the case-1/5 paths keep L (kron-vectorized solve /
    Sylvester).

    Returns (state, inner_iters, lbfgsb_totals dict)."""
    upd = make_update_constraint(spec, proxes)
    constrained_modes = tuple(m for m in cmodes if spec.is_constrained(m))
    solvers = solvers or {}

    def cond(c):
        state, it, prc, drc, prk, drk, lb = c
        return (it <= options.MaxInnerIters) & (
            (prk > options.innerRelPrTol_coupl) |
            (prc > options.innerRelPrTol_constr) |
            (drk > options.innerRelDualTol_coupl) |
            (drc > options.innerRelDualTol_constr))

    def body(c):
        state, it, prc, drc, prk, drk, lb = c
        # factor updates
        for mm in cmodes:
            pp = spec.which_p(mm)
            if spec.datasets[pp].loss == "Frobenius":
                fac = _factor_update_case(
                    spec, state, data, mm, cid, ctype, As[mm], Ls[mm],
                    Bs.get(mm), B2s.get(mm), rhos[mm],
                    spec.is_constrained(mm), solve=solvers.get(mm))
                state = state.replace(fac=tuple_set(state.fac, mm, fac))
            else:
                state, nit = lbfgs_steps[mm](
                    state, data, constrained=spec.is_constrained(mm),
                    coupling_type=ctype, rho=rhos[mm])
                lb = {**lb, mm: lb[mm] + nit}
        # Delta update
        oldDelta = state.coupling_fac[cid - 1]
        Delta = _delta_update(spec, state, data, cmodes, cid, ctype, rhos)
        state = state.replace(
            coupling_fac=tuple_set(state.coupling_fac, cid - 1, Delta))
        # dual + constraint updates
        oldZ = {}
        for mm in cmodes:
            nd = _dual_update(spec, state, data, mm, cid, ctype)
            state = state.replace(
                coupling_dual_fac=tuple_set(state.coupling_dual_fac, mm, nd))
            if spec.is_constrained(mm):
                state, z = upd(state, mm, rhos[mm])
                oldZ[mm] = z
        prk_, drk_ = eval_res_coupling(spec, state, data, cmodes, cid, ctype,
                                       oldDelta)
        if constrained_modes:
            prc_, drc_ = eval_res_constr(spec, state, constrained_modes, oldZ)
        else:
            prc_, drc_ = jnp.asarray(0.0), jnp.asarray(0.0)
        return (state, it + 1, prc_, drc_, prk_, drk_, lb)

    inf = jnp.asarray(jnp.inf)
    lb0 = {m: jnp.int32(0) for m in cmodes
           if spec.datasets[spec.which_p(m)].loss != "Frobenius"}
    init = (state, jnp.int32(1), inf, inf, inf, inf, lb0)
    state, it, prc, drc, prk, drk, lb = lax.while_loop(cond, body, init)
    return state, it - 1, lb, (jnp.maximum(prc, prk), jnp.maximum(drc, drk))
