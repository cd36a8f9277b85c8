"""Per-mode precompute for the AO sweep: MTTKRPs, Gram-Hadamards, the rho
heuristic, and the (regularized) normal-equation matrices.

Equivalents of cmtf_fun_AOADMM.m:92-251.  The PARAFAC2 per-slice loops are
replaced by batched einsums over the stacked (K, ., .) arrays, so every
slice's matmul runs as one batched contraction; padded (ragged) rows/columns
are zero and drop out of all sums.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from matlab_code_tpu.ops.tensor import mttkrp, gram, hadamard_grams
from matlab_code_tpu.problem import ProblemSpec, ProblemData, CP, PAR2


class ModePre(NamedTuple):
    """Precomputed quantities for one mode's update."""
    A: jnp.ndarray | None        # RHS (I,R) | (K,Jmax,R) Bk | (K,R) par2C
    B: jnp.ndarray | None        # normal matrix before coupling/constraint terms
    rho: jnp.ndarray | None      # scalar, or (K,) for par2 B/C modes
    last_mttkrp: jnp.ndarray | None
    last_had: jnp.ndarray | None


def _ridge_eye(spec: ProblemSpec, m: int, R: int, dtype) -> jnp.ndarray | None:
    if spec.ridge is not None and spec.ridge[m]:
        return spec.ridge[m] * jnp.eye(R, dtype=dtype)
    return None


def cp_mode_precompute(spec: ProblemSpec, data: ProblemData, state, grams,
                       p: int, m: int, options, partials: dict | None = None,
                       mttkrp_impl=None) -> ModePre:
    """CP / matrix mode precompute (cmtf_fun_AOADMM.m:96-127).

    partials: optional per-sweep dimension-tree cache.  For 3-way tensors the
    partial T1 = X x_0 A (einsum 'ijk,ir->jkr') is shared by the mode-1 and
    mode-2 MTTKRPs, saving one full data pass per sweep.  The cache is keyed
    by the identity of the mode-0 factor's traced value, so Gauss-Seidel
    ordering is preserved exactly: a T1 built from a stale A is never reused
    after A updates.

    mttkrp_impl: optional explicit-collective MTTKRP (shard_map path,
    parallel/shard_mttkrp.py) replacing the einsum for this (dataset, mode).
    """
    from matlab_code_tpu.problem import SparseTensor
    ds = spec.datasets[p]
    X = data.objects[p]
    w = ds.weight
    R = ds.rank
    local = ds.modes.index(m)
    sparse = isinstance(X, SparseTensor)
    if mttkrp_impl is not None and (sparse or X.ndim >= 3):
        # explicit shard_map collective (dense mode-partitioned or sparse
        # nnz-partitioned, parallel/shard_mttkrp.py)
        A = w * mttkrp_impl(X, tuple(state.fac[j] for j in ds.modes))
        C = hadamard_grams([grams[j] for j in ds.modes if j != m])
    elif not sparse and X.ndim == 3 and local > 0 and partials is not None \
            and options.cp_dimension_tree and R <= X.shape[0]:
        m0 = ds.modes[0]
        A0 = state.fac[m0]
        hit = partials.get(p)
        if hit is None or hit[0] is not A0:
            T1 = jnp.einsum("ijk,ir->jkr", X, A0, optimize=True)
            partials[p] = (A0, T1)
        else:
            T1 = hit[1]
        if local == 1:
            A = w * jnp.einsum("jkr,kr->jr", T1, state.fac[ds.modes[2]],
                               optimize=True)
        else:
            A = w * jnp.einsum("jkr,jr->kr", T1, state.fac[ds.modes[1]],
                               optimize=True)
        C = hadamard_grams([grams[j] for j in ds.modes if j != m])
    elif sparse or X.ndim >= 3:
        A = w * mttkrp(X, [state.fac[j] for j in ds.modes], local)
        C = hadamard_grams([grams[j] for j in ds.modes if j != m])
    else:
        other = ds.modes[1 - local]
        if local == 0:
            A = w * (X @ state.fac[other])
        else:
            A = w * (X.T @ state.fac[other])
        C = grams[other]
    rho = jnp.trace(C) / R
    B = w * C
    last_mttkrp = A / w
    last_had = C
    re = _ridge_eye(spec, m, R, A.dtype)
    if re is not None:
        B = B + re
    if options.bsum:
        A = A + options.bsum_weight / 2.0 * state.fac[m]
        B = B + options.bsum_weight / 2.0 * jnp.eye(R, dtype=A.dtype)
    return ModePre(A=A, B=B, rho=rho, last_mttkrp=last_mttkrp, last_had=last_had)


def par2_gram_Bk(facB: jnp.ndarray) -> jnp.ndarray:
    """(K, Jmax, R) -> per-slice Grams (K, R, R)."""
    return jnp.einsum("kjr,kjs->krs", facB, facB, optimize=True)


def par2A_precompute(spec: ProblemSpec, data: ProblemData, state, grams,
                     p: int, m: int, options) -> ModePre:
    """First PARAFAC2 mode: A = sum_k X_k B_k diag(c_k),
    C = sum_k diag(c_k) B_k^T B_k diag(c_k)  (cmtf_fun_AOADMM.m:159-178)."""
    ds = spec.datasets[p]
    X = data.objects[p]            # Parafac2Tensor
    mB, mC = ds.modes[1], ds.modes[2]
    w = ds.weight
    R = ds.rank
    facB, facC = state.fac[mB], state.fac[mC]
    A0 = jnp.einsum("kij,kjr,kr->ir", X.slices, facB, facC, optimize=True)
    C = jnp.einsum("kr,krs,ks->rs", facC, grams[mB], facC, optimize=True)
    last_mttkrp, last_had = A0, C
    A = w * A0
    rho = jnp.trace(C) / R
    B = w * C
    re = _ridge_eye(spec, m, R, A.dtype)
    if re is not None:
        B = B + re
    if options.bsum:
        A = A + options.bsum_weight / 2.0 * state.fac[m]
        B = B + options.bsum_weight / 2.0 * jnp.eye(R, dtype=A.dtype)
    return ModePre(A=A, B=B, rho=rho, last_mttkrp=last_mttkrp, last_had=last_had)


def _par2_W(spec, data, state, p, partials):
    """Shared PARAFAC2 partial W = X_k^T A (K, Jmax, R), keyed by the
    identity of the A factor's traced value so a stale A is never reused
    (the Bk and C precomputes both run after the A update in the reference
    sweep order, cmtf_fun_AOADMM.m:191-248)."""
    ds = spec.datasets[p]
    mA = ds.modes[0]
    facA = state.fac[mA]
    key = ("par2W", p)
    if partials is not None:
        hit = partials.get(key)
        if hit is not None and hit[0] is facA:
            return hit[1]
    W = jnp.einsum("kij,ir->kjr", data.objects[p].slices, facA,
                   optimize=True)
    if partials is not None:
        partials[key] = (facA, W)
    return W


def par2B_precompute(spec: ProblemSpec, data: ProblemData, state, grams,
                     p: int, m: int, options, constraint_active: bool,
                     partials: dict | None = None):
    """Second PARAFAC2 mode (per-slice), batched (cmtf_fun_AOADMM.m:191-213).

    Returns (A (K,Jmax,R), B (K,R,R) the fully assembled normal matrix
    incl. the always-on internal-coupling rho_k/2 I and, when the
    constraint is active this outer iteration, another rho_k/2 I), rho (K,).
    The caller factorizes/inverts B via make_spd_solver (per
    options.inner_solve; the newton mode never builds a Cholesky factor).
    """
    ds = spec.datasets[p]
    X = data.objects[p]
    mA, mC = ds.modes[0], ds.modes[2]
    w = ds.weight
    R = ds.rank
    facA, facC = state.fac[mA], state.fac[mC]
    W = _par2_W(spec, data, state, p, partials)
    A = w * (W * facC[:, None, :])
    C = jnp.einsum("kr,rs,ks->krs", facC, grams[mA], facC, optimize=True)
    rho = jnp.trace(C, axis1=1, axis2=2) / R
    if options.increase_factor_rhoBk is not None:
        rho = options.increase_factor_rhoBk * rho
    B = w * C
    eye = jnp.eye(R, dtype=A.dtype)
    B = B + 0.5 * rho[:, None, None] * eye          # always coupled (line 200)
    re = _ridge_eye(spec, m, R, A.dtype)
    if re is not None:
        B = B + re
    if options.bsum:
        A = A + options.bsum_weight / 2.0 * state.fac[m]
        B = B + options.bsum_weight / 2.0 * eye
    if constraint_active:
        B = B + 0.5 * rho[:, None, None] * eye      # line 209-211
    return A, B, rho


def par2C_precompute(spec: ProblemSpec, data: ProblemData, state, grams,
                     p: int, m: int, options,
                     partials: dict | None = None) -> ModePre:
    """Third PARAFAC2 mode, row-wise batched (cmtf_fun_AOADMM.m:219-233).

    A: (K, R) rows w * diag(A^T X_k B_k) = w * colsum(W_k .* B_k);
    B: (K, R, R) = GramA .* GramB_k."""
    ds = spec.datasets[p]
    X = data.objects[p]
    mA, mB = ds.modes[0], ds.modes[1]
    w = ds.weight
    R = ds.rank
    facA, facB = state.fac[mA], state.fac[mB]
    W = _par2_W(spec, data, state, p, partials)
    A = w * jnp.einsum("kjr,kjr->kr", W, facB, optimize=True)
    C = grams[mA][None, :, :] * grams[mB]
    rho = jnp.trace(C, axis1=1, axis2=2) / R
    B = w * C
    re = _ridge_eye(spec, m, R, A.dtype)
    if re is not None:
        B = B + re
    if options.bsum:
        A = A + options.bsum_weight / 2.0 * state.fac[m]
        B = B + options.bsum_weight / 2.0 * jnp.eye(R, dtype=A.dtype)
    return ModePre(A=A, B=B, rho=rho, last_mttkrp=None, last_had=None)


def refresh_gram(spec: ProblemSpec, state, grams: tuple, m: int) -> tuple:
    """G_transp_G refresh after a mode update (cmtf_fun_AOADMM.m:148,190,216,396)."""
    role = spec.mode_role(m)
    g = par2_gram_Bk(state.fac[m]) if role == "par2_B" else gram(state.fac[m])
    return grams[:m] + (g,) + grams[m + 1:]


def nonfrob_rho(colnorms: jnp.ndarray, m: int) -> jnp.ndarray:
    """rho for non-Frobenius losses: sum of squared column norms over all OTHER
    modes (cmtf_fun_AOADMM.m:129, literally including zero entries of
    Frobenius modes)."""
    return jnp.sum(colnorms) - colnorms[m]


def refresh_colnorm_init(state, m: int) -> jnp.ndarray:
    """Initial sum of squared column norms (cmtf_fun_AOADMM.m:77-80)."""
    return jnp.sum(state.fac[m] ** 2)


def refresh_colnorm_update(state, m: int) -> jnp.ndarray:
    """Post-update refresh.  NOTE: the reference overwrites instead of
    accumulating inside the r-loop (cmtf_fun_AOADMM.m:151-153,399-401), so the
    refreshed value is the squared norm of the LAST column only.  Replicated
    literally for trajectory parity."""
    return jnp.sum(state.fac[m][:, -1] ** 2)
