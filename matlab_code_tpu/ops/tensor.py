"""Tensor kernels: MTTKRP, Khatri-Rao, ktensor reconstruction, Grams.

Equivalents of the Tensor Toolbox calls used by the reference (mttkrp at
cmtf_fun_AOADMM.m:97, full(ktensor(...)) at cmtf_fun_AOADMM.m:416, innerprod
at cmtf_fun_AOADMM.m:1226).  Dense MTTKRP is expressed as an einsum so XLA
contracts it as a chain of large matmuls (cuBLAS GEMMs on a GPU) instead of
materializing the Khatri-Rao product.
"""
from __future__ import annotations

import string

import jax
import jax.numpy as jnp

_LETTERS = string.ascii_lowercase


def mttkrp(X, factors: list[jnp.ndarray], mode: int) -> jnp.ndarray:
    """Matricized-tensor times Khatri-Rao product of a dense array or a
    COO SparseTensor — the one MTTKRP dispatch of the solver.

    Returns unfold(X, mode) @ khatri_rao(factors except mode), shape
    (I_mode, R).  Equivalent of Tensor Toolbox `mttkrp` as used at
    cmtf_fun_AOADMM.m:97.  Dense: the einsum contracts one mode at a time
    (optimal path), i.e. a chain of matmuls.  Sparse: `mttkrp_sparse`.
    """
    from matlab_code_tpu.problem import SparseTensor
    if isinstance(X, SparseTensor):
        return mttkrp_sparse(X.indices, X.values, list(factors), mode,
                             factors[mode].shape[0])
    n = X.ndim
    assert len(factors) == n
    tensor_sub = _LETTERS[:n]
    factor_subs = [f"{_LETTERS[i]}z" for i in range(n) if i != mode]
    operands = [X] + [factors[i] for i in range(n) if i != mode]
    eq = tensor_sub + "," + ",".join(factor_subs) + "->" + _LETTERS[mode] + "z"
    return jnp.einsum(eq, *operands, optimize=True)


def khatri_rao(factors: list[jnp.ndarray]) -> jnp.ndarray:
    """Column-wise Khatri-Rao product, rows ordered with the FIRST factor's
    index varying slowest (C order)."""
    R = factors[0].shape[1]
    out = factors[0]
    for f in factors[1:]:
        out = (out[:, None, :] * f[None, :, :]).reshape(-1, R)
    return out


def ktensor_full(factors: list[jnp.ndarray], weights: jnp.ndarray | None = None) -> jnp.ndarray:
    """Dense reconstruction of a Kruskal tensor: sum_r w_r a_r o b_r o c_r ...

    Equivalent of full(ktensor(lambda, U)) (cmtf_fun_AOADMM.m:416).
    """
    n = len(factors)
    first = factors[0] if weights is None else factors[0] * weights[None, :]
    operands = [first] + list(factors[1:])
    subs = [f"{_LETTERS[i]}z" for i in range(n)]
    eq = ",".join(subs) + "->" + _LETTERS[:n]
    return jnp.einsum(eq, *operands, optimize=True)


def mttkrp_sparse(indices: jnp.ndarray, values: jnp.ndarray,
                  factors: list[jnp.ndarray], mode: int,
                  out_dim: int) -> jnp.ndarray:
    """MTTKRP of a COO sparse tensor: O(nnz * R) gather + segment-sum.

    Equivalent of Tensor Toolbox sptensor mttkrp (used by the reference for
    sparse CP data at cmtf_fun_AOADMM.m:97): per nonzero, gather the other
    modes' factor rows and scatter-add the product into the target mode's
    row (an unsorted segment_sum).
    """
    contrib = values[:, None]
    for j, f in enumerate(factors):
        if j != mode:
            contrib = contrib * f[indices[:, j]]
    return jax.ops.segment_sum(contrib, indices[:, mode],
                               num_segments=out_dim)


def gram(U: jnp.ndarray) -> jnp.ndarray:
    """U^T U (R x R).  cmtf_fun_AOADMM.m:66."""
    return U.T @ U


def hadamard_grams(grams: list[jnp.ndarray]) -> jnp.ndarray:
    """Elementwise product of a list of R x R Grams (cmtf_fun_AOADMM.m:98-103)."""
    out = grams[0]
    for g in grams[1:]:
        out = out * g
    return out


def unfold(X: jnp.ndarray, mode: int) -> jnp.ndarray:
    """Mode-`mode` unfolding, shape (X.shape[mode], prod(rest)).

    Column ordering is C-order over the remaining modes (differs from MATLAB
    tenmat's Fortran order, but every use in the framework — Gram of the
    unfolding in cmtf_nvecs.m:39-41 — is invariant to column order).
    """
    return jnp.moveaxis(X, mode, 0).reshape(X.shape[mode], -1)


def cp_frob_objective(X: jnp.ndarray, factors: list[jnp.ndarray],
                      znorm_const: jnp.ndarray, weight: float) -> jnp.ndarray:
    """w * (||X||^2 - 2<X, M> + ||M||^2) computed via the MTTKRP trick.

    Equivalent of functions/cp_func.m:37-56 / pca_func.m:29-39 (the matrix
    case is just the 2-way einsum).
    """
    mk = mttkrp(X, factors, 0)
    f2 = jnp.sum(mk * factors[0])
    had = hadamard_grams([gram(U) for U in factors])
    f3 = jnp.sum(had)
    return weight * (znorm_const - 2.0 * f2 + f3)


def masked_frob_norm_sq(X: jnp.ndarray, mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """||mask .* X||_F^2 (mask optional)."""
    if mask is None:
        return jnp.sum(X * X)
    Xm = jnp.where(mask, X, 0.0)
    return jnp.sum(Xm * Xm)
