"""Proximal operators / projections for all constraint types, plus the
constraint -> prox dispatch (the JAX constraints_to_prox).

Every kernel is a batched jnp op with signature prox(x, rho) -> x_hat, where
rho is the (traced) ADMM penalty, matching the reference's closure convention
(functions/constraints_to_prox.m:13-91).  Projections ignore rho; soft
regularizers use eta/rho internally exactly like the reference.

The external Proximity Operator Repository kernels the reference depends on
(project_box/simplex/monotone/L1/L2, prox_abs/zero/L2) are implemented here
natively as sort-based / scan-based batched ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp

from matlab_code_tpu.ops.isotonic import project_monotone, project_unimodal
from matlab_code_tpu.ops.tv import prox_tv

# ---------------------------------------------------------------------------
# set projections (rho-independent)
# ---------------------------------------------------------------------------


def project_box(x, lo, hi):
    """Clip to [lo, hi] (non-negativity = project_box(x, 0, inf);
    constraints_to_prox.m:14-18)."""
    return jnp.clip(x, lo, hi)


def project_simplex_cols(x, eta):
    """Euclidean projection of each COLUMN onto {v >= 0, sum(v) = eta}.

    Sort-based O(n log n) algorithm (Held/Wolfe/Crowder); equivalent of the
    Proximity Operator Repository's project_simplex(x, eta, 1)
    (constraints_to_prox.m:19-21)."""
    n = x.shape[0]
    u = jnp.sort(x, axis=0)[::-1, :]                      # descending per column
    css = jnp.cumsum(u, axis=0) - eta
    idx = jnp.arange(1, n + 1, dtype=x.dtype)[:, None]
    cond = u - css / idx > 0
    k = jnp.sum(cond, axis=0)                             # last valid index
    tau = jnp.take_along_axis(css, (k - 1)[None, :], axis=0)[0] / k.astype(x.dtype)
    return jnp.maximum(x - tau[None, :], 0.0)


def project_simplex_rows(x, eta):
    """Row-wise simplex projection (constraints_to_prox.m:22-24)."""
    return project_simplex_cols(x.T, eta).T


def project_l1ball_cols(x, eta):
    """Column-wise projection onto the l1 ball ||v||_1 <= eta
    (constraints_to_prox.m:32-34)."""
    a = jnp.abs(x)
    inside = jnp.sum(a, axis=0) <= eta
    proj = jnp.sign(x) * project_simplex_cols(a, eta)
    return jnp.where(inside[None, :], x, proj)


def project_l2ball_cols(x, eta):
    """Column-wise projection onto the l2 ball ||v||_2 <= eta
    (constraints_to_prox.m:35-37)."""
    nrm = jnp.linalg.norm(x, axis=0)
    scale = jnp.where(nrm > eta, eta / jnp.maximum(nrm, 1e-300), 1.0)
    return x * scale[None, :]


def prox_normalized_nonneg(x):
    """Projection onto the nonnegative unit sphere, column-wise; all-negative
    columns map to the indicator of their argmax (prox_normalized_nonneg.m:3-10).
    Non-convex."""
    y = jnp.maximum(x, 0.0)
    nrm = jnp.linalg.norm(y, axis=0)
    onehot = jax.nn.one_hot(jnp.argmax(x, axis=0), x.shape[0],
                            axis=0, dtype=x.dtype)
    normalized = y / jnp.where(nrm == 0, 1.0, nrm)[None, :]
    return jnp.where(nrm[None, :] == 0, onehot, normalized)


def project_orthonormal(x):
    """Polar projection U V^T onto matrices with orthonormal columns
    (project_ortho.m:3-4)."""
    U, _, Vt = jnp.linalg.svd(x, full_matrices=False)
    return U @ Vt


# ---------------------------------------------------------------------------
# soft regularizer proxes (rho-dependent)
# ---------------------------------------------------------------------------


def prox_l1(x, gamma):
    """Soft threshold: prox of gamma*||x||_1 (prox_abs;
    constraints_to_prox.m:46-49 uses gamma = eta/rho)."""
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - gamma, 0.0)


def prox_l0(x, gamma):
    """Hard threshold: prox of gamma*||x||_0 keeps |x| > sqrt(2 gamma)
    (prox_zero; constraints_to_prox.m:50-53).  Non-convex."""
    return jnp.where(jnp.abs(x) > jnp.sqrt(2.0 * gamma), x, 0.0)


def prox_l2_cols(x, gamma):
    """Column-wise group soft threshold: prox of gamma*sum_r ||x_col||_2
    (prox_L2; constraints_to_prox.m:54-57)."""
    nrm = jnp.linalg.norm(x, axis=0)
    scale = jnp.maximum(1.0 - gamma / jnp.maximum(nrm, 1e-300), 0.0)
    return x * scale[None, :]


def make_quadratic_prox(L: jnp.ndarray, eta: float):
    """prox of eta * tr(x^T L x): solves (2 eta/rho L + I) z = x
    (constraints_to_prox.m:62-67).  L is constant, so we pre-eigendecompose at
    trace time and apply the rho-dependent filter spectrally — one matmul pair
    per call, no per-call factorization."""
    lam, Q = jnp.linalg.eigh(L)

    def prox(x, rho):
        filt = 1.0 / (2.0 * eta / rho * lam + 1.0)
        return Q @ (filt[:, None] * (Q.T @ x))

    def reg(x):
        return eta * jnp.trace(x.T @ (L @ x))

    return prox, reg


def gl_smoothness_matrix(n: int, dtype=jnp.float64) -> jnp.ndarray:
    """Graph-Laplacian of a path graph: 2 on the diagonal (1 at the corners),
    -1 on the first off-diagonals (constraints_to_prox.m:70-74)."""
    L = (2.0 * jnp.eye(n, dtype=dtype)
         - jnp.eye(n, k=1, dtype=dtype) - jnp.eye(n, k=-1, dtype=dtype))
    L = L.at[0, 0].set(1.0).at[n - 1, n - 1].set(1.0)
    return L


def t_smoothness_prox(Bs: jnp.ndarray, rho: jnp.ndarray, eta: float) -> jnp.ndarray:
    """tPARAFAC2 temporal-smoothness joint prox over the K slice matrices.

    Solves the block-tridiagonal system with diagonal (4 eta + rho_k)
    (boundary-corrected to 2 eta + rho_k), off-diagonal -2 eta, and RHS
    rho_k * B_k, by the Thomas algorithm — exact re-derivation of
    functions/t_smoothness_prox.m:23-56, expressed as two lax.scans over k
    with matrix-valued carries.

    Bs: (K, J, R) stacked inputs (fac + dual), rho: (K,).
    """
    K = Bs.shape[0]
    dt = Bs.dtype
    eta = jnp.asarray(eta, dt)
    diag = 4.0 * eta + rho
    diag = diag.at[0].add(-2.0 * eta).at[K - 1].add(-2.0 * eta)
    off = -2.0 * eta
    rhs = rho[:, None, None] * Bs

    # forward elimination: d'_i = d_i - off^2 / d'_{i-1};  r'_i = r_i - (off/d'_{i-1}) r'_{i-1}
    def fwd(carry, inp):
        dprev, rprev = carry
        d_i, r_i = inp
        m = off / dprev
        d_new = d_i - m * off
        r_new = r_i - m * rprev
        return (d_new, r_new), (d_new, r_new)

    (_, _), (dmod, rmod) = jax.lax.scan(
        fwd, (diag[0], rhs[0]), (diag[1:], rhs[1:]))
    dmod = jnp.concatenate([diag[:1], dmod])
    rmod = jnp.concatenate([rhs[:1], rmod])

    # back substitution: x_K = r'_K / d'_K; x_i = (r'_i - off x_{i+1}) / d'_i
    xK = rmod[K - 1] / dmod[K - 1]

    def bwd(carry, inp):
        xnext = carry
        d_i, r_i = inp
        x_i = (r_i - off * xnext) / d_i
        return x_i, x_i

    _, xs = jax.lax.scan(bwd, xK, (dmod[:K - 1], rmod[:K - 1]), reverse=True)
    return jnp.concatenate([xs, xK[None]], axis=0)


def t_smoothness_penalty(Bs: jnp.ndarray, eta: float) -> jnp.ndarray:
    """eta * sum_k ||B_k - B_{k-1}||_F^2 (t_smoothness_penalty.m:5-9)."""
    d = Bs[1:] - Bs[:-1]
    return eta * jnp.sum(d * d)


# ---------------------------------------------------------------------------
# constraint spec -> (prox, reg) dispatch
# ---------------------------------------------------------------------------


KNOWN_CONSTRAINT_KINDS = frozenset({
    "non-negativity", "box", "simplex column-wise", "simplex row-wise",
    "non-decreasing", "non-increasing", "unimodality", "l1-ball", "l2-ball",
    "non-negative l2-ball", "non-negative l2-sphere", "orthonormal",
    "l1 regularization", "l0 regularization", "l2 regularization", "ridge",
    "quadratic regularization", "GL smoothness", "TV regularization",
    "tPARAFAC2", "custom",
})


@dataclass(frozen=True)
class ConstraintSpec:
    """Static description of one mode's constraint (the reference's
    Z.constraints{m} cell, 'List of constraints and regularizations.txt').

    kind: one of
      'non-negativity' | 'box' | 'simplex column-wise' | 'simplex row-wise' |
      'non-decreasing' | 'non-increasing' | 'unimodality' | 'l1-ball' |
      'l2-ball' | 'non-negative l2-ball' | 'non-negative l2-sphere' |
      'orthonormal' | 'l1 regularization' | 'l0 regularization' |
      'l2 regularization' | 'ridge' | 'quadratic regularization' |
      'GL smoothness' | 'TV regularization' | 'tPARAFAC2' | 'custom'
    params: tuple of numbers (eta, bounds, ...) — static.
    matrix: optional ndarray parameter (the L of 'quadratic regularization')
            — hashed by id, treated as a trace-time constant.
    fns: for 'custom', a tuple (prox_fn[, reg_fn]).
    """
    kind: str
    params: tuple = ()
    matrix: Any = None
    fns: tuple = ()

    def __post_init__(self):
        # eager typo guard: make_prox would also raise, but only at trace
        # time deep inside fit(); the reference errors on unknown
        # constraint strings up front (constraints_to_prox.m:89-91)
        if self.kind not in KNOWN_CONSTRAINT_KINDS:
            raise ValueError(
                f"Unknown constraint kind: {self.kind!r}; known kinds: "
                f"{sorted(KNOWN_CONSTRAINT_KINDS)}")
        # kind-specific requirements, also checked eagerly: make_prox would
        # only fail at trace time deep inside fit()
        if self.kind == "custom" and not self.fns:
            raise ValueError(
                "ConstraintSpec('custom') requires fns=(prox_fn[, reg_fn]) "
                "(constraints_to_prox.m:86-90 takes the handles in the cell)")
        if self.kind == "quadratic regularization" and self.matrix is None:
            raise ValueError(
                "ConstraintSpec('quadratic regularization') requires the "
                "matrix= L operand (constraints_to_prox.m:62-67)")

    def __hash__(self):
        return hash((self.kind, self.params, id(self.matrix), self.fns))

    def __eq__(self, other):
        return (isinstance(other, ConstraintSpec)
                and self.kind == other.kind and self.params == other.params
                and self.matrix is other.matrix and self.fns == other.fns)


def make_prox(spec: ConstraintSpec, mode_size: int, dtype=None
              ) -> tuple[Callable, Callable | None]:
    """Build (prox(x, rho), reg(x) or None) for a constraint spec.

    Trace-time equivalent of functions/constraints_to_prox.m:13-91.
    """
    k = spec.kind
    p = spec.params
    if k == "non-negativity":
        return (lambda x, rho: project_box(x, 0.0, jnp.inf)), None
    if k == "box":
        lo, hi = p
        return (lambda x, rho: project_box(x, lo, hi)), None
    if k == "simplex column-wise":
        eta, = p
        return (lambda x, rho: project_simplex_cols(x, eta)), None
    if k == "simplex row-wise":
        eta, = p
        return (lambda x, rho: project_simplex_rows(x, eta)), None
    if k == "non-decreasing":
        return (lambda x, rho: project_monotone(x, True)), None
    if k == "non-increasing":
        # reference: -project_monotone(-x, 1) (constraints_to_prox.m:27-28)
        return (lambda x, rho: project_monotone(x, False)), None
    if k == "unimodality":
        nn = bool(p[0])
        return (lambda x, rho: project_unimodal(x, nn)), None
    if k == "l1-ball":
        eta, = p
        return (lambda x, rho: project_l1ball_cols(x, eta)), None
    if k == "l2-ball":
        eta, = p
        return (lambda x, rho: project_l2ball_cols(x, eta)), None
    if k == "non-negative l2-ball":
        eta, = p
        return (lambda x, rho: project_l2ball_cols(
            project_box(x, 0.0, jnp.inf), eta)), None
    if k == "non-negative l2-sphere":
        return (lambda x, rho: prox_normalized_nonneg(x)), None
    if k == "orthonormal":
        return (lambda x, rho: project_orthonormal(x)), None
    if k == "l1 regularization":
        eta, = p
        return ((lambda x, rho: prox_l1(x, eta / rho)),
                lambda x: eta * jnp.sum(jnp.abs(x)))
    if k == "l0 regularization":
        eta, = p
        return ((lambda x, rho: prox_l0(x, eta / rho)),
                lambda x: eta * jnp.sum(x != 0).astype(x.dtype))
    if k == "l2 regularization":
        eta, = p
        return ((lambda x, rho: prox_l2_cols(x, eta / rho)),
                lambda x: eta * jnp.sum(jnp.linalg.norm(x, axis=0)))
    if k == "ridge":
        eta, = p
        return ((lambda x, rho: x / (2.0 * eta / rho + 1.0)),
                lambda x: eta * jnp.sum(x * x))
    if k == "quadratic regularization":
        eta, = p
        return make_quadratic_prox(jnp.asarray(spec.matrix), eta)
    if k == "GL smoothness":
        eta, = p
        L = gl_smoothness_matrix(mode_size, dtype or jnp.result_type(float))
        return make_quadratic_prox(L, eta)
    if k == "TV regularization":
        eta, = p
        # reference reg: eta*sum(sum(diff(x))) — NOT abs; replicated literally
        # (constraints_to_prox.m:81)
        return ((lambda x, rho: prox_tv(x, eta / rho)),
                lambda x: eta * jnp.sum(x[1:, :] - x[:-1, :]))
    if k == "tPARAFAC2":
        eta, = p
        return ((lambda Bs, rho: t_smoothness_prox(Bs, rho, eta)),
                lambda Bs: t_smoothness_penalty(Bs, eta))
    if k == "custom":
        prox_fn = spec.fns[0]
        reg_fn = spec.fns[1] if len(spec.fns) > 1 else None
        return prox_fn, reg_fn
    raise ValueError(f"Unknown constraint kind: {k!r}")
