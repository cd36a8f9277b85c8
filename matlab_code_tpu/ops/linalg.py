"""Small dense linear algebra used by the ADMM updates.

All systems here are R x R (R = rank, tiny) or (K*R) x (K*R); they are
replicated across devices and solved with batched (vmap-able) kernels.

Reference call sites: chol + triangular solves (cmtf_fun_AOADMM.m:142,608-609),
sylvester (cmtf_fun_AOADMM.m:728), polar via econ-SVD (cmtf_fun_AOADMM.m:532-534),
eigs for init (init_coupled_AOADMM_CMTF.m:60-66).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def chol_lower(B: jnp.ndarray) -> jnp.ndarray:
    """Lower-triangular Cholesky factor of symmetric positive-definite B.

    Matches L{m} = chol(B','lower') for symmetric B (cmtf_fun_AOADMM.m:142).
    Batched over leading dims.
    """
    return jnp.linalg.cholesky(B)


def solve_with_chol(L: jnp.ndarray, A: jnp.ndarray) -> jnp.ndarray:
    """Solve X B = A for X, given B = L L^T (symmetric PD).

    Replicates the reference's `(A/L')/L` forward/backward substitution
    (cmtf_fun_AOADMM.m:609).  A: (I, R), L: (R, R) lower.  Batched over
    leading dims of both (matching leading dims).
    """
    # X = A B^{-1} = (B^{-1} A^T)^T since B is symmetric.
    y = jax.scipy.linalg.solve_triangular(L, jnp.swapaxes(A, -1, -2), lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False)
    return jnp.swapaxes(x, -1, -2)


def spd_inverse_from_chol(L: jnp.ndarray) -> jnp.ndarray:
    """B^{-1} = L^{-T} L^{-1} from the lower Cholesky factor of B.

    Used by the 'inverse' inner-solve mode: computed once per outer
    iteration so every inner-ADMM solve becomes a single matmul instead of
    two triangular substitutions.  Batched over leading dims.
    """
    R = L.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(R, dtype=L.dtype), L.shape)
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return jnp.matmul(jnp.swapaxes(Linv, -1, -2), Linv,
                      precision=jax.lax.Precision.HIGHEST)


def spd_inverse_newton(B: jnp.ndarray, lmin=None, max_iters: int = 24,
                       polish: int = 2):
    """Batched SPD inverse by Newton-Hotelling iteration — matmuls only.

    The 'newton' inner-solve mode: replaces chol + triangular inversion on
    (K-batched) small systems by a chain of batched matmuls.
    X_{t+1} = X_t (2I - B X_t) doubles correct digits per step;
    X_0 = 2/(lmin + ||B||_inf) I converges for any SPD B.  The main loop
    runs at the ambient matmul precision (TF32 on a GPU under 'default';
    adaptive: stops once the residual falls below a loose tolerance) and
    `polish` final steps run at Precision.HIGHEST to reach f32 quality —
    Newton is self-correcting, so the cheap iterations cost no accuracy.

    lmin: optional lower bound on eigenvalues (the ADMM normal matrices
    carry an explicit + rho/2 I, cmtf_fun_AOADMM.m:200,209-211, so rho/2 is
    a free bound); scalar or (K,).  Returns (B^{-1}, rcond_estimate) where
    rcond_estimate = 1/(||B||_inf ||B^{-1}||_inf) >= 1/cond_inf(B), the
    analogue of the Cholesky rcond screen for the nearlySingularMatrix
    promotion (cmtf_fun_AOADMM.m:83-84).
    """
    R = B.shape[-1]
    dt = B.dtype
    eye = jnp.eye(R, dtype=dt)
    ninf = jnp.max(jnp.sum(jnp.abs(B), axis=-1), axis=-1)
    denom = ninf if lmin is None else ninf + jnp.asarray(lmin, dt)
    c = (2.0 if lmin is not None else 1.0) / denom
    X0 = c[..., None, None] * jnp.broadcast_to(eye, B.shape)
    # reduced-precision tolerance: stop the cheap loop once below it (or on
    # stall); the HIGHEST-precision polish squares the remaining error.
    tol = 1e-2 if dt == jnp.float32 else 1e-6

    def body(carry):
        X, _, it = carry
        E = B @ X
        res = jnp.max(jnp.abs(E - eye))
        X = X @ (2.0 * eye - E)
        return X, res, it + 1

    def cond(carry):
        _, res, it = carry
        return (it < max_iters) & (res > tol)

    X, _, _ = jax.lax.while_loop(
        cond, body, (X0, jnp.asarray(jnp.inf, dt), jnp.int32(0)))
    hi = jax.lax.Precision.HIGHEST
    for _ in range(polish):
        E = jnp.matmul(B, X, precision=hi)
        X = jnp.matmul(X, 2.0 * eye - E, precision=hi)
    xinf = jnp.max(jnp.sum(jnp.abs(X), axis=-1), axis=-1)
    rcond = 1.0 / (ninf * xinf)
    return X, rcond


def solve_spd_left(L: jnp.ndarray, A: jnp.ndarray) -> jnp.ndarray:
    """Solve B X = A given B = L L^T.  A: (n, k)."""
    y = jax.scipy.linalg.solve_triangular(L, A, lower=True)
    return jax.scipy.linalg.solve_triangular(jnp.swapaxes(L, -1, -2), y, lower=False)


def rsolve(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """MATLAB A/B (solve X B = A) for general square B."""
    return jnp.linalg.solve(jnp.swapaxes(B, -1, -2), jnp.swapaxes(A, -1, -2)).swapaxes(-1, -2)


def polar_orth(M: jnp.ndarray) -> jnp.ndarray:
    """Orthonormal polar factor U V^T of M via thin SVD.

    Equivalent of [U,~,V]=svd(M,'econ'); U*V' (cmtf_fun_AOADMM.m:532-534,
    project_ortho.m:3-4).  Zero rows of M map to zero rows of the output
    when M has full column rank, which keeps ragged-slice padding intact.
    Batched over leading dims (vmap/jnp.linalg.svd both batch).
    """
    U, _, Vt = jnp.linalg.svd(M, full_matrices=False)
    return U @ Vt


def polar_orth_ns(M: jnp.ndarray, iters: int = 30,
                  polish: int = 2) -> jnp.ndarray:
    """Orthonormal polar factor of M via cubic Newton-Schulz iteration —
    matmuls only, no SVD.

    Same mathematical result as `polar_orth` (cmtf_fun_AOADMM.m:532-534),
    computed with batched matmuls instead of a batched econ-SVD of the
    (K, J, R) slices.  X0 = M/||M||_F has singular values in (0, 1] ⊂ (0, √3), so
    X ← 1.5·X − 0.5·X(XᵀX) converges cubically to the polar factor
    (Higham, Functions of Matrices, §8.3).

    The main loop is ADAPTIVE (while_loop on max_k ||XᵀX − I||, bound
    `iters`): well-conditioned slices exit in ~10 iterations instead of the
    conservative fixed bound.  Under reduced matmul precision (TF32 or
    bf16) the loop stalls near ~1e-3; `polish` final iterations at
    Precision.HIGHEST then contract the orthogonality defect to f32 quality
    (the iteration is self-correcting).  Use `polar_orth` when LAPACK-grade
    accuracy is required (CPU/f64 parity paths keep the SVD).  Zero
    matrices map to zero.  Batched over leading dims.
    """
    nrm = jnp.sqrt(jnp.sum(M * M, axis=(-2, -1), keepdims=True))
    X = M / jnp.where(nrm > 0, nrm, 1.0)
    dt = M.dtype
    eye = jnp.eye(M.shape[-1], dtype=dt)
    tol = 1e-2 if dt == jnp.float32 else 1e-6
    nonzero = nrm[..., 0, 0] > 0    # all-zero slices stay zero; mask their
                                    # (constant) defect out of the exit test

    def body(carry):
        X, _, it = carry
        G = jnp.swapaxes(X, -1, -2) @ X
        res = jnp.max(jnp.abs(G - eye), axis=(-2, -1))
        res = jnp.max(jnp.where(nonzero, res, 0.0))
        X = 1.5 * X - 0.5 * X @ G
        return X, res, it + 1

    def cond(carry):
        _, res, it = carry
        return (it < iters) & (res > tol)

    X, _, _ = jax.lax.while_loop(
        cond, body, (X, jnp.asarray(jnp.inf, dt), jnp.int32(0)))
    hi = jax.lax.Precision.HIGHEST
    for _ in range(polish):
        G = jnp.matmul(jnp.swapaxes(X, -1, -2), X, precision=hi)
        X = 1.5 * X - 0.5 * jnp.matmul(X, G, precision=hi)
    return X


def sylvester_sym(B2: jnp.ndarray, B: jnp.ndarray, C: jnp.ndarray) -> jnp.ndarray:
    """Solve B2 X + X B = C where B2 (n x n) and B (R x R) are SYMMETRIC.

    Equivalent of MATLAB sylvester(B2, B, C) at cmtf_fun_AOADMM.m:728 (there
    B2 = rho/2 H^T H [+ rho/2 I] and B = w*Gram [+ ...] are both symmetric).
    Solved spectrally: B2 = U1 S1 U1^T, B = U2 S2 U2^T =>
    X = U1 [ (U1^T C U2) / (s1_i + s2_j) ] U2^T.
    """
    s1, U1 = jnp.linalg.eigh(B2)
    s2, U2 = jnp.linalg.eigh(B)
    Ct = U1.T @ C @ U2
    denom = s1[:, None] + s2[None, :]
    return U1 @ (Ct / denom) @ U2.T


def top_eigvecs(Y: jnp.ndarray, r: int) -> jnp.ndarray:
    """Leading-r eigenvectors (by eigenvalue) of symmetric PSD Y.

    Equivalent of eigs(Y, r, 'LM') on a PSD Gram (init_coupled_AOADMM_CMTF.m:60,
    cmtf_nvecs.m usage).  Deterministic sign convention: largest-|.| entry of
    each vector is made positive.
    """
    w, V = jnp.linalg.eigh(Y)           # ascending
    V = V[:, ::-1][:, :r]
    idx = jnp.argmax(jnp.abs(V), axis=0)
    signs = jnp.sign(V[idx, jnp.arange(r)])
    signs = jnp.where(signs == 0, 1.0, signs)
    return V * signs[None, :]


def block_diag(mats: jnp.ndarray) -> jnp.ndarray:
    """Block-diagonal matrix from a stacked batch (K, R, R) -> (K*R, K*R).

    Equivalent of blkdiag(B{m}{:}) at cmtf_fun_AOADMM.m:286.
    """
    K, R, _ = mats.shape
    eye_k = jnp.eye(K, dtype=mats.dtype)
    # out[kR+i, lR+j] = delta_{kl} mats[k,i,j]
    return (eye_k[:, None, :, None] * mats[:, :, None, :]).reshape(K * R, K * R)
