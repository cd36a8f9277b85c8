"""Algorithm and initialization options (the reference's `options` and
`init_options` structs, example_script1:108-123 / 44-48).  Static, hashable —
one compiled program per options value."""
from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace


def with_matmul_precision(fn):
    """Decorator for solver entry points taking an AlgOptions argument:
    when options.matmul_precision != 'default', re-invoke fn under
    `jax.default_matmul_precision(<value>)` with the option stripped back
    to 'default' (so the recursion terminates).  jax folds the active
    precision config into the jit trace context, so each precision
    compiles (and caches) its own program even through shared jit
    wrappers.  One implementation for fit / fit_stepwise / fit_multistart
    — the AlgOptions argument is located by type, so the entry points'
    differing signatures need no per-copy argument forwarding."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        idx = next((i for i, a in enumerate(args)
                    if isinstance(a, AlgOptions)), None)
        opt = args[idx] if idx is not None else kw.get("options")
        if opt is None or opt.matmul_precision == "default":
            return fn(*args, **kw)
        inner = replace(opt, matmul_precision="default")
        if idx is not None:
            args = args[:idx] + (inner,) + args[idx + 1:]
        else:
            kw = {**kw, "options": inner}
        import jax
        with jax.default_matmul_precision(opt.matmul_precision):
            return fn(*args, **kw)
    return wrapper


@dataclass(frozen=True)
class LbfgsbOptions:
    """Mirrors the reference lbfgsb_options (example_script7:64-69)."""
    m: int = 5
    maxIts: int = 100
    maxTotalIts: int = 1000
    pgtol: float = 1e-4
    factr: float = 1e-6 / 2.220446049250313e-16  # 1e-6/eps, like the scripts


@dataclass(frozen=True)
class AlgOptions:
    Display: str = "no"                 # 'iter' | 'final' | 'no'
    DisplayIters: int = 10
    MaxOuterIters: int = 2000
    MaxInnerIters: int = 5
    AbsFuncTol: float = 1e-7
    OuterRelTol: float = 1e-8
    innerRelPrTol_coupl: float = 1e-5
    innerRelPrTol_constr: float = 1e-5
    innerRelDualTol_coupl: float = 1e-5
    innerRelDualTol_constr: float = 1e-5
    bsum: bool = False
    bsum_weight: float = 0.0
    eps_log: float = 1e-10
    iter_start_PAR2Bkconstraint: int = 0   # cmtf_fun_AOADMM.m:7-9
    increase_factor_rhoBk: float | None = None  # cmtf_fun_AOADMM.m:196-198
    lbfgsb: LbfgsbOptions = field(default_factory=LbfgsbOptions)
    # fit() records out.time_at_it (cmtf_fun_AOADMM.m:455) by splitting the
    # fused while_loop into chunks of this many outer iterations and
    # timestamping each chunk boundary on the host (iterations inside a chunk
    # are linearly interpolated).  Costs one dispatch and host sync per chunk;
    # 0 = single fused call per phase (time_at_it then has one mark per
    # phase).  fit_stepwise() always records exact per-iteration times.
    TimeAtItChunk: int = 25
    # Early ill-conditioning detection: a fit stops with exit flag
    # 'illconditioned lin system' when the rcond estimate of any assembled
    # normal matrix (from its Cholesky diagonal) drops below this tolerance —
    # the analogue of the reference's promotion of MATLAB's
    # nearlySingularMatrix warning (cmtf_fun_AOADMM.m:83-84), which fires at
    # rcond < eps.  Set 0.0 to disable (then only the non-finite guard stops).
    IllCondTol: float = 2.220446049250313e-16
    # EXTENSION (off by default, not in the reference): residual-balancing
    # adaptive rho for non-Frobenius (KL/IS/beta) modes.  The reference's rho
    # heuristic (sum of squared column norms, cmtf_fun_AOADMM.m:129) is
    # independent of the data scale and the ADMM consensus can diverge for
    # large count scales; when enabled, each non-Frobenius mode's rho is
    # multiplied by a per-mode factor doubled/halved when the ADMM primal
    # residual exceeds 10x the dual residual or vice versa (Boyd et al. 2011,
    # sec. 3.4.1), clamped to [1e-6, 1e6].
    adaptive_rho_nonfrob: bool = False
    # Under fit(mesh=...): route dense CP MTTKRPs whose psum target divides
    # the mesh through the ring-pipelined collective-permute path
    # (parallel/shard_mttkrp.make_sharded_mttkrp_pipelined) so the
    # factor-exchange transfer overlaps the next chunk's contraction.
    # Results match the bulk-psum layout to float rounding (different
    # reduction association order).
    mesh_pipelined_collectives: bool = False
    # PARAFAC2 P_k update (polar factor, cmtf_fun_AOADMM.m:532-534) method:
    # 'svd' = batched econ-SVD (LAPACK-grade, the reference's math); 'ns' =
    # cubic Newton-Schulz (ops/linalg.polar_orth_ns, matmuls only); 'auto'
    # = svd on the CPU, ns on a GPU (AUTO_CHOICES, resolve_auto).  Same
    # mathematical result to ~sqrt(eps)*cond.
    par2_polar: str = "auto"
    # Inner-ADMM factor solve: 'chol' = two triangular substitutions per
    # inner iteration against the cached Cholesky factor (the reference's
    # (A/L')/L, cmtf_fun_AOADMM.m:608-609); 'inverse' = invert the normal
    # matrix ONCE per outer iteration (from the same Cholesky factor, so
    # the rcond ill-conditioning check is unchanged) and run each inner
    # iteration as one matmul; 'newton' = invert by Newton-Hotelling
    # iteration (ops/linalg.spd_inverse_newton) — no Cholesky at all;
    # ill-conditioning is screened by the inf-norm rcond estimate instead
    # of the Cholesky diagonal.  All three give the same solution to
    # ~eps*cond.  'auto' = chol on the CPU, inverse on a GPU (AUTO_CHOICES,
    # resolve_auto).
    inner_solve: str = "auto"
    # Matmul/einsum precision for the WHOLE solver program (fit /
    # fit_stepwise / fit_multistart trace under
    # jax.default_matmul_precision(<value>) when != 'default').  On a GPU,
    # 'default' lets float32 matmuls run in TF32 (a 10-bit mantissa), which
    # can hold the objective above a tight AbsFuncTol; 'highest' keeps full
    # float32.  CPU runs are unaffected ('default' is already full
    # precision there).  Choices: 'default' (backend default), 'bfloat16',
    # 'tensorfloat32', 'float32', 'highest'.
    matmul_precision: str = "default"

    def __post_init__(self):
        if self.par2_polar not in ("auto", "svd", "ns"):
            raise ValueError(f"par2_polar must be 'auto'|'svd'|'ns', "
                             f"got {self.par2_polar!r}")
        if self.inner_solve not in ("auto", "chol", "inverse", "newton"):
            raise ValueError(f"inner_solve must be 'auto'|'chol'|'inverse'"
                             f"|'newton', got {self.inner_solve!r}")
        if self.Display not in ("iter", "final", "no"):
            raise ValueError(f"Display must be 'iter'|'final'|'no', "
                             f"got {self.Display!r}")
        if self.matmul_precision not in ("default", "bfloat16",
                                         "tensorfloat32", "float32",
                                         "highest"):
            raise ValueError(
                f"matmul_precision must be 'default'|'bfloat16'|"
                f"'tensorfloat32'|'float32'|'highest', "
                f"got {self.matmul_precision!r}")
    # NS iteration count: sigma_min grows ~1.5x/iter after Frobenius
    # normalization, so ~log1.5(sqrt(R)*cond)+4 iterations; 40 covers
    # cond ~ 3e6 at R=32.  Raise for extreme conditioning (or use 'svd').
    par2_polar_iters: int = 40
    # share the X x_0 A partial between the mode-1/2 MTTKRPs of 3-way CP
    # sweeps (exact numerics; trades one data pass for an (J,K,R)
    # intermediate).  Off by default; the PARAFAC2 W-reuse is free and
    # always on.
    cp_dimension_tree: bool = False
    # Pairwise-perturbation MTTKRP acceleration (Ma & Solomonik,
    # arXiv:2010.12056) for 3-way Frobenius CP datasets without missing
    # masks: once sweep-over-sweep factor steps fall below pp_start_tol,
    # MTTKRPs are evaluated to first order from cached pairwise partials
    # (T_nm = X contracted with one reference factor) — dense einsums
    # instead of data passes — and the partials are rebuilt whenever the
    # accumulated perturbation exceeds pp_refresh_tol.  APPROXIMATE
    # (error O(perturbation^2) per MTTKRP, shrinking as the fit converges);
    # opt-in, off by default; biggest win for sparse COO datasets where a
    # data pass is a gather over every nonzero.  The objective stream
    # carries O(pp_refresh_tol^2)-relative noise during PP-active
    # iterations (the cached-MTTKRP objective reads the approximate
    # MTTKRP); fit() recomputes the FINAL objective exactly.
    cp_pairwise_perturbation: bool = False
    pp_start_tol: float = 0.02
    pp_refresh_tol: float = 0.05


# The concrete value of every 'auto' option, per JAX backend.  CPU keeps
# the reference's math (Cholesky substitutions, SVD polar factor), which the
# bit-exact parity tests pin.  The GPU entries were chosen by timing every
# choice on an H100 in the flagship and PARAFAC2 programs (PERF.md): the
# batched econ-SVD of (512, 256, 32) slices made a PARAFAC2 iteration ~200x
# slower than Newton-Schulz, and 'inverse' beat 'chol' and 'newton' per
# iteration and to tolerance in both.
AUTO_CHOICES = {
    "cpu": {"inner_solve": "chol", "par2_polar": "svd"},
    "gpu": {"inner_solve": "inverse", "par2_polar": "ns"},
}


def resolve_auto(options: AlgOptions, backend: str | None = None
                 ) -> AlgOptions:
    """Return `options` with every 'auto' field replaced by the concrete
    choice for `backend` (default: jax.default_backend()).  Raises
    ValueError for a backend with no entry in AUTO_CHOICES."""
    if backend is None:
        import jax
        backend = jax.default_backend()
    if backend not in AUTO_CHOICES:
        raise ValueError(f"no 'auto' choices for backend {backend!r}; "
                         f"known: {sorted(AUTO_CHOICES)}")
    auto = {k: v for k, v in AUTO_CHOICES[backend].items()
            if getattr(options, k) == "auto"}
    return replace(options, **auto) if auto else options


@dataclass(frozen=True)
class InitOptions:
    """Initialization config (init_coupled_AOADMM_CMTF.m:16-20).

    distr[m] names the sampling distribution of mode m's initial factor /
    auxiliary draws: 'rand' (U[0,1]), 'randn' (N(0,1)), 'rand+0.1'
    (U[0,1]+0.1), matching the function handles used across the example
    scripts.  A callable (key, shape) -> array is also accepted.
    """
    distr: tuple = ()                  # per mode
    normalize: bool = True
    nvecs: bool = False
    lambdas_init: tuple = ()           # per dataset; lengths define ranks
