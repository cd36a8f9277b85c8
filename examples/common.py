"""Shared runner for the example scripts (ports of the reference's
example_script1..15).  Each script builds the same problem configuration as
its MATLAB counterpart (sizes, couplings, constraints, options cited per
script) on synthetic data with matched statistics, runs cmtf_aoadmm, and
reports Fit% and FMS vs the ground-truth factors."""
from __future__ import annotations

import numpy as np

import jax

from matlab_code_tpu.utils.compile_cache import enable_compile_cache

if jax.default_backend() == "cpu":
    # the reference is float64 with 1e-7..1e-14 tolerances; match it on CPU
    # (GPU runs keep the f32 default)
    jax.config.update("jax_enable_x64", True)
else:
    enable_compile_cache()

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions, cmtf_aoadmm)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data
from matlab_code_tpu.utils.score import fms, fms_par2_B, fit_score
from matlab_code_tpu.ops.tensor import ktensor_full
from matlab_code_tpu.problem import CP, PAR2


def _setup(spec, lambdas, distr, noise, coupl_trafo, coupl_trafo2,
           init_distr, data_rng, bk_style, mode_post, normalize,
           miss_fraction=None, miss_rng=1, delta_override=None):
    """Shared data-generation + init prologue of run()/run_multistart()."""
    data, Atrue, Delta, _ = create_coupled_data(
        spec, lambdas=lambdas, noise=noise, distr=distr,
        coupl_trafo=coupl_trafo, coupl_trafo2=coupl_trafo2, rng=data_rng,
        bk_style=bk_style, mode_post=mode_post,
        delta_override=delta_override)
    if normalize:
        data, _ = normalize_data(spec, data)
    if miss_fraction:
        data = add_missing(spec, data, miss_fraction, miss_rng)
    init = InitOptions(distr=tuple(init_distr or distr), normalize=True,
                       lambdas_init=tuple(tuple(l) for l in lambdas))
    return data, Atrue, Delta, init


def run_reference_seeded(spec, lambdas, distr, opts, noise=0.0,
                         verbose=True, init_distr=None,
                         normalize_columns=False, post_uncoupled=None,
                         coupl_trafo=None, coupl_trafo2=None,
                         bk_style="shift", case1_max_override=True,
                         data_seed="default", init_seed=None,
                         pre_init=None, save_plots=None):
    """FULL reference-seeded replay of an example script: data and init
    are regenerated with the bit-exact MATLAB twister draw sequence
    (utils/matlab_rng.py) through create_coupled_data.m (or the
    specialized generator selected by bk_style/case1_max_override/
    post_uncoupled) + init_coupled_AOADMM_CMTF.m, data normalized per
    example_script1:86-103, init normalized per init_options.normalize=1.

    data_seed/init_seed: MATLAB rng() seeds — init_seed=None continues the
    single stream (most scripts); scripts 3 and 13 reseed before init
    (rng(13)/rng(1), example_script3:112, example_script13:119).
    pre_init(data, rng) -> data: draw-consuming hook between normalize and
    init — the insertion point of script 12's randperm missing masks
    (example_script12:115-147).
    Returns the run dict plus the randn rejection-path counts summed over
    both streams (0 = every normal draw took the anchor-verified fast
    path)."""
    from matlab_code_tpu.models.solver import cmtf_aoadmm
    from matlab_code_tpu.utils.matlab_rng import (
        MatlabRNG, matlab_create_coupled_data, matlab_init_coupled)

    rng = MatlabRNG(data_seed)
    data, Atrue, Delta, rng = matlab_create_coupled_data(
        spec, distr=distr, lambdas=lambdas, noise=noise, rng=rng,
        normalize_columns=normalize_columns, post_uncoupled=post_uncoupled,
        coupl_trafo=coupl_trafo, coupl_trafo2=coupl_trafo2,
        bk_style=bk_style, case1_max_override=case1_max_override)
    data, _ = normalize_data(spec, data)
    if pre_init is not None:
        data = pre_init(data, rng)
    irng = rng if init_seed is None else MatlabRNG(init_seed)
    delta_shapes = {cid: tuple(np.asarray(D).shape)
                    for cid, D in Delta.items()}
    state0 = matlab_init_coupled(spec, distr=init_distr or distr,
                                 normalize=True, rng=irng,
                                 coupl_trafo=coupl_trafo,
                                 delta_shapes=delta_shapes or None)
    zhat, state, _, out = cmtf_aoadmm(spec, data, opts, init=state0)
    report = summarize(spec, data, zhat, Atrue, out, verbose=verbose)
    if save_plots:
        from matlab_code_tpu.utils.plotting import plot_convergence
        plot_convergence(out, path=save_plots)
    edge = rng.slowpath_edge + (0 if irng is rng else irng.slowpath_edge)
    tail = rng.slowpath_tail + (0 if irng is rng else irng.slowpath_tail)
    return dict(zhat=zhat, state=state, out=out, data=data, Atrue=Atrue,
                Delta=Delta, report=report, slowpath_edge=edge,
                slowpath_tail=tail)


def run(spec, lambdas, distr, opts, noise=0.0, coupl_trafo=None,
        coupl_trafo2=None, init_distr=None, key=1, data_rng=0,
        bk_style="shift", mode_post=None, delta_shapes=None, normalize=True,
        verbose=True, miss_fraction=None, miss_rng=1, delta_override=None,
        save_plots=None):
    """save_plots: optional PNG path — renders the reference scripts'
    three-panel convergence figure (objective streams vs iterations and vs
    wall time + inner-iteration counts, example_script1:154-189) via
    utils/plotting.plot_convergence."""
    data, Atrue, Delta, init = _setup(
        spec, lambdas, distr, noise, coupl_trafo, coupl_trafo2, init_distr,
        data_rng, bk_style, mode_post, normalize, miss_fraction, miss_rng,
        delta_override)
    state0 = init_coupled(spec, data, init, key=key,
                          delta_shapes=delta_shapes)
    zhat, state, _, out = cmtf_aoadmm(spec, data, opts, init=state0)
    report = summarize(spec, data, zhat, Atrue, out, verbose=verbose)
    if save_plots:
        from matlab_code_tpu.utils.plotting import plot_convergence
        plot_convergence(out, path=save_plots)
    return dict(zhat=zhat, state=state, out=out, data=data, Atrue=Atrue,
                Delta=Delta, report=report)


def run_multistart(spec, lambdas, distr, opts, n_starts, noise=0.0,
                   coupl_trafo=None, coupl_trafo2=None, init_distr=None,
                   data_rng=0, bk_style="shift", mode_post=None,
                   delta_shapes=None, normalize=True, verbose=True,
                   keys=None, delta_override=None):
    """Best-of-N random starts via the vmapped fit_multistart (the
    reference's script-15 protocol, example_script15.m:113-135).  With
    keys=range(n_starts) each start reproduces the sequential
    `run(..., key=s)` fit exactly."""
    from matlab_code_tpu.models.multistart import fit_multistart
    from matlab_code_tpu.models.solver import assemble_zhat
    data, Atrue, Delta, init = _setup(
        spec, lambdas, distr, noise, coupl_trafo, coupl_trafo2, init_distr,
        data_rng, bk_style, mode_post, normalize,
        delta_override=delta_override)
    keys = list(keys) if keys is not None else list(range(n_starts))
    best_state, best_out, finals, stops = fit_multistart(
        spec, data, opts, init, n_starts, delta_shapes=delta_shapes,
        keys=keys)
    if verbose:
        for s in range(n_starts):
            print(f"start {s:2d}: f_tensors={float(finals[s]):.6e} "
                  f"iters={int(stops[s])}")
        print("--- best run ---")
    zhat = assemble_zhat(spec, best_state)
    report = summarize(spec, data, zhat, Atrue, best_out, verbose=verbose)
    return dict(zhat=zhat, state=best_state, out=best_out, data=data,
                Atrue=Atrue, Delta=Delta, report=report,
                finals=np.asarray(finals), stops=np.asarray(stops))


def add_missing(spec, data, fraction, rng=1):
    """Mark a random `fraction` of entries missing (script 12 style)."""
    import dataclasses
    import jax.numpy as jnp
    rng = np.random.default_rng(rng)
    objects = list(data.objects)
    miss = list(data.miss)
    for p, ds in enumerate(spec.datasets):
        if ds.model == CP:
            X = np.asarray(objects[p])
            mask = rng.uniform(size=X.shape) > fraction
            objects[p] = jnp.asarray(np.where(mask, X, 0.0))
            miss[p] = jnp.asarray(mask)
        else:
            X = objects[p]
            sl = np.asarray(X.slices)
            mask = rng.uniform(size=sl.shape) > fraction
            # padded columns are "observed" zeros
            mask = mask | ~np.asarray(X.mask)[:, None, :]
            objects[p] = type(X)(slices=jnp.asarray(np.where(mask, sl, 0.0)),
                                 mask=X.mask)
            miss[p] = jnp.asarray(mask)
    return dataclasses.replace(data, objects=tuple(objects), miss=tuple(miss))


def summarize(spec, data, zhat, Atrue, out, verbose=True):
    lines = [f"exit={out.exit_flag}  iters={out.OuterIterations}  "
             f"f_tensors={out.f_tensors:.3e}  f_coupl={out.f_couplings:.3e}  "
             f"f_constr={out.f_constraints:.3e}  "
             f"f_par2={out.f_PAR2_couplings:.3e}  "
             f"time={out.time_total:.2f}s"]
    stats = {}
    for p, ds in enumerate(spec.datasets):
        if ds.model == CP:
            Xhat = ktensor_full([np.asarray(f) for f in zhat[p]["factors"]])
            fit = fit_score(np.asarray(data.objects[p]), np.asarray(Xhat))
            score = (fms(zhat[p]["factors"], [Atrue[m] for m in ds.modes])
                     if Atrue[ds.modes[0]] is not None else float("nan"))
            stats[p] = (fit, score)
            lines.append(f"  dataset {p} (CP):   Fit={fit:.3f}%  FMS={score:.4f}")
        else:
            sizes = spec.par2_slice_sizes(p)
            num = den = 0.0
            for k, J in enumerate(sizes):
                Xk = np.asarray(data.objects[p].slices[k, :, :J])
                Mk = (zhat[p]["A"] @ np.diag(zhat[p]["C"][k])
                      @ zhat[p]["Bk"][k].T)
                num += np.sum((Xk - Mk) ** 2)
                den += np.sum(Xk ** 2)
            fit = 100.0 * (1.0 - num / den)
            mA, mB, mC = ds.modes
            sA = fms([zhat[p]["A"]], [Atrue[mA]])
            sB = fms_par2_B(zhat[p]["Bk"], Atrue[mB])
            sC = fms([zhat[p]["C"]], [Atrue[mC]])
            stats[p] = (fit, sA, sB, sC)
            lines.append(f"  dataset {p} (PAR2): Fit={fit:.3f}%  "
                         f"FMS_A={sA:.4f} FMS_B={sB:.4f} FMS_C={sC:.4f}")
    text = "\n".join(lines)
    if verbose:
        print(text)
    return stats
