"""Explicit SPMD MTTKRP via shard_map: partial per-shard MTTKRPs reduced
with psum over the mesh axis.

This is the hand-written collective layout of SURVEY.md §2.3 ("shard each
tensor along its longest mode ... partial MTTKRPs reduced" over the
interconnect); the
pjit path in parallel/sharding.py lets XLA derive the same program from
sharding annotations — this module pins it explicitly, which also makes the
communication cost auditable: one psum of an (I_m, R) matrix per mode update.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from matlab_code_tpu.ops.tensor import mttkrp, mttkrp_sparse


def make_sharded_mttkrp(mesh: Mesh, axis: str, ndim: int, shard_dim: int,
                        target_mode: int):
    """Build an SPMD mttkrp(X_sharded, factors) for a dense ndim-way tensor
    sharded along `shard_dim`, producing the (replicated) mode-`target_mode`
    MTTKRP.

    If target_mode == shard_dim the partial results are disjoint row blocks
    (all_gather); otherwise each shard holds a partial sum (psum).
    """
    xspec = [None] * ndim
    xspec[shard_dim] = axis
    in_specs = (P(*xspec),
                tuple(P(axis, None) if i == shard_dim else P(None, None)
                      for i in range(ndim)))
    out_spec = P(None, None)

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_spec,
             check_vma=False)
    def f(x_shard, factors):
        local = mttkrp(x_shard, list(factors), target_mode)
        if target_mode == shard_dim:
            return jax.lax.all_gather(local, axis, axis=0, tiled=True)
        return jax.lax.psum(local, axis)

    return f


def make_sharded_mttkrp_pipelined(mesh: Mesh, axis: str, ndim: int,
                                  shard_dim: int, target_mode: int,
                                  n_devices: int):
    """Ring-pipelined SPMD MTTKRP: the factor-exchange collective is
    OVERLAPPED with the next chunk's compute (BASELINE.json north star;
    SURVEY.md:153).

    Instead of one bulk psum of the full (I_m, R) partial after all local
    compute (make_sharded_mttkrp), the target mode's rows are split into
    n_devices chunks and the reduction runs as a ring: at step t device d
    contracts its X shard against row-chunk c = (d-1-t) mod n and adds it
    to the accumulator that just arrived for that chunk, then
    collective-permutes the accumulator to d+1.  The ppermute of step t
    and the dynamic-slice+contraction of step t+1 carry no data
    dependence, so XLA's async scheduler hides the transfer behind the
    einsum (collective-permute start/done pairs in the compiled HLO —
    asserted by bench_scaling.py's census).  After n steps device d holds
    the fully reduced chunk d; a tiled all_gather re-replicates.

    Communication volume equals the plain path's reduce phase (each
    accumulator chunk of I_m/n rows crosses n-1 links) but is spread
    across the sweep instead of serialized at the end.  Wins when the
    per-chunk contraction time >= the chunk transfer time, i.e.
    compute-heavy shards.  Requires
    I_m % n_devices == 0 and target_mode != shard_dim
    (build_sharded_mttkrps falls back to the bulk-psum path otherwise).
    The ring accumulates in a different association order than psum, so
    results match the plain path to float rounding, not bitwise.
    """
    n = n_devices
    xspec = [None] * ndim
    xspec[shard_dim] = axis
    in_specs = (P(*xspec),
                tuple(P(axis, None) if i == shard_dim else P(None, None)
                      for i in range(ndim)))
    perm = [(i, (i + 1) % n) for i in range(n)]

    @partial(shard_map, mesh=mesh, in_specs=in_specs,
             out_specs=P(None, None), check_vma=False)
    def f(x_shard, factors):
        d = jax.lax.axis_index(axis)
        Im = factors[target_mode].shape[0]
        chunk = Im // n
        acc = None
        for t in range(n):                     # unrolled ring
            c = (d + (n - 1 - t)) % n          # chunk visiting device d now
            xs = jax.lax.dynamic_slice_in_dim(x_shard, c * chunk, chunk,
                                              axis=target_mode)
            p = mttkrp(xs, list(factors), target_mode)
            acc = p if acc is None else acc + p
            if t < n - 1:
                acc = jax.lax.ppermute(acc, axis, perm)
        return jax.lax.all_gather(acc, axis, axis=0, tiled=True)

    return f


def make_sharded_mttkrp_sparse(mesh: Mesh, axis: str, target_mode: int,
                               out_dim: int):
    """SPMD MTTKRP for a COO SparseTensor partitioned along the NONZERO axis
    (each device holds nnz/n entries; factor matrices replicated).

    Every shard computes a full-size (D_mode, R) partial via local
    gather + segment-sum (ops/tensor.mttkrp_sparse — the sptensor mttkrp of
    cmtf_fun_AOADMM.m:97) and the partials are psum-reduced over the mesh: the
    sparse analogue of the dense mode-partitioned layout (SURVEY.md §2.3).
    nnz padding (zero values at index 0) contributes exactly zero.
    """
    def make(nfac):
        specs = (P(axis, None), P(axis)) + tuple(
            P(None, None) for _ in range(nfac))

        @partial(shard_map, mesh=mesh, in_specs=specs,
                 out_specs=P(None, None), check_vma=False)
        def g(idx_shard, val_shard, *factors):
            local = mttkrp_sparse(idx_shard, val_shard, list(factors),
                                  target_mode, out_dim)
            return jax.lax.psum(local, axis)

        return g

    cache = {}

    def fn(X, factors):
        n = len(factors)
        if n not in cache:
            cache[n] = make(n)
        return cache[n](X.indices, X.values, *factors)

    return fn


def pad_sparse_nnz(X, n: int):
    """Pad a SparseTensor's nnz axis to a multiple of n with zero-valued
    entries at index 0 (exactly neutral for MTTKRP and the objective)."""
    from matlab_code_tpu.problem import SparseTensor
    nnz = X.indices.shape[0]
    pad = (-nnz) % n
    if pad == 0:
        return X
    idx = jnp.concatenate(
        [X.indices, jnp.zeros((pad, X.indices.shape[1]), X.indices.dtype)])
    val = jnp.concatenate([X.values, jnp.zeros((pad,), X.values.dtype)])
    return SparseTensor(idx, val)


def build_sharded_mttkrps(spec, data, mesh, axis=None, pipelined=False):
    """Explicit-collective MTTKRP implementations for every >=3-way CP
    dataset whose longest mesh-divisible mode can be sharded.

    Returns {(p, target_local_mode): fn(X, factors) -> mttkrp} for use by
    make_outer_step(..., mttkrp_impls=...) — the row-sharded option of
    SURVEY.md §2.3 with its collectives (one psum or tiled all_gather of an
    (I_m, R) matrix per mode update) pinned by hand instead of derived by
    XLA from sharding annotations.

    pipelined=True swaps every dense psum-reducing target (target !=
    shard mode, target size divisible by the mesh) for the ring
    collective-permute variant whose transfers overlap the next chunk's
    contraction (make_sharded_mttkrp_pipelined); other targets keep the
    bulk path.
    """
    from matlab_code_tpu.problem import CP, SparseTensor
    from matlab_code_tpu.parallel.sharding import (
        choose_cp_shard_mode, DATA_AXIS)
    axis = axis or DATA_AXIS
    n = mesh.devices.size
    impls = {}
    for p, ds in enumerate(spec.datasets):
        if ds.model != CP:
            continue
        X = data.objects[p]
        if isinstance(X, SparseTensor):
            # nnz-partitioned COO: one psum of the (D_mode, R) partial per
            # mode update; requires nnz % n == 0 (pad_sparse_nnz)
            if X.indices.shape[0] % n != 0:
                continue
            for target in range(X.ndim):
                impls[(p, target)] = make_sharded_mttkrp_sparse(
                    mesh, axis, target,
                    spec.mode_sizes[ds.modes[target]])
            continue
        if getattr(X, "ndim", 0) < 3:
            continue
        local = choose_cp_shard_mode(spec, p, n)
        if local is None:
            continue
        for target in range(X.ndim):
            if (pipelined and target != local
                    and spec.mode_sizes[ds.modes[target]] % n == 0):
                impls[(p, target)] = make_sharded_mttkrp_pipelined(
                    mesh, axis, X.ndim, local, target, n)
            else:
                impls[(p, target)] = make_sharded_mttkrp(
                    mesh, axis, X.ndim, local, target)
    return impls
