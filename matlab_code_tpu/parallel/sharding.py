"""Multi-device sharding layouts for coupled factorizations.

The reference is serial MATLAB (SURVEY.md §2.3); this module is the
first-class sharding design this framework adds:

  * CP/matrix datasets: the data tensor is sharded along its LONGEST mode
    over the mesh's data axis; ALL factor matrices stay replicated (they are
    I x R with small R, and replication keeps every mode's ALS/ADMM solve
    local).  XLA partitions the MTTKRP einsum into per-shard partial MTTKRPs
    and inserts the psum over the interconnect automatically — the partial-MTTKRP +
    all-reduce layout of the scaling plan.  (Row-sharding the long mode's
    factor is a possible refinement; parallel/shard_mttkrp.py shows the
    explicit collective structure it would pin.)
  * PARAFAC2 datasets: everything carrying a leading K (slice) axis —
    data slices, Bk factor, P, mu_DeltaB, C — is sharded over K; the
    per-slice batched Cholesky/SVD sweep becomes embarrassingly parallel
    and the DeltaB / A-mode reductions over K become psums.
  * R x R quantities (Grams, DeltaB, normal matrices) are replicated.

Used by jitting the solver step with these shardings as in_shardings; the
stopping logic and scalar streams live on the host side unchanged.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from matlab_code_tpu.problem import ProblemSpec, ProblemData, CP, PAR2
from matlab_code_tpu.state import SolverState

DATA_AXIS = "d"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def _rep(mesh):
    return NamedSharding(mesh, P())


def _shard_axis(mesh, ndim, axis):
    spec = [None] * ndim
    spec[axis] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))


def choose_cp_shard_mode(spec: ProblemSpec, p: int, n_devices: int) -> int | None:
    """Local index of the longest mode divisible by the mesh size, or None."""
    ds = spec.datasets[p]
    sizes = [spec.mode_sizes[m] for m in ds.modes]
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    for i in order:
        if sizes[i] % n_devices == 0:
            return i
    return None


def data_shardings(spec: ProblemSpec, data: ProblemData, mesh: Mesh):
    """Sharding pytree matching ProblemData."""
    n = mesh.devices.size
    objects = []
    sharded_modes = {}  # global mode id -> sharded (for state layout)
    from matlab_code_tpu.problem import SparseTensor
    for p, ds in enumerate(spec.datasets):
        if ds.model == CP and isinstance(data.objects[p], SparseTensor):
            X = data.objects[p]
            if X.indices.shape[0] % n == 0:
                # nnz-partitioned COO stream; factors stay replicated, so no
                # mode becomes row-sharded.
                objects.append(SparseTensor(
                    indices=_shard_axis(mesh, 2, 0),
                    values=NamedSharding(mesh, P(DATA_AXIS))))
            else:
                objects.append(SparseTensor(
                    indices=_rep(mesh), values=_rep(mesh)))
        elif ds.model == CP:
            local = choose_cp_shard_mode(spec, p, n)
            if local is None:
                objects.append(_rep(mesh))
            else:
                X = data.objects[p]
                objects.append(_shard_axis(mesh, X.ndim, local))
                sharded_modes[ds.modes[local]] = True
        else:
            X = data.objects[p]
            K = X.slices.shape[0]
            if K % n == 0:
                objects.append(type(X)(
                    slices=_shard_axis(mesh, 3, 0),
                    mask=_shard_axis(mesh, 2, 0)))
                sharded_modes[ds.modes[1]] = True
                sharded_modes[ds.modes[2]] = True
            else:
                objects.append(type(X)(slices=_rep(mesh), mask=_rep(mesh)))
    miss = tuple(None if m is None else o_sh_like(mesh, data.miss[p], objects[p])
                 for p, m in enumerate(data.miss))
    trafo = tuple(None if H is None else _rep(mesh) for H in data.coupl_trafo)
    trafo2 = tuple(None if H is None else _rep(mesh) for H in data.coupl_trafo2)
    import dataclasses
    return dataclasses.replace(data, objects=tuple(objects), miss=miss,
                               coupl_trafo=trafo,
                               coupl_trafo2=trafo2), sharded_modes


def o_sh_like(mesh, mask, obj_sh):
    """Missing-mask sharding mirrors the object sharding."""
    if isinstance(obj_sh, NamedSharding):
        return obj_sh
    # Parafac2: mask is (K, I, Jmax); reuse the slices sharding axis-0 or rep
    sl = obj_sh.slices
    if isinstance(sl, NamedSharding) and sl.spec and sl.spec[0] == DATA_AXIS:
        return _shard_axis(mesh, 3, 0)
    return _rep(mesh)


def state_shardings(spec: ProblemSpec, state: SolverState, mesh: Mesh,
                    sharded_modes: dict):
    """Sharding pytree matching SolverState: PAR2 K-carrying leaves sharded,
    row-sharding for factors of sharded CP modes, everything else replicated."""
    def leaf_for(m, x):
        if x is None:
            return None
        role = spec.mode_role(m)
        if role in ("par2_B",) and m in sharded_modes:
            return _shard_axis(mesh, x.ndim, 0)
        if role == "par2_C" and m in sharded_modes:
            return _shard_axis(mesh, x.ndim, 0)
        return _rep(mesh)

    fac = tuple(leaf_for(m, state.fac[m]) for m in range(spec.nb_modes))
    cfac = tuple(leaf_for(m, state.constraint_fac[m])
                 for m in range(spec.nb_modes))
    cdual = tuple(leaf_for(m, state.constraint_dual_fac[m])
                  for m in range(spec.nb_modes))
    # coupling state: replicated (consensus quantities)
    cpl = tuple(None if x is None else _rep(mesh) for x in state.coupling_fac)
    cpld = tuple(None if x is None else _rep(mesh)
                 for x in state.coupling_dual_fac)
    Psh = []
    mus = []
    dbs = []
    for p, ds in enumerate(spec.datasets):
        if state.P[p] is None:
            Psh.append(None)
            mus.append(None)
            dbs.append(None)
        else:
            sh = (_shard_axis(mesh, 3, 0)
                  if ds.modes[1] in sharded_modes else _rep(mesh))
            Psh.append(sh)
            mus.append(sh)
            dbs.append(_rep(mesh))
    return SolverState(
        fac=fac, constraint_fac=cfac, constraint_dual_fac=cdual,
        coupling_fac=cpl, coupling_dual_fac=cpld,
        P=tuple(Psh), DeltaB=tuple(dbs), mu_DeltaB=tuple(mus))
