"""Multi-host / multi-process backend for the coupled solver.

The reference is single-process MATLAB (SURVEY.md §2.3); this module is the
distributed runtime this framework adds.  Where several processes share a
run — one per GPU of a host, or one per host — every process calls
`initialize()` before building a mesh; `make_global_mesh` then spans all
processes' devices, and the sharding layouts in parallel/sharding.py place
the collectives (NCCL over NVLink between the GPUs of a host) exactly as
jax/XLA derive them from the device order.  One process can also drive all
GPUs of a host on its own, with no `initialize()` at all.

Host-local numpy data becomes global (cross-process) jax.Arrays through
`globalize` / `globalize_tree`; results come back to every host through
`fetch` / `fetch_tree`.  The full loop — initialize, globalize the problem
pytrees with the production shardings, run `fit()` over the global mesh,
fetch factors — is exercised for real (two OS processes, gloo-backed
cross-process collectives, numeric equality vs the single-process fit) by
`tests/test_distributed.py` + `tests/distributed_worker.py`.
"""
from __future__ import annotations

import jax
import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Wrapper over jax.distributed.initialize.  On one host with several
    GPUs and no cluster manager, pass all three arguments: a coordinator
    address such as 'localhost:<free port>', the number of processes and
    this process's id."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def shutdown() -> None:
    jax.distributed.shutdown()


def make_global_mesh(axis: str = "d"):
    """Mesh over every device of every participating process."""
    from matlab_code_tpu.parallel.sharding import make_mesh
    return make_mesh(devices=jax.devices())


def globalize(x, sharding):
    """Host-local numpy value -> global jax.Array with `sharding`.

    Every process must hold the SAME full value of `x` (the coupled-fit
    problem is deterministic from its seed, so each host rebuilds it);
    each process then donates only the shards it is responsible for.
    """
    if x is None:
        return None
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def globalize_tree(tree, shardings):
    """Map `globalize` over a pytree and a matching sharding pytree
    (None sharding leaves pass through untouched — they stay host values)."""
    return jax.tree.map(
        lambda x, s: x if s is None else globalize(x, s), tree, shardings,
        is_leaf=lambda x: x is None)


_REPLICATORS: dict = {}   # mesh -> jitted identity with replicated output


def fetch(x) -> np.ndarray:
    """Global jax.Array -> full numpy value on every process.

    Fully-addressable or fully-replicated arrays convert directly; a
    cross-process sharded array is first re-replicated (an all-gather over
    the mesh) by a per-mesh cached identity jit with replicated
    out_shardings.
    """
    if not isinstance(x, jax.Array):
        return np.asarray(x)
    if x.is_fully_addressable or x.is_fully_replicated:
        return np.asarray(x)
    from jax.sharding import NamedSharding, PartitionSpec
    sh = x.sharding
    if not isinstance(sh, NamedSharding):
        raise TypeError(
            f"fetch() of a non-addressable array needs a NamedSharding to "
            f"locate its mesh, got {type(sh).__name__}; re-shard it or use "
            f"jax.experimental.multihost_utils.process_allgather")
    rep = _REPLICATORS.get(sh.mesh)
    if rep is None:
        rep = jax.jit(lambda a: a,
                      out_shardings=NamedSharding(sh.mesh, PartitionSpec()))
        _REPLICATORS[sh.mesh] = rep
    return np.asarray(rep(x))


def fetch_tree(tree):
    return jax.tree.map(fetch, tree)
