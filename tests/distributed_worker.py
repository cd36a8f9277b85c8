"""Worker process for tests/test_distributed.py — NOT a pytest file.

Each of N processes owns 4 virtual CPU devices (XLA_FLAGS set by the
parent); jax.distributed connects them into one 4N-device runtime with
gloo-backed cross-process collectives (the CPU stand-in for NCCL between
the GPUs of several processes).  The worker rebuilds the deterministic flagship problem,
globalizes data + state with the production shardings
(parallel/sharding.py), runs the FULL fit() over the global mesh, and
compares trajectory + final factors against the single-process baseline
the parent saved to an .npz.  Prints DISTOK on success.

Usage: distributed_worker.py <pid> <nproc> <port> <baseline.npz> [config]

config: 'flagship' (default, coupled CP+PARAFAC2 type-0) or 'type4' (the
bench flagship's selector coupling — the normal-equation Delta solve,
cmtf_fun_AOADMM.m:904-983, over real cross-process collectives).
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

proc_id, nproc, port, baseline_path = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4])
config = sys.argv[5] if len(sys.argv) > 5 else "flagship"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from matlab_code_tpu.parallel import distributed  # noqa: E402

distributed.initialize(coordinator_address=f"localhost:{port}",
                       num_processes=nproc, process_id=proc_id)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as ge  # noqa: E402
from matlab_code_tpu.models.solver import fit  # noqa: E402
from matlab_code_tpu.options import AlgOptions  # noqa: E402
from matlab_code_tpu.parallel.sharding import (  # noqa: E402
    data_shardings, state_shardings)

assert len(jax.devices()) == 4 * nproc, jax.devices()
assert len(jax.local_devices()) == 4

# identical deterministic problem on every process (seeded generators)
if config == "type4":
    spec, data, state = ge._type4_problem(4 * nproc)
else:
    spec, data, state, _ = ge._flagship(I0=16, J1=12, J2=16, K=8, Jb=10, R=3)
opts = AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)

mesh = distributed.make_global_mesh()
data_sh, sharded_modes = data_shardings(spec, data, mesh)
state_sh = state_shardings(spec, state, mesh, sharded_modes)
data_g = distributed.globalize_tree(data, data_sh)
state_g = distributed.globalize_tree(state, state_sh)

st, out = fit(spec, data_g, state_g, opts)

ref = np.load(baseline_path)
np.testing.assert_allclose(out.func_val_conv, ref["func_val_conv"],
                           rtol=1e-11, atol=1e-13)
np.testing.assert_allclose(out.func_coupl_conv, ref["func_coupl_conv"],
                           rtol=1e-9, atol=1e-12)
assert out.OuterIterations == int(ref["outer_iterations"])
for m in range(spec.nb_modes):
    np.testing.assert_allclose(distributed.fetch(st.fac[m]), ref[f"fac{m}"],
                               rtol=1e-9, atol=1e-11)

print(f"proc {proc_id}: DISTOK", flush=True)
distributed.shutdown()
