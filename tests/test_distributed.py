"""Real multi-process exercise of the distributed backend.

SURVEY.md §2.3: the reference is serial MATLAB; this framework's multi-host
story is jax.distributed + the sharding layouts of parallel/sharding.py.
This test runs it for REAL on one machine: two OS processes, each owning 4
virtual CPU devices, joined by jax.distributed.initialize into one
8-device runtime whose cross-process collectives go through gloo (the CPU
stand-in for NCCL).  Both workers run the full fit() over the global mesh with the
production shardings and assert numeric equality (trajectory rtol 1e-11,
factors 1e-9) against the single-process baseline computed here.

This is the same problem/options/mesh-size as
test_aux.py::test_sharded_full_fit_matches_single_device — that test pins
single-process/8-device equality, this one pins 2-process/8-device.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import __graft_entry__ as ge
from matlab_code_tpu.models.solver import fit
from matlab_code_tpu.options import AlgOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("config", ["flagship", "type4"])
def test_two_process_fit_matches_single_process(tmp_path, config):
    # single-process baseline (this pytest process: 8 virtual devices, but
    # the un-meshed fit runs on one).  'type4' runs the bench flagship's
    # selector coupling (normal-equation Delta solve) over real gloo
    # cross-process collectives.
    if config == "type4":
        spec, data, state = ge._type4_problem(8)
    else:
        spec, data, state, _ = ge._flagship(I0=16, J1=12, J2=16, K=8,
                                            Jb=10, R=3)
    opts = AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)
    st_ref, out_ref = fit(spec, data, state, opts)
    baseline = tmp_path / "baseline.npz"
    np.savez(baseline,
             func_val_conv=out_ref.func_val_conv,
             func_coupl_conv=out_ref.func_coupl_conv,
             outer_iterations=out_ref.OuterIterations,
             **{f"fac{m}": np.asarray(st_ref.fac[m])
                for m in range(spec.nb_modes)})

    port = _free_port()
    env = dict(os.environ,
               PYTHONPATH=REPO,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    # worker output goes to files, not pipes: a blocked pipe write would
    # stall one worker inside a gloo collective and hang its peer too
    log_paths = [tmp_path / f"worker{i}.log" for i in range(2)]
    log_files = [open(p, "w") for p in log_paths]
    workers = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "distributed_worker.py"),
             str(i), "2", str(port), str(baseline), config],
            env=env, stdout=log_files[i], stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        for w in workers:
            w.wait(timeout=600)
    except subprocess.TimeoutExpired:
        for w in workers:
            w.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(
            p.read_text() for p in log_paths))
    finally:
        for f in log_files:
            f.close()
    for i, (w, p) in enumerate(zip(workers, log_paths)):
        log = p.read_text()
        assert w.returncode == 0, f"worker {i} failed:\n{log}"
        assert f"proc {i}: DISTOK" in log, log
