"""matlab_code_tpu — a JAX/XLA framework for constrained, regularized and
linearly coupled matrix/tensor factorizations via AO-ADMM, run on GPUs.

Re-designed from scratch in JAX with the capabilities of the
AOADMM-DataFusionFramework (the MATLAB reference).  The compute path is pure
JAX (jit / lax.while_loop / vmap / shard_map); the solver state is a pytree;
problem structure is resolved at trace time.

Public API (rough mapping to the reference):
  cmtf_aoadmm(...)            <-> functions/cmtf_AOADMM.m
  init_coupled(...)           <-> functions/init_coupled_AOADMM_CMTF.m
  create_coupled_data(...)    <-> functions/create_coupled_data.m
  ProblemSpec / CouplingSpec  <-> the Z struct (static part)
  AlgOptions                  <-> the options struct
  SolverState                 <-> the G / Fac struct
"""

from matlab_code_tpu.problem import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, ProblemData,
    SparseTensor, Parafac2Tensor, check_data_input,
)
from matlab_code_tpu.options import AlgOptions, InitOptions
from matlab_code_tpu.state import SolverState
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import cmtf_aoadmm, fit
from matlab_code_tpu.models.multistart import fit_multistart
from matlab_code_tpu.utils.datagen import create_coupled_data

__all__ = [
    "ProblemSpec", "DatasetSpec", "CouplingSpec", "ConstraintSpec",
    "ProblemData", "SparseTensor", "Parafac2Tensor", "AlgOptions",
    "InitOptions", "SolverState", "init_coupled", "cmtf_aoadmm", "fit",
    "fit_multistart", "create_coupled_data", "check_data_input",
]

__version__ = "0.1.0"
