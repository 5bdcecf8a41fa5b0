"""Batched smooth-optimization solver suite (JAX/XLA/pjit).

A brand-new, batched, device-resident re-design of the capabilities of the
reference Rust crate ``fedemagnani/optimization-solvers`` (see /root/reference):
line-search based solvers for unconstrained and box-constrained convex
minimization.  Where the reference runs one f64 problem instance per call on a
single CPU core, this framework vmaps thousands of instances per device,
shards them over multi-device meshes with ``jax.sharding`` and drives
every solve with a device-resident ``lax.while_loop`` (no host round-trips).

Layer map (mirrors SURVEY.md §1):
  core/       -- FuncEval pytree, oracle factory, box projection, norms (ref L0/L1)
  linesearch/ -- batched backtracking / GLL / More-Thuente (+bounded)   (ref L2)
  solvers/    -- generic driver + 13 solver families + L-BFGS-B          (ref L3/L4)
  ops/        -- dense linear-algebra cores (Cholesky solves)
  parallel/   -- mesh / sharding / collectives layer (new capability)
  utils/      -- telemetry, plotting, result types                       (ref L5)
"""

from optimization_solvers_tpu.core.types import (
    FuncEval,
    SolveResult,
    Status,
)
from optimization_solvers_tpu.core.numerics import (
    box_projection,
    infinity_norm,
    projected_gradient,
)
from optimization_solvers_tpu.core.oracle import make_oracle
from optimization_solvers_tpu.core import problems

from optimization_solvers_tpu import linesearch
from optimization_solvers_tpu import solvers
from optimization_solvers_tpu import parallel
from optimization_solvers_tpu import utils
from optimization_solvers_tpu import api
from optimization_solvers_tpu import ops
from optimization_solvers_tpu.frontend import minimize

__version__ = "0.1.0"

__all__ = [
    "FuncEval",
    "SolveResult",
    "Status",
    "box_projection",
    "infinity_norm",
    "projected_gradient",
    "make_oracle",
    "minimize",
    "problems",
    "linesearch",
    "solvers",
    "parallel",
    "utils",
    "api",
    "ops",
]
