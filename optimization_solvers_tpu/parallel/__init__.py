"""Mesh / sharding / collectives layer — the new capability dimension the
single-process reference lacks (SURVEY.md §2.5)."""

from optimization_solvers_tpu.parallel.mesh import batch_sharding, make_mesh
from optimization_solvers_tpu.parallel.sharded import (
    coordinate_sharded_lbfgsb_minimize,
    coordinate_sharded_minimize,
    scaling_report,
    sharded_batch_minimize,
    sharded_lbfgsb_minimize,
    sharded_summary,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "sharded_batch_minimize",
    "sharded_lbfgsb_minimize",
    "coordinate_sharded_minimize",
    "coordinate_sharded_lbfgsb_minimize",
    "sharded_summary",
    "scaling_report",
]
