"""Compute kernels: dense SPD solves (XLA / cuSOLVER) and the unrolled
small-matrix Cholesky the L-BFGS-B middle matrix uses."""

from optimization_solvers_tpu.ops.linalg import cholesky_solve, solve_spd

__all__ = [
    "cholesky_solve",
    "solve_spd",
]
