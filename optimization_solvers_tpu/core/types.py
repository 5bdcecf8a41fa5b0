"""Core pytree types: oracle evaluations, solve results, status codes.

Batched re-design of the reference oracle protocol
(``/root/reference/src/func_eval.rs:5-41``): instead of a Rust struct returned
by a user closure, a :class:`FuncEval` is a JAX pytree so it can flow through
``jit`` / ``vmap`` / ``lax.while_loop`` carries unchanged.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class Status(enum.IntEnum):
    """Solve status.  Mirrors the reference ``SolverError`` taxonomy
    (``/root/reference/src/ls_solver.rs:10-20``) plus an explicit success code:
    the reference signals success by returning ``Ok(())`` and failure through
    the error enum; on device we carry an int32 status lane-per-instance.
    """

    RUNNING = 0
    CONVERGED = 1            # reference: Ok(()) from minimize
    MAX_ITER_REACHED = 2     # reference: SolverError::MaxIterReached
    OUT_OF_DOMAIN = 3        # reference: SolverError::OutOfDomain
    ERROR_INPUT_PARAMS = 4   # reference: SolverError::ErrorInputParams
    ABNORMAL = 5             # reference: SolverError::AbnormalTermination
    # Honesty-beyond-the-reference code: the quasi-Newton family's
    # s/y-too-close early exit (``bfgs.rs:64-76`` / ``bfgs_b.rs:92-104``)
    # fired at a point whose projected-gradient norm still exceeds the
    # requested tolerance — the reference reports this as plain success
    # (``Ok(())``), burying a non-KKT stop.  The reference-parity API layer
    # (api.py) still treats it as success; SolveResult makes it visible.
    STALLED = 6


class FuncEval(NamedTuple):
    """Value + gradient (+ optional Hessian) of the objective at a point.

    Mirrors ``FuncEval<T, H>`` (``func_eval.rs:5-9``).  ``hessian`` is ``None``
    for first-order oracles; pytrees treat ``None`` as an empty subtree so the
    same driver code serves first- and second-order solvers.
    """

    f: jax.Array                       # scalar objective value
    g: jax.Array                       # (n,) gradient
    hessian: Optional[jax.Array] = None  # (n, n) or None

    def with_hessian(self, hessian: jax.Array) -> "FuncEval":
        # builder parity with func_eval.rs:27-30
        return self._replace(hessian=hessian)

    @property
    def in_domain(self) -> jax.Array:
        """False where f is NaN/Inf — the reference's domain check
        (``ls_solver.rs:37-40``)."""
        return jnp.isfinite(self.f)


class SolveResult(NamedTuple):
    """Structured result of a solve.

    Mirrors the reference WASM ``OptimizationResult``
    (``/root/reference/src/wasm.rs:7-14``: x, f_value, gradient_norm,
    iterations, success, error_message) with device-friendly fields.
    All leaves batch under ``vmap``.

    ``pg_norm`` surfaces per-lane STATIONARITY at exit: the infinity norm
    of the projected gradient ``x - P_box(x - g)`` (plain ``||g||_inf``
    when unbounded).  The bounded quasi-Newton family inherits the
    reference's s/y-stall early exit (``bfgs_b.rs:92-104``), which can
    report success at a non-KKT point — this field makes those lanes
    visible to callers instead of burying them in a benchmark statistic.
    ``None`` on paths that predate the field (external pytrees).
    """

    x: jax.Array           # final iterate, (n,)
    f: jax.Array           # objective at x
    g: jax.Array           # gradient at x
    iterations: jax.Array  # int32 completed solver iterations (reference `k`)
    status: jax.Array      # int32 Status code
    pg_norm: Optional[jax.Array] = None  # ||x - P(x - g)||_inf at exit
    # f32x2 solves (round 5): the certified iterate is x + x_lo — the
    # double-float low word.  An f32-grid point alone cannot certify
    # grad_tol 1e-6 (|g| quantizes in steps of ~L*eps*|x|); status/pg_norm
    # refer to the PAIR.  None on plain-precision paths.
    x_lo: Optional[jax.Array] = None

    @property
    def converged(self) -> jax.Array:
        return self.status == Status.CONVERGED

    @property
    def stalled(self) -> jax.Array:
        """Lanes whose quasi-Newton s/y-stall exit fired at a non-KKT point
        (``pg_norm`` above the requested tolerance) — the reference's
        silent non-KKT "success" (``bfgs_b.rs:92-104``), made visible."""
        return self.status == Status.STALLED

    @property
    def g_norm(self) -> jax.Array:
        return jnp.linalg.norm(self.g, axis=-1)

    def stationary(self, tol: float) -> jax.Array:
        """Per-lane KKT check at ``tol``: projected-gradient infinity norm
        below ``tol`` (requires ``pg_norm``; raises if absent)."""
        if self.pg_norm is None:
            raise ValueError("this SolveResult carries no pg_norm")
        return self.pg_norm <= tol
