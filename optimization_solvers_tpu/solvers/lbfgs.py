"""Limited-memory BFGS (unbounded) via the two-loop recursion.

The reference exposes limited-memory quasi-Newton ONLY through the Fortran
L-BFGS-B FFI (``/root/reference/src/quasi_newton/lbfgsb.rs``); this module
provides the unbounded Rust-free counterpart as a regular
:class:`~optimization_solvers_tpu.solvers.base.Method` for the generic
driver, keeping memory O(m n) instead of the dense family's O(n^2).

Design: the (m, n) S/Y histories are maintained in chronological order
by a roll-and-write (O(m n) per iteration, trivially fused by XLA); the
two-loop recursion unrolls over the static history length m, so each step
is a chain of fused (n,)-vector FMAs that batches to (B, n) elementwise
work under ``vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from optimization_solvers_tpu.core.numerics import dot as vdot, infinity_norm
from optimization_solvers_tpu.linesearch.base import Bounds
from optimization_solvers_tpu.solvers.base import Method


class LbfgsState(NamedTuple):
    S: jax.Array       # (m, n), row m-1 = newest correction pair
    Y: jax.Array       # (m, n)
    rho: jax.Array     # (m,) 1 / s.y  (0 on invalid slots)
    valid: jax.Array   # (m,) bool
    gamma: jax.Array   # H0 = gamma I scaling


def two_loop_direction(state: LbfgsState, g: jax.Array) -> jax.Array:
    """d = -H g via the standard two-loop recursion over valid pairs."""
    m = state.S.shape[0]
    q = g
    alphas = [None] * m
    for j in range(m - 1, -1, -1):  # newest -> oldest
        a = state.rho[j] * vdot(state.S[j], q)
        a = jnp.where(state.valid[j], a, jnp.zeros_like(a))
        q = q - a * state.Y[j]
        alphas[j] = a
    r = state.gamma * q
    for j in range(m):  # oldest -> newest
        b = state.rho[j] * vdot(state.Y[j], r)
        b = jnp.where(state.valid[j], b, jnp.zeros_like(b))
        r = r + (alphas[j] - b) * state.S[j]
    return -r


def push_pair(state: LbfgsState, s: jax.Array, y: jax.Array, eps: float) -> LbfgsState:
    """Append (s, y) if the curvature condition ``s.y > eps * ||y||^2`` holds
    (the Fortran ``setulb`` acceptance test); otherwise leave history as-is.
    ``eps`` is floored at the WORKING dtype's machine epsilon — the f64
    default would be vacuous against f32 cancellation noise and admit pairs
    that poison the two-loop model (the same dtype-aware gate the three
    L-BFGS-B backends use)."""
    sy = vdot(s, y)
    yy = vdot(y, y)
    eps = max(float(eps), float(jnp.finfo(y.dtype).eps))
    accept = sy > eps * yy
    S = jnp.roll(state.S, -1, axis=0).at[-1].set(s)
    Y = jnp.roll(state.Y, -1, axis=0).at[-1].set(y)
    rho = jnp.roll(state.rho, -1).at[-1].set(1.0 / sy)
    valid = jnp.roll(state.valid, -1).at[-1].set(True)
    gamma = sy / yy
    return LbfgsState(
        S=jnp.where(accept, S, state.S),
        Y=jnp.where(accept, Y, state.Y),
        rho=jnp.where(accept, rho, state.rho),
        valid=jnp.where(accept, valid, state.valid),
        gamma=jnp.where(accept, gamma, state.gamma),
    )


def init_state(n: int, m: int, dtype) -> LbfgsState:
    return LbfgsState(
        S=jnp.zeros((m, n), dtype),
        Y=jnp.zeros((m, n), dtype),
        rho=jnp.zeros((m,), dtype),
        valid=jnp.zeros((m,), bool),
        gamma=jnp.asarray(1.0, dtype),
    )


@dataclasses.dataclass(frozen=True)
class LBFGS(Method):
    """Unbounded L-BFGS; pairs with :class:`MoreThuente` (strong Wolfe keeps
    ``s.y > 0``).  ``m`` in [3, 20] recommended (``lbfgsb.rs:150-154``)."""

    tol: float = 1e-8
    m: int = 10
    curvature_eps: float = 2.2e-16

    def init(self, x, ev, bounds: Bounds):
        return init_state(x.shape[-1], self.m, x.dtype)

    def converged(self, mstate: LbfgsState, x, ev, bounds: Bounds):
        return infinity_norm(ev.g) < self.tol

    def direction(self, mstate: LbfgsState, x, ev, bounds: Bounds):
        d = two_loop_direction(mstate, ev.g)
        # descent safeguard with history reset: f32 cancellation can leave a
        # non-descent or non-finite two-loop direction even under
        # curvature-gated updates; the misleading model is discarded and the
        # iteration retried from steepest descent — the same repair the
        # Fortran core applies on a failed line search (mainlb's restart;
        # surfaced by the reference at lbfgsb.rs:76-84) and the dense-QN
        # restart mode uses
        ok = jnp.all(jnp.isfinite(d)) & (vdot(ev.g, d) < 0.0)
        d = jnp.where(ok, d, -ev.g)
        mstate = mstate._replace(
            rho=jnp.where(ok, mstate.rho, jnp.zeros_like(mstate.rho)),
            valid=jnp.where(ok, mstate.valid, jnp.zeros_like(mstate.valid)),
            gamma=jnp.where(ok, mstate.gamma, jnp.ones_like(mstate.gamma)),
        )
        return d, mstate

    def post_step(self, mstate: LbfgsState, x, ev, d, t, x_new, ev_new, bounds):
        mstate = push_pair(
            mstate, x_new - x, ev_new.g - ev.g, self.curvature_eps)
        # zero-progress repair: a DESCENT two-loop direction can still be so
        # ill-scaled in f32 that the accepted Wolfe step underflows the
        # iterate (x + t*d == x exactly) — the pair is rejected, the state
        # is bit-identical, and the solve wedges at a non-stationary point
        # forever (observed: Rosenbrock-100 lane pinned at pg=9.5 for 5000
        # iterations).  Discard the misleading model so the next iteration
        # retries from steepest descent, the same repair direction() applies
        # to non-descent models (and mainlb applies on failed line searches)
        no_move = jnp.all(x_new == x)
        return LbfgsState(
            S=mstate.S,
            Y=mstate.Y,
            rho=jnp.where(no_move, jnp.zeros_like(mstate.rho), mstate.rho),
            valid=jnp.where(no_move, jnp.zeros_like(mstate.valid),
                            mstate.valid),
            gamma=jnp.where(no_move, jnp.ones_like(mstate.gamma),
                            mstate.gamma),
        )
