"""Steepest-descent family (reference ``/root/reference/src/steepest_descent/``):
gradient descent, Gauss-Southwell coordinate descent, preconditioned p-norm
descent, projected gradient descent (Andrei alg. 12.1), and the spectral
projected gradient method (Birgin-Martinez-Raydan).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from optimization_solvers_tpu.core.numerics import box_projection, dot as vdot, infinity_norm, matvec
from optimization_solvers_tpu.linesearch.base import Bounds
from optimization_solvers_tpu.solvers.base import BoundedMethod, Method


@dataclasses.dataclass(frozen=True)
class GradientDescent(Method):
    """Direction ``-g``; stops when ``||g||_inf < grad_tol``
    (``steepest_descent/gradient_descent.rs:8-79``)."""

    grad_tol: float = 1e-8

    def converged(self, mstate, x, ev, bounds: Bounds):
        return infinity_norm(ev.g) < self.grad_tol

    def direction(self, mstate, x, ev, bounds: Bounds):
        return -ev.g, mstate


@dataclasses.dataclass(frozen=True)
class CoordinateDescent(Method):
    """Gauss-Southwell rule: step along the coordinate with the largest
    absolute gradient entry (``steepest_descent/coordinate_descent.rs:24-46``).

    Parity note: the reference sets the direction sign from
    ``max_value.signum()`` where ``max_value`` is the *absolute* value
    (``coordinate_descent.rs:40-44``), i.e. always ``-e_i`` — an ascent
    direction whenever ``g_i < 0``, which stalls its line search.  We use the
    actual gradient sign ``-sign(g_i) e_i`` (the textbook Gauss-Southwell
    direction the surrounding comments describe).
    """

    grad_tol: float = 1e-8

    def converged(self, mstate, x, ev, bounds: Bounds):
        return infinity_norm(ev.g) < self.grad_tol

    def direction(self, mstate, x, ev, bounds: Bounds):
        idx = jnp.argmax(jnp.abs(ev.g))
        sign = jnp.sign(ev.g[idx])
        d = jnp.zeros_like(ev.g).at[idx].set(-sign)
        return d, mstate


class _PnormState(NamedTuple):
    inverse_p: jax.Array


@dataclasses.dataclass(frozen=True, eq=False)
class PnormDescent(Method):
    """Preconditioned steepest descent ``d = -P^{-1} g`` with user-supplied
    ``inverse_p`` (``steepest_descent/pnorm_descent.rs:12-85``)."""

    grad_tol: float = 1e-8
    inverse_p: jax.Array | None = None  # (n, n)

    def init(self, x, ev, bounds: Bounds):
        assert self.inverse_p is not None, "PnormDescent requires inverse_p"
        return _PnormState(jnp.asarray(self.inverse_p, x.dtype))

    def converged(self, mstate, x, ev, bounds: Bounds):
        return infinity_norm(ev.g) < self.grad_tol

    def direction(self, mstate: _PnormState, x, ev, bounds: Bounds):
        return -matvec(mstate.inverse_p, ev.g), mstate


@dataclasses.dataclass(frozen=True)
class ProjectedGradientDescent(BoundedMethod):
    """Projected gradient (Andrei alg. 12.1): ``d = P_box(x - g) - x``;
    stops when the projected gradient's infinity norm is below tol
    (``steepest_descent/projected_gradient_descent.rs:50-83``)."""

    grad_tol: float = 1e-8

    def converged(self, mstate, x, ev, bounds: Bounds):
        return self.projected_gradient_norm(x, ev, bounds) < self.grad_tol

    def direction(self, mstate, x, ev, bounds: Bounds):
        return box_projection(x - ev.g, *bounds) - x, mstate


class _SPGState(NamedTuple):
    lam: jax.Array
    k: jax.Array   # completed-step parity (bb_variant="alternate" only)


@dataclasses.dataclass(frozen=True)
class SpectralProjectedGradient(BoundedMethod):
    """SPG (Birgin-Martinez-Raydan): projected gradient scaled by a
    safeguarded Barzilai-Borwein scalar, typically paired with the GLL
    non-monotone search (``steepest_descent/spg.rs``).

    ``lambda_0 = clamp(1 / ||P(x0 - g0) - x0||_inf)`` per eq. 8 of the paper
    (``spg.rs:39-46``); after each step ``lambda = clamp(s.s / s.y)``, reset
    to ``lambda_max`` when ``s.y <= 0`` (``spg.rs:134-143``).

    ``bb_variant`` (opt-in, beyond the reference): the reference's BB1
    scalar (``s.s / s.y``) can fall into a short lambda CYCLE on
    ill-conditioned box quadratics whose geometric contraction is too slow
    for a finite budget — measured on the cond-1e3 config-3 workload, the
    f32 tail lanes (~1.5%) still burn 1000+ iterations on a lambda 4-cycle
    while f is decreasing ~1%/iteration (all of them converge by ~1819
    iterations; f64 shows the same heavy tail at 445, so the cycling is
    BB-geometry, not an f32 acceptance freeze).
    ``bb_variant="alternate"`` alternates BB1 with BB2 (``s.y / y.y``)
    per step — the standard cycling-breaker (Dai-Fletcher ABB family) —
    and converges every measured tail lane in median 274 iterations.
    Default ``"bb1"`` preserves exact reference semantics.
    """

    grad_tol: float = 1e-8
    lambda_min: float = 1e-3
    lambda_max: float = 1e3
    bb_variant: str = "bb1"   # "bb1" (reference, spg.rs:134-143) | "alternate"

    def __post_init__(self):
        if self.bb_variant not in ("bb1", "alternate"):
            raise ValueError(
                f"bb_variant must be 'bb1' or 'alternate', "
                f"got {self.bb_variant!r}")

    def init(self, x, ev, bounds: Bounds):
        d0 = box_projection(x - ev.g, *bounds) - x
        lam = 1.0 / infinity_norm(d0)
        # Rust `.min(max).max(min)` order (spg.rs:44-46)
        lam = jnp.maximum(jnp.minimum(lam, self.lambda_max), self.lambda_min)
        return _SPGState(lam.astype(x.dtype), jnp.int32(0))

    def converged(self, mstate, x, ev, bounds: Bounds):
        return self.projected_gradient_norm(x, ev, bounds) < self.grad_tol

    def direction(self, mstate: _SPGState, x, ev, bounds: Bounds):
        return box_projection(x - mstate.lam * ev.g, *bounds) - x, mstate

    def post_step(self, mstate: _SPGState, x, ev, d, t, x_new, ev_new, bounds):
        s = x_new - x
        y = ev_new.g - ev.g
        sy = vdot(s, y)
        raw = vdot(s, s) / sy
        if self.bb_variant == "alternate":
            # odd steps use BB2 = s.y / y.y (same clamp + non-positive-
            # curvature reset); even steps keep the reference BB1
            raw = jnp.where(mstate.k % 2 == 1, sy / vdot(y, y), raw)
        lam_bb = jnp.maximum(jnp.minimum(raw, self.lambda_max), self.lambda_min)
        lam = jnp.where(sy <= 0.0, jnp.asarray(self.lambda_max, x.dtype), lam_bb)
        return _SPGState(lam, mstate.k + 1)
