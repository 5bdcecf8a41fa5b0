"""Newton family (reference ``/root/reference/src/newton/``): damped Newton,
projected Newton, and spectral projected Newton (SPN).

The dense linear-algebra cores (inverse / Cholesky solve) go through
:mod:`optimization_solvers_tpu.ops`, i.e. XLA's native factorizations.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from optimization_solvers_tpu.core.numerics import box_projection, dot as vdot, infinity_norm, matvec
from optimization_solvers_tpu.linesearch.base import Bounds
from optimization_solvers_tpu.ops import cholesky_solve
from optimization_solvers_tpu.solvers.base import BoundedMethod, Method


class _NewtonState(NamedTuple):
    decrement_squared: jax.Array


@dataclasses.dataclass(frozen=True)
class Newton(Method):
    """Damped Newton: ``d = -H^{-1} g`` with steepest-descent fallback when
    ``H`` is singular (``newton/mod.rs:26-48``); stops when half the squared
    Newton decrement is below tol (``newton/mod.rs:64-69``).

    Parity note: the reference's "decrement" is literally
    ``(H^{-1} d) . d`` with ``d = -H^{-1} g`` (``newton/mod.rs:40``) — we
    reproduce that quantity, not the textbook ``g^T H^{-1} g``.
    """

    tol: float = 1e-8
    needs_hessian = True

    def init(self, x, ev, bounds: Bounds):
        # reference: decrement starts as None => has_converged false
        return _NewtonState(jnp.asarray(jnp.inf, x.dtype))

    def converged(self, mstate: _NewtonState, x, ev, bounds: Bounds):
        return mstate.decrement_squared * 0.5 < self.tol

    def direction(self, mstate: _NewtonState, x, ev, bounds: Bounds):
        h_inv = jnp.linalg.inv(ev.hessian)
        d_newton = -matvec(h_inv, ev.g)
        ok = jnp.all(jnp.isfinite(d_newton))
        d = jnp.where(ok, d_newton, -ev.g)
        dec2 = jnp.where(ok, vdot(matvec(h_inv, d_newton), d_newton), mstate.decrement_squared)
        return d, _NewtonState(dec2)


class _PNState(NamedTuple):
    s_norm: jax.Array
    y_norm: jax.Array


@dataclasses.dataclass(frozen=True)
class ProjectedNewton(BoundedMethod):
    """Projected Newton: ``d = P_box(x - chol(H)^{-1} g) - x``
    (``newton/projected_newton.rs:64-80``); stops on projected-gradient
    norm or when the iterate/gradient stopped moving
    (``projected_newton.rs:95-110``).

    The reference ``unwrap()``s the Cholesky factorization and panics on a
    non-PD Hessian; here a non-PD Hessian yields NaNs which surface as an
    ``OUT_OF_DOMAIN`` status at the next iteration.
    """

    grad_tol: float = 1e-8
    needs_hessian = True

    def init(self, x, ev, bounds: Bounds):
        inf = jnp.asarray(jnp.inf, x.dtype)
        return _PNState(inf, inf)

    def converged(self, mstate: _PNState, x, ev, bounds: Bounds):
        too_close = (mstate.s_norm < self.grad_tol) | (mstate.y_norm < self.grad_tol)
        return too_close | (self.projected_gradient_norm(x, ev, bounds) < self.grad_tol)

    def direction(self, mstate, x, ev, bounds: Bounds):
        step = cholesky_solve(ev.hessian, ev.g)
        return box_projection(x - step, *bounds) - x, mstate

    def post_step(self, mstate, x, ev, d, t, x_new, ev_new, bounds):
        s_norm = jnp.linalg.norm(x_new - x)
        y_norm = jnp.linalg.norm(ev_new.g - ev.g)
        return _PNState(s_norm, y_norm)


class _SPNState(NamedTuple):
    lam: jax.Array


@dataclasses.dataclass(frozen=True)
class SpectralProjectedNewton(BoundedMethod):
    """SPN: projected Newton step scaled by the safeguarded
    Barzilai-Borwein scalar (``newton/spn.rs:76-91``); BB update identical
    to SPG (``spn.rs:139-148``).

    Known property of the reference update (measured, not an f32 artifact —
    f64 shows the identical stall): the gradient-metric BB scalar
    ``s.s / s.y`` applied to a NEWTON direction freezes at the inverse
    Rayleigh quotient of H along the Newton ray (the iterate map is
    ``x <- (1 - lam) x`` on a quadratic, so the pair never explores a new
    direction), giving a geometric rate of ``1 - lam`` instead of the
    Newton one-step.  ``precond_bb=True`` (opt-in; default keeps reference
    semantics) computes the pair in the Newton-preconditioned metric —
    ``lam = s.s / s.(H^{-1} y)`` with the factor already in hand — which
    restores ``lam -> 1`` (exact on quadratics) and one-step-like
    convergence; see PARITY.md."""

    grad_tol: float = 1e-8
    lambda_min: float = 1e-3
    lambda_max: float = 1e3
    precond_bb: bool = False
    needs_hessian = True

    def init(self, x, ev, bounds: Bounds):
        d0 = box_projection(x - ev.g, *bounds) - x
        lam = 1.0 / infinity_norm(d0)
        lam = jnp.maximum(jnp.minimum(lam, self.lambda_max), self.lambda_min)
        return _SPNState(lam.astype(x.dtype))

    def converged(self, mstate, x, ev, bounds: Bounds):
        return self.projected_gradient_norm(x, ev, bounds) < self.grad_tol

    def direction(self, mstate: _SPNState, x, ev, bounds: Bounds):
        step = cholesky_solve(ev.hessian, ev.g)
        return box_projection(x - mstate.lam * step, *bounds) - x, mstate

    def post_step(self, mstate: _SPNState, x, ev, d, t, x_new, ev_new, bounds):
        s = x_new - x
        y = ev_new.g - ev.g
        if self.precond_bb:
            # secant in the preconditioned metric: s ~ lam * H^{-1} y, so
            # lam = s.s / s.(H^{-1} y) (exactly 1 on a quadratic); H at the
            # accepted pair's left endpoint, like the direction solve
            y = cholesky_solve(ev.hessian, y)
        sy = vdot(s, y)
        lam_bb = jnp.maximum(jnp.minimum(vdot(s, s) / sy, self.lambda_max), self.lambda_min)
        # sy > 0 (not sy <= 0) so a NaN pair also resets to lambda_max
        lam = jnp.where(sy > 0.0, lam_bb, jnp.asarray(self.lambda_max, x.dtype))
        return _SPNState(lam)
