"""Dense quasi-Newton family (reference ``/root/reference/src/quasi_newton/``):
BFGS, DFP, Broyden ("bad" rank-1 on the inverse), their box-constrained
twins BFGSB/DFPB/BroydenB, and the bounded-only SR1B (the reference has no
unbounded SR1, ``lib.rs:60-61``).

All maintain a dense approximate *inverse* Hessian ``B ~ H^{-1}`` seeded at
identity, with direction ``-B g`` (projected variants:
``P_box(x - B g) - x``), the shared "iterate/gradient didn't move" early
exits (``bfgs.rs:15-26,64-76``), and a rank-1/rank-2 post-step update that is
skipped when the correction pair is too small (``bfgs.rs:104-112``).

The updates are expressed as outer products and matvecs that XLA fuses;
under ``vmap`` they become batched (B, n, n) elementwise updates.  The BFGS
two-sided update is algebraically expanded to avoid
materializing the two (n, n) ``I - rho s y^T`` factors the reference builds
(``bfgs.rs:114-124``):

    B' = B - rho (s (B^T y)^T + (B y) s^T) + rho^2 (y^T B y) s s^T + rho s s^T

which costs two matvecs + three rank-1 updates instead of two n x n matmuls
— O(n^2) instead of O(n^3) per iteration, a strict improvement with
identical semantics (for symmetric B, B^T y = B y).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from optimization_solvers_tpu.core.numerics import box_projection, dot as vdot, matvec
from optimization_solvers_tpu.linesearch.base import Bounds
from optimization_solvers_tpu.solvers.base import BoundedMethod, Method


class _QNState(NamedTuple):
    B: jax.Array       # (n, n) approximate inverse Hessian
    s_norm: jax.Array
    y_norm: jax.Array
    stalls: jax.Array = 0  # consecutive degenerate pairs
                       # (restart_on_degeneracy mode only)


def _bfgs_update(B, s, y, rho):
    """Nocedal-Wright eq. 2.21, expanded (see module docstring)."""
    By = matvec(B, y)
    yBy = vdot(y, By)
    ss = jnp.outer(s, s)
    return B - rho * (jnp.outer(s, By) + jnp.outer(By, s)) + (rho * rho * yBy + rho) * ss


def _dfp_update(B, s, y, sy):
    """``B += s s^T / s.y - (B y)(B y)^T / (y^T B y)`` (``dfp.rs:114-120``)."""
    By = matvec(B, y)
    return B + jnp.outer(s, s) / sy - jnp.outer(By, By) / vdot(y, By)


def _broyden_update(B, s, y, sy):
    """"Bad" Broyden rank-1 on the inverse:
    ``B += (s - B y) (B^T s)^T / s.y`` (``broyden.rs:114-118``)."""
    By = matvec(B, y)
    return B + jnp.outer(s - By, matvec(B.T, s)) / sy


def _sr1_update(B, s, y, sy):
    """SR1: ``B += (s - B y)(s - B y)^T / (s - B y).y`` (``sr1_b.rs:143-147``)."""
    shy = s - matvec(B, y)
    return B + jnp.outer(shy, shy) / vdot(shy, y)


_UPDATES = {
    "bfgs": lambda B, s, y, sy: _bfgs_update(B, s, y, 1.0 / sy),
    "dfp": _dfp_update,
    "broyden": _broyden_update,
    "sr1": _sr1_update,
}


@dataclasses.dataclass(frozen=True)
class _QuasiNewtonCommon:
    """Shared quasi-Newton machinery; ``update`` picks the B-update rule."""

    tol: float = 1e-8
    update: str = "bfgs"
    # Robustness knobs beyond the reference (default off = exact
    # reference semantics, bfgs.rs:104-124):
    #  * scale_b0: before the FIRST update, rescale B0 = (s.y/y.y) I
    #    (Nocedal-Wright eq. 6.20) so the initial inverse-Hessian guess
    #    matches the problem's curvature scale;
    #  * restart_on_degeneracy: on a degenerate/indefinite correction pair
    #    (s.y <= 0, tiny s/y, or a non-finite update) reset B to the scaled
    #    identity and keep iterating instead of freezing B — and drop the
    #    s/y-too-close early *convergence* exit, so a stalled line search
    #    restarts as steepest descent rather than reporting success.
    scale_b0: bool = False
    restart_on_degeneracy: bool = False

    def init(self, x, ev, bounds: Bounds):
        n = x.shape[-1]
        inf = jnp.asarray(jnp.inf, x.dtype)
        return _QNState(jnp.eye(n, dtype=x.dtype), inf, inf,
                        jnp.zeros((), jnp.int32))

    def converged(self, mstate: _QNState, x, ev, bounds: Bounds):
        # s/y-too-close early exits, then the 2-norm gradient test
        # (bfgs.rs:64-76 — note: 2-norm here, unlike the infinity norm of
        # the steepest-descent family)
        g_small = jnp.linalg.norm(ev.g) < self.tol
        if self.restart_on_degeneracy:
            # a restarted (steepest-descent) step that stalls again means
            # the lane sits at its numerical floor: accept the reference's
            # stall exit only after the restart had its chance
            return g_small | (mstate.stalls >= 2)
        too_close = (mstate.s_norm < self.tol) | (mstate.y_norm < self.tol)
        return too_close | g_small

    def stall_status(self, x, f, g, pg_norm, bounds):
        """Per-lane "the exit was the s/y-stall at a non-KKT point" mask
        (VERDICT round-3 item 5).  The reference's early exit
        (``bfgs.rs:64-76`` / ``bfgs_b.rs:92-104``) reports success when the
        iterate stops moving even if the gradient test never passed; the
        driver re-labels such lanes :data:`Status.STALLED` when their
        projected-gradient norm still exceeds ``tol``.  Derivable from the
        exit point alone: a CONVERGED status with ``||g||_2 >= tol`` means
        the gradient test did NOT fire, so the stall exit did.  Lanes that
        stall at a certified stationary point (``pg_norm <= tol`` — e.g.
        active bounds where the raw 2-norm test can never pass) keep
        CONVERGED."""
        g_small = jnp.sqrt(jnp.sum(g * g, axis=-1)) < self.tol
        return (~g_small) & (pg_norm > self.tol)

    def post_step(self, mstate: _QNState, x, ev, d, t, x_new, ev_new, bounds):
        s = x_new - x
        y = ev_new.g - ev.g
        s_norm = jnp.linalg.norm(s)
        y_norm = jnp.linalg.norm(y)
        # freeze B when the correction pair is degenerate (bfgs.rs:104-112);
        # also guards non-finite updates from poisoning a frozen lane
        skip = (s_norm < self.tol) | (y_norm < self.tol)
        if self.scale_b0 or self.restart_on_degeneracy:
            return self._robust_post_step(
                mstate, s, y, s_norm, y_norm, skip)
        B_new = _UPDATES[self.update](mstate.B, s, y, vdot(s, y))
        B_new = jnp.where(skip, mstate.B, B_new)
        return _QNState(B_new, s_norm, y_norm, mstate.stalls)

    def _robust_post_step(self, mstate, s, y, s_norm, y_norm, skip):
        """scale_b0 / restart_on_degeneracy variants (see field docs)."""
        n = s.shape[-1]
        eye = jnp.eye(n, dtype=s.dtype)
        sy = vdot(s, y)
        curvature_ok = sy > jnp.finfo(s.dtype).eps * s_norm * y_norm
        B_cur = mstate.B
        if self.scale_b0:
            first = ~jnp.isfinite(mstate.s_norm)
            gamma = jnp.where(curvature_ok, sy / vdot(y, y), 1.0)
            B_cur = jnp.where(first & curvature_ok, gamma * eye, B_cur)
        B_new = _UPDATES[self.update](B_cur, s, y, sy)
        ok = curvature_ok & jnp.all(jnp.isfinite(B_new)) & ~skip
        if self.restart_on_degeneracy:
            # degenerate pair: restart from the (scaled) identity and keep
            # going — the next direction is steepest descent
            B_next = jnp.where(ok, B_new, eye)
        else:
            B_next = jnp.where(ok, B_new, B_cur)
        stalls = jnp.where(ok, jnp.int32(0), mstate.stalls + 1)
        return _QNState(B_next, s_norm, y_norm, stalls)


@dataclasses.dataclass(frozen=True)
class QuasiNewton(_QuasiNewtonCommon, Method):
    """Unconstrained quasi-Newton: direction ``-B g`` (``bfgs.rs:42-49``)."""

    def direction(self, mstate: _QNState, x, ev, bounds: Bounds):
        d = -matvec(mstate.B, ev.g)
        if self.restart_on_degeneracy:
            # descent safeguard: a restarted B that fails to give descent
            # falls back to steepest descent
            d = jnp.where(vdot(ev.g, d) < 0.0, d, -ev.g)
        return d, mstate


@dataclasses.dataclass(frozen=True)
class QuasiNewtonB(_QuasiNewtonCommon, BoundedMethod):
    """Box-constrained quasi-Newton: ``d = P_box(x - B g) - x``
    (``bfgs_b.rs:66-77``); x0 projected at construction (``bfgs_b.rs:50``).
    Note: convergence still tests the raw gradient 2-norm, exactly like the
    reference (``bfgs_b.rs:92-104``), not the projected gradient."""

    def direction(self, mstate: _QNState, x, ev, bounds: Bounds):
        d = box_projection(x - matvec(mstate.B, ev.g), *bounds) - x
        if self.restart_on_degeneracy:
            d = jnp.where(vdot(ev.g, d) < 0.0, d,
                          box_projection(x - ev.g, *bounds) - x)
        return d, mstate


def BFGS(tol: float = 1e-8, **kw) -> QuasiNewton:
    return QuasiNewton(tol=tol, update="bfgs", **kw)


def DFP(tol: float = 1e-8, **kw) -> QuasiNewton:
    return QuasiNewton(tol=tol, update="dfp", **kw)


def Broyden(tol: float = 1e-8, **kw) -> QuasiNewton:
    return QuasiNewton(tol=tol, update="broyden", **kw)


def BFGSB(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    return QuasiNewtonB(tol=tol, update="bfgs", **kw)


def DFPB(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    return QuasiNewtonB(tol=tol, update="dfp", **kw)


def BroydenB(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    return QuasiNewtonB(tol=tol, update="broyden", **kw)


def SR1B(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    """SR1 exists only in bounded form in the reference (``lib.rs:60-61``)."""
    return QuasiNewtonB(tol=tol, update="sr1", **kw)
