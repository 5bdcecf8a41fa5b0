"""More-Thuente (1994) strong-Wolfe line search, batched TPU redesign.

Reference: ``/root/reference/src/line_search/morethuente.rs`` (unconstrained)
and ``morethuente_b.rs`` (box-constrained max-step variant).  The reference's
highly branchy state machine (4-case trial-value selection, interval update
U1-U3, auxiliary-psi vs modified-phi switching) is re-expressed as straight
scalar dataflow under a ``lax.while_loop``: every branch becomes a masked
select over per-lane scalars, so a single compiled program serves every lane
of a ``vmap`` batch without divergence.

Parity notes (bug-for-bug where observable):
  * The interval update is applied with the *new* trial ``t`` but the *old*
    function values (``morethuente.rs:293``), exactly as the reference does.
  * Rust's NaN-discarding ``f64::min/max`` semantics in the case-3 safeguard
    and the final clamp (``morethuente.rs:268-270,290``) are replicated via
    :func:`rust_min`/:func:`rust_max`/:func:`rust_clamp`.
  * The bounded variant's per-coordinate max feasible step
    (``morethuente_b.rs:185-201``) persistently *shrinks* ``t_max`` across
    calls within a solve (the reference mutates ``self.t_max``); that running
    minimum is threaded through the line-search state here.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
from jax import lax

from optimization_solvers_tpu.core.numerics import dot as vdot, rust_clamp, rust_max, rust_min
from optimization_solvers_tpu.linesearch.base import (
    Bounds, LineSearch, _trial_cb, strong_wolfe)


def _cubic_minimizer(ta, tb, f_ta, f_tb, g_ta, g_tb):
    """Sun & Yuan eq. 2.4.51 / 2.4.56 (``morethuente.rs:93-108``)."""
    s = 3.0 * (f_tb - f_ta) / (tb - ta)
    z = s - g_ta - g_tb
    w = jnp.sqrt(z * z - g_ta * g_tb)
    return ta + (tb - ta) * ((w - g_ta - z) / (g_tb - g_ta + 2.0 * w))


def _quadratic_minimizer_1(ta, tb, f_ta, f_tb, g_ta):
    """Sun & Yuan eq. 2.4.2 (``morethuente.rs:110-121``)."""
    lin_int = (f_ta - f_tb) / (ta - tb)
    return ta - 0.5 * ((ta - tb) * g_ta / (g_ta - lin_int))


def _quadratic_minimizer_2(ta, tb, g_ta, g_tb):
    """Sun & Yuan eq. 2.4.5 (``morethuente.rs:123-132``)."""
    return ta - g_ta * ((ta - tb) / (g_ta - g_tb))


def _update_interval(f_tl, f_t, g_t, tl, t, tu):
    """Cases U1/U2/U3 of the (modified) updating algorithm
    (``morethuente.rs:64-91``); returns ``(tl, tu, interval_converged)``."""
    u1 = f_t > f_tl
    gd = g_t * (tl - t)
    u2 = (~u1) & (gd > 0.0)
    u3 = (~u1) & (~u2) & (gd < 0.0)
    conv = ~(u1 | u2 | u3)
    new_tu = jnp.where(u1, t, jnp.where(u3, tl, tu))
    new_tl = jnp.where(u2 | u3, t, tl)
    return new_tl, new_tu, conv


@dataclasses.dataclass(frozen=True)
class MoreThuente(LineSearch):
    """Strong-Wolfe search; defaults per ``morethuente.rs:16-28``.

    **Documented deviation (default ``reference_quirks=False``)**: the
    reference applies the interval update with the NEXT trial ``t`` instead
    of the just-evaluated one (``morethuente.rs:293``).  After a case-1
    interpolation that sets ``tu := t_next``, the following iteration exits
    on ``t == tu`` WITHOUT the Wolfe conditions holding — on hard problems
    (e.g. Rosenbrock-100) the search then returns a step that increases
    ``f`` by orders of magnitude and the solve diverges.  The correct
    Moré-Thuente update (interval revised at the *evaluated* ``t``,
    MT 1994 §2 updating algorithm) is the default; set
    ``reference_quirks=True`` for bug-for-bug reference parity.
    """

    c1: float = 1e-4
    c2: float = 0.9
    t_min: float = 0.0
    t_max: float = math.inf
    delta_min: float = 0.58333333
    delta: float = 0.66
    delta_max: float = 1.1
    reference_quirks: bool = False
    # opt-in Hager-Zhang approximate-Wolfe (T2) acceptance alongside the
    # strong-Wolfe test: near a minimizer the f32 difference f(x+td) - f0
    # is pure cancellation noise, the Armijo half of strong Wolfe becomes
    # undecidable, and MT's interval collapses to sub-ulp steps (the
    # L-BFGS+MT livelock).  T2 replaces it with the
    # derivative-only test (2c1-1)phi'(0) >= phi'(t) >= c2 phi'(0) plus the
    # f <= f0 + aw_eps|f0| membership (CG_DESCENT 2005, eq. 4.1) — exactly
    # what linesearch/hager_zhang.py does natively.  Default OFF: reference
    # MT semantics.
    approx_wolfe: bool = False
    aw_eps: float = 1e-6

    def __post_init__(self):
        assert 0.0 < self.c1 < self.c2 < 1.0, "require 0 < c1 < c2 < 1"

    def _t_bounds(self, x, d, state, bounds: Bounds, dtype):
        """(t_min, t_max, new_state) — overridden by the bounded variant."""
        return jnp.asarray(self.t_min, dtype), jnp.asarray(self.t_max, dtype), state

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds, max_iter: int):
        dtype = x.dtype
        c1 = jnp.asarray(self.c1, dtype)
        c2 = jnp.asarray(self.c2, dtype)
        delta = jnp.asarray(self.delta, dtype)

        t_min, t_max, state = self._t_bounds(x, d, state, bounds, dtype)

        f0 = ev.f
        g0d = vdot(ev.g, d)

        def phi(t):
            """phi(t) = f(x + t d), phi'(t) = g(x + t d) . d
            (``morethuente.rs:134-139``)."""
            ev_t = oracle(x + t * d)
            return ev_t.f, vdot(ev_t.g, d)

        def psi_of(phi_f, phi_g, t):
            """Auxiliary psi (``morethuente.rs:140-149``)."""
            return phi_f - f0 - c1 * t * g0d, phi_g - c1 * g0d

        # t = 1.0.max(t_min).min(t_max)  (morethuente.rs:176)
        t0 = rust_min(rust_max(jnp.asarray(1.0, dtype), t_min), t_max)
        cb = _trial_cb("MoreThuente")

        def cond(c):
            i, t, tl, tu, modified, int_conv, done = c
            return (~done) & (i < max_iter)

        def body(c):
            i, t, tl, tu, modified, int_conv, done = c

            phi_t_f, phi_t_g = phi(t)
            swc = strong_wolfe(c1, c2, f0, phi_t_f, g0d, phi_t_g, t)
            if self.approx_wolfe:
                awc = (
                    ((2.0 * c1 - 1.0) * g0d >= phi_t_g)
                    & (phi_t_g >= c2 * g0d)
                    & (phi_t_f <= f0 + jnp.asarray(self.aw_eps, dtype)
                       * jnp.abs(f0))
                    & (t > 0.0)
                )
                swc = swc | awc
            # return conditions checked in reference order (morethuente.rs:184-205)
            finish = swc | int_conv | (t == tl) | (t == tu)
            if cb is not None:   # per-trial events (morethuente.rs trace points)
                jax.debug.callback(cb, i, t, phi_t_f, finish)

            psi_t_f, psi_t_g = psi_of(phi_t_f, phi_t_g, t)
            # switch to modified updating permanently (morethuente.rs:212-215)
            modified = modified | ((psi_t_f <= 0.0) & (phi_t_g > 0.0))

            phi_tl_f, phi_tl_g = phi(tl)
            psi_tl_f, psi_tl_g = psi_of(phi_tl_f, phi_tl_g, tl)

            f_l = jnp.where(modified, phi_tl_f, psi_tl_f)
            g_l = jnp.where(modified, phi_tl_g, psi_tl_g)
            f_c = jnp.where(modified, phi_t_f, psi_t_f)
            g_c = jnp.where(modified, phi_t_g, psi_t_g)

            # trial value selection, section 4 of the paper
            # (morethuente.rs:228-287)
            case1 = f_c > f_l
            case2 = (~case1) & (g_c * g_l < 0.0)
            case3 = (~case1) & (~case2) & (jnp.abs(g_c) <= jnp.abs(g_l))
            case4 = ~(case1 | case2 | case3)

            tc = _cubic_minimizer(tl, t, f_l, f_c, g_l, g_c)
            tq = _quadratic_minimizer_1(tl, t, f_l, f_c, g_l)
            ts = _quadratic_minimizer_2(tl, t, g_l, g_c)

            t1 = jnp.where(jnp.abs(tc - tl) < jnp.abs(tq - tl), tc, 0.5 * (tq + tc))
            t2 = jnp.where(jnp.abs(tc - t) >= jnp.abs(ts - t), tc, ts)
            t_plus = jnp.where(jnp.abs(tc - t) < jnp.abs(ts - t), tc, ts)
            t3 = jnp.where(
                t > tl,
                rust_min(t_plus, t + delta * (tu - t)),
                rust_max(t_plus, t + delta * (tu - t)),
            )

            def t4_fn(_):
                # case 4 needs an extra oracle call at tu (morethuente.rs:275-287)
                phi_tu_f, phi_tu_g = phi(tu)
                psi_tu_f, psi_tu_g = psi_of(phi_tu_f, phi_tu_g, tu)
                f_u = jnp.where(modified, phi_tu_f, psi_tu_f)
                g_u = jnp.where(modified, phi_tu_g, psi_tu_g)
                return _cubic_minimizer(tu, t, f_c, f_u, g_c, g_u)

            # lax.cond: a plain jit skips the tu oracle call outside case 4;
            # under vmap it lowers to a select (all lanes pay it, lockstep).
            t4 = lax.cond(case4 & ~finish, t4_fn, lambda _: t, None)

            t_new = jnp.where(case1, t1, jnp.where(case2, t2, jnp.where(case3, t3, t4)))
            # clamp with Rust NaN-collapsing semantics (morethuente.rs:290)
            t_new = rust_clamp(t_new, t_min, t_max)
            if not self.reference_quirks:
                # force-progress safeguard (MINPACK dcsrch): with tu still
                # infinite (minimum not bracketed), the case-4 cubic is
                # inf-poisoned and the NaN-collapsing clamp lands the trial
                # exactly on t_min — a zero step the solver reads as
                # "iterate stopped moving".  A trial equal to an interval
                # endpoint cannot make progress: extrapolate while
                # unbracketed, bisect once bracketed.
                no_prog = (t_new == tl) | (t_new == tu) | ~jnp.isfinite(t_new)
                fallback = jnp.where(jnp.isfinite(tu), 0.5 * (tl + tu), 2.0 * t)
                t_new = jnp.where(no_prog, rust_clamp(fallback, t_min, t_max),
                                  t_new)

            # interval update: the values (f_l, f_c, g_c) belong to the
            # EVALUATED t, so the correct MT updating algorithm revises the
            # interval at t; the reference instead passes the NEXT trial
            # (morethuente.rs:293) — kept behind reference_quirks (see class
            # docstring for the failure mode)
            t_upd = t_new if self.reference_quirks else t
            tl_new, tu_new, conv_new = _update_interval(f_l, f_c, g_c, tl, t_upd, tu)

            keep = finish
            return (
                i + 1,
                jnp.where(keep, t, t_new),
                jnp.where(keep, tl, tl_new),
                jnp.where(keep, tu, tu_new),
                modified,
                jnp.where(keep, int_conv, conv_new),
                done | finish,
            )

        init = (
            jnp.int32(0),
            t0,
            t_min,
            t_max,
            jnp.asarray(False),
            jnp.asarray(False),
            jnp.asarray(False),
        )
        _, t, *_ = lax.while_loop(cond, body, init)
        return t, state


@dataclasses.dataclass(frozen=True)
class MoreThuenteB(MoreThuente):
    """Box-constrained More-Thuente (``morethuente_b.rs``): ``t_max`` is
    capped at the per-coordinate max feasible step to the box boundary
    ``min_i (bound_i - x_i)/d_i`` (``morethuente_b.rs:185-205``), and —
    mirroring the reference's mutation of ``self.t_max`` — the cap is a
    running minimum across line-search calls within one solve, carried in
    the line-search state."""

    def init_state(self, ev0):
        return jnp.asarray(self.t_max, ev0.f.dtype)

    def _t_bounds(self, x, d, state, bounds: Bounds, dtype):
        assert bounds is not None, "MoreThuenteB requires bounds"
        lower, upper = bounds
        pos = (upper - x) / d
        neg = (lower - x) / d
        terms = jnp.where(d > 0.0, pos, jnp.where(d < 0.0, neg, jnp.inf))
        # Rust's min-fold skips NaN terms (morethuente_b.rs:185-201)
        terms = jnp.where(jnp.isnan(terms), jnp.inf, terms)
        t_max_candidate = jnp.min(terms)
        running = jnp.minimum(state, t_max_candidate)
        return jnp.asarray(self.t_min, dtype), running, running
