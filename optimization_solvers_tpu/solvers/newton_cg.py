"""Truncated Newton-CG solver: matrix-free second order through the
general XLA path.

Algorithm (a batched extension of the reference's Newton family,
``/root/reference/src/newton/projected_newton.rs:64-80``, generalized to
matrix-free form — no (n, n) Hessian is ever materialized):

  * outer loop: projected-gradient stopping test (``pgtol``) + relative
    f-decrease stall test (``factr``, dtype-relative — the reference's
    ``setulb_`` semantics, ``quasi_newton/lbfgsb.rs:139-145``);
  * two-metric projection (Bertsekas): coordinates epsilon-active at a
    bound take the steepest-descent direction, free coordinates take the
    CG-approximate Newton direction;
  * inner CG on the free subspace with the Steihaug negative-curvature
    exit and the Eisenstat-Walker forcing term
    ``||r|| <= min(0.5, sqrt(||g||)) ||g||``;
  * projected backtracking Armijo on ``P(x + t d)`` with the
    ``g . (P(x + t d) - x)`` decrease model
    (``line_search/backtracking_b.rs:24-50``).

Hessian-vector products come from the oracle's ``hvp`` seam
(forward-over-reverse AD, built by :func:`core.oracle.make_oracle`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from optimization_solvers_tpu.core.numerics import infinity_norm
from optimization_solvers_tpu.core.oracle import ensure_oracle
from optimization_solvers_tpu.core.types import SolveResult, Status


@dataclasses.dataclass(frozen=True)
class NewtonCGConfig:
    pgtol: float = 1e-5
    factr: float = 1e7
    max_iter: int = 200
    cg_max: int = 32
    max_iter_ls: int = 25
    c1: float = 1e-4


class _Carry(NamedTuple):
    x: jax.Array
    f: jax.Array
    g: jax.Array
    f_prev: jax.Array
    k: jax.Array


def make_newton_cg_step(oracle, lower, upper,
                        config: NewtonCGConfig = NewtonCGConfig()):
    """Build ``(init_fn, keep_going_fn, step_fn, result_fn)`` for the
    Newton-CG loop (the :func:`solvers.driver.make_step` seam shape plus a
    result finalizer, so checkpoints and the lockstep batcher apply
    unchanged)."""
    oracle = ensure_oracle(oracle)
    hvp = getattr(oracle, "hvp", None)
    if hvp is None:
        raise ValueError(
            "Newton-CG needs Hessian-vector products: build the oracle "
            "with make_oracle(f) (which derives hvp by forward-over-"
            "reverse AD) or attach an `hvp(x, v)` callable to the oracle")
    cfg = config

    def pg_inf_norm(x, g):
        pg = x - jnp.clip(x - g, lower, upper)
        return jnp.max(jnp.abs(pg))

    def init_fn(x0: jax.Array) -> _Carry:
        x0 = jnp.clip(x0, lower, upper)
        ev = oracle(x0)
        return _Carry(x0, ev.f, ev.g,
                      jnp.asarray(jnp.inf, ev.f.dtype), jnp.int32(0))

    def converged(c: _Carry):
        dtype = c.f.dtype
        f_rtol = cfg.factr * float(jnp.finfo(dtype).eps)
        done = pg_inf_norm(c.x, c.g) <= cfg.pgtol
        fmax = jnp.maximum(jnp.maximum(jnp.abs(c.f), jnp.abs(c.f_prev)), 1.0)
        return done | (
            jnp.isfinite(c.f_prev) & ((c.f_prev - c.f) <= f_rtol * fmax)
        )

    def keep_going_fn(c: _Carry):
        return jnp.isfinite(c.f) & ~converged(c)

    def _direction(x, g):
        dtype = x.dtype
        eps = float(jnp.finfo(dtype).eps)
        pgn = pg_inf_norm(x, g)
        # epsilon-active bound coordinates (two-metric projection)
        w = jnp.minimum(pgn, 1e-2)
        bound_act = ((x - lower <= w) & (g > 0.0)) | (
            (upper - x <= w) & (g < 0.0))
        free = ~bound_act

        gF = jnp.where(free, g, 0.0)
        gn2 = jnp.sum(gF * gF)
        gn = jnp.sqrt(gn2)
        eta = jnp.minimum(jnp.sqrt(jnp.maximum(gn, 0.0)),
                          jnp.asarray(0.5, dtype))
        rtol2 = (eta * gn) ** 2

        def cg_cond(s):
            i, d, r, p, rr, done, steps = s
            return (i < cfg.cg_max) & ~done

        def cg_body(s):
            i, d, r, p, rr, done, steps = s
            q = jnp.where(free, hvp(x, jnp.where(free, p, 0.0)), 0.0)
            pq = jnp.sum(p * q)
            pp = jnp.sum(p * p)
            negc = pq <= eps * pp
            first = steps == 0
            d = jnp.where(negc & first, -gF, d)
            step_ok = ~negc
            alpha = jnp.where(step_ok, rr / jnp.where(negc, 1.0, pq), 0.0)
            d = d + alpha * p
            r = r + alpha * q
            rr_new = jnp.sum(r * r)
            hit_tol = step_ok & (rr_new <= rtol2)
            beta = jnp.where(step_ok, rr_new / jnp.maximum(rr, eps), 0.0)
            p = jnp.where(step_ok, -r + beta * p, p)
            rr = jnp.where(step_ok, rr_new, rr)
            done = negc | hit_tol
            return (i + 1, d, r, p, rr, done,
                    steps + step_ok.astype(jnp.int32))

        d0 = jnp.zeros_like(x)
        init = (jnp.int32(0), d0, gF, -gF, gn2, gn2 <= rtol2, jnp.int32(0))
        _, d, _, _, _, _, _ = lax.while_loop(cg_cond, cg_body, init)

        # epsilon-active coordinates move along -g; zero-direction
        # safeguard falls back to the full negative gradient
        d = jnp.where(free, d, -g)
        return jnp.where(jnp.sum(d * d) > 0.0, d, -g)

    def _line_search(x, f0, g, d):
        dtype = x.dtype

        def cond(s):
            i, t, done = s
            return (i < cfg.max_iter_ls) & ~done

        def body(s):
            i, t, done = s
            xt = jnp.clip(x + t * d, lower, upper)
            ft = oracle.value(xt)
            gstep = jnp.sum(g * (xt - x))
            ok = (ft <= f0 + cfg.c1 * gstep) & jnp.isfinite(ft)
            return (i + 1, jnp.where(ok, t, t * 0.5), ok)

        _, t, _ = lax.while_loop(
            cond, body, (jnp.int32(0), jnp.asarray(1.0, dtype),
                         jnp.asarray(False)))
        return t

    def step_fn(c: _Carry) -> _Carry:
        d = _direction(c.x, c.g)
        t = _line_search(c.x, c.f, c.g, d)
        x_new = jnp.clip(c.x + t * d, lower, upper)
        ev = oracle(x_new)
        ok = jnp.isfinite(ev.f) & jnp.all(jnp.isfinite(x_new))
        x_new = jnp.where(ok, x_new, c.x)
        f_new = jnp.where(ok, ev.f, c.f)
        g_new = jnp.where(ok, ev.g, c.g)
        # f_prev advances only on ACCEPTED steps: a rejected nonfinite
        # trial must not arm the factr stall test with f_prev == f
        f_prev = jnp.where(ok, c.f, c.f_prev)
        return _Carry(x_new, f_new, g_new, f_prev, c.k + 1)

    def result_fn(final: _Carry) -> SolveResult:
        # recompute convergence on the final state, so a lane that lands
        # converged exactly at the budget reports CONVERGED
        finite = jnp.isfinite(final.f)
        status = jnp.where(
            converged(final) & finite,
            jnp.int32(Status.CONVERGED),
            jnp.where(~finite, jnp.int32(Status.OUT_OF_DOMAIN),
                      jnp.int32(Status.MAX_ITER_REACHED)),
        )
        from optimization_solvers_tpu.core.numerics import (
            batched_pg_inf_norm)

        pg = batched_pg_inf_norm(final.x, final.g, lower, upper)
        return SolveResult(final.x, final.f, final.g, final.k, status,
                           pg_norm=pg)

    return init_fn, keep_going_fn, step_fn, result_fn


def newton_cg_minimize(
    oracle,
    x0: jax.Array,
    lower: jax.Array,
    upper: jax.Array,
    config: NewtonCGConfig = NewtonCGConfig(),
) -> SolveResult:
    """Minimize with box-constrained truncated Newton-CG; single instance
    (wrap in ``jax.jit``).  Matrix-free: scales to large ``n``."""
    cfg = config
    init_fn, keep_going_fn, step_fn, result_fn = make_newton_cg_step(
        oracle, lower, upper, cfg)

    def cond(c: _Carry):
        return (c.k < cfg.max_iter) & keep_going_fn(c)

    final = lax.while_loop(cond, step_fn, init_fn(x0))
    return result_fn(final)


@functools.partial(jax.jit, static_argnames=("oracle", "config"))
def newton_cg_batch_minimize(
    oracle,
    x0: jax.Array,                  # (B, n)
    lower: jax.Array,
    upper: jax.Array,
    config: NewtonCGConfig = NewtonCGConfig(),
) -> SolveResult:
    """Lockstep batched Newton-CG (same design as
    :func:`solvers.lbfgsb.lbfgsb_batch_minimize`); jitted at the boundary."""
    from optimization_solvers_tpu.solvers.driver import lockstep_loop

    cfg = config
    init_fn, keep_going_fn, step_fn, result_fn = make_newton_cg_step(
        oracle, lower, upper, cfg)
    final = lockstep_loop(init_fn, keep_going_fn, step_fn, x0, cfg.max_iter)
    return jax.vmap(result_fn)(final)
