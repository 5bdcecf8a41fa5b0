"""f32x2 precision stage: certify strict tolerances for f32 solves.

The reference solves in f64 end-to-end (``/root/reference/src/number.rs:3``),
so a ``grad_tol = 1e-6`` stationarity certificate is routine.  Plain f32
solves hit a ~2e-4 certification wall: f32 gradient evaluation carries
cancellation noise far above 1e-6, and the f32 grid itself quantizes
attainable gradients (|g| jumps in steps of ~L*eps*|x|).  This module
closes that gap with emulated f64 for f32 inputs:

  1. run the normal fast f32 path (lockstep XLA) to its certification
     floor — the bulk of the work at full speed;
  2. POLISH the exits with a double-float BFGS: iterates, objective values,
     gradients, and Wolfe/Armijo comparisons all flow as (hi, lo) f32
     pairs (core/df.py) with the oracle evaluated by the f32x2 jaxpr
     interpreter (core/df_interp.py).

Near the minimizer the polish is superlinear, so certification costs a
handful of df iterations per lane — the expensive arithmetic (~10-20 f32
ops per op, all elementwise) runs only where plain f32 cannot finish the job.
Lanes that already certify exit the loop immediately (per-lane masks, same
lockstep dataflow as the main driver).

Exposed directly (:func:`df_polish_minimize`, usable as a standalone
full-df solve from any x0) and through the front end's
``precision="f32x2"`` option (frontend.py).  Semantics cited against the
reference template loop ``ls_solver.rs:66-111`` and BFGS update
``quasi_newton/bfgs.rs:64-110``; everything runs under jit/vmap.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from optimization_solvers_tpu.core import df
from optimization_solvers_tpu.core.df import DF
from optimization_solvers_tpu.core.df_interp import df_value, df_value_and_grad
from optimization_solvers_tpu.core.numerics import dot as numerics_dot
from optimization_solvers_tpu.core.numerics import matvec
from optimization_solvers_tpu.core.types import SolveResult, Status


class DFPolishResult(NamedTuple):
    """Full-precision polish result: ``x`` as a df pair plus the standard
    SolveResult fields (hi parts).  ``to_solve_result()`` flattens for the
    front end."""

    x: DF                   # (B, n) df iterate
    f: jax.Array            # (B,) objective hi
    g: jax.Array            # (B, n) gradient hi
    iterations: jax.Array   # (B,) polish iterations taken
    status: jax.Array       # (B,) Status codes
    pg_norm: jax.Array      # (B,) df-accurate projected-gradient inf norm

    def to_solve_result(self) -> SolveResult:
        # x_lo rides along: the pg_norm certificate holds at x + x_lo (the
        # df pair), NOT at the f32-rounded x alone — re-evaluating the
        # gradient at just x costs ~L*eps*|x| of stationarity (measured
        # ~7e-5 on Rosenbrock-100, round 5)
        return SolveResult(self.x.hi, self.f, self.g, self.iterations,
                           self.status, pg_norm=self.pg_norm,
                           x_lo=self.x.lo)


def _pg_inf_norm(x: DF, g: DF, lower, upper):
    """df projected-gradient infinity norm: ``||x - P(x - g)||_inf``
    (unbounded: ``||g||_inf``) — the same sbgnrm stationarity measure the
    rest of the suite certifies with (core.numerics.batched_pg_inf_norm),
    at df accuracy.  The hi parts are the correctly-rounded f32 values of
    the df quantities, so comparing them against the tolerance is exact to
    one f32 ulp of the TRUE gradient — vs the ~2e-4 cancellation noise a
    plain f32 evaluation carries."""
    if lower is None:
        return jnp.max(jnp.abs(g.hi))
    step = df.sub(x, g)
    proj = df.clip(step, df.from_f32(lower), df.from_f32(upper))
    d = df.sub(x, proj)
    return jnp.max(jnp.abs(d.hi))


def _single_polish(vg, val, n, grad_tol, max_iter, max_iter_ls,
                   lower, upper, c1=1e-4, memory=None):
    """Build the single-instance df quasi-Newton loop (vmapped by the
    caller).

    Direction engine in PLAIN f32 — direction quality only needs a few
    digits; all accuracy-bearing quantities (iterate update, y = g+ - g,
    s.y curvature, Armijo test, convergence) are df:

    * ``memory is None``: dense inverse-BFGS (``bfgs.rs:88-110``
      semantics), O(n^2) state — the default up to moderate n.
    * ``memory = m``: L-BFGS two-loop recursion over the last m df-exact
      (s, y) pairs, O(m*n) state — the large-n engine (an (n, n) H at
      n = 10k would be 400 MB/lane).  Invalid slots carry rho = 0, which
      zeroes their two-loop contributions without masks.

    Both engines apply the Nocedal-Wright 6.20 scaling and skip updates
    when df s.y <= 0."""
    bounded = lower is not None
    lbfgs = memory is not None
    m_hist = int(memory) if lbfgs else 0

    def eval_vg(x: DF):
        fv, gv = vg(x)
        return fv, gv

    # ---- direction engines (f32 state) --------------------------------
    if lbfgs:
        def engine_init():
            return (jnp.zeros((m_hist, n), jnp.float32),   # S
                    jnp.zeros((m_hist, n), jnp.float32),   # Y
                    jnp.zeros((m_hist,), jnp.float32),     # rho (0 = empty)
                    jnp.float32(1.0))                      # gamma

        def engine_direction(st, g32):
            S, Y, rho, gamma = st
            q = g32
            alphas = []
            for i in range(m_hist - 1, -1, -1):
                a = rho[i] * numerics_dot(S[i], q)
                q = q - a * Y[i]
                alphas.append(a)
            q = gamma * q
            for i in range(m_hist):
                b = rho[i] * numerics_dot(Y[i], q)
                q = q + S[i] * (alphas[m_hist - 1 - i] - b)
            return -q

        def engine_reset(st, keep):
            S, Y, rho, gamma = st
            return (S, Y, jnp.where(keep, rho, 0.0),
                    jnp.where(keep, gamma, 1.0))

        def engine_update(st, s32, y32, sy32, yy32, good, first):
            S, Y, rho, gamma = st
            S_n = jnp.concatenate([S[1:], s32[None]], axis=0)
            Y_n = jnp.concatenate([Y[1:], y32[None]], axis=0)
            r_new = 1.0 / jnp.where(sy32 == 0, 1.0, sy32)
            rho_n = jnp.concatenate([rho[1:], jnp.full((1,), r_new,
                                                       jnp.float32)])
            g_n = jnp.where(yy32 > 0.0,
                            sy32 / jnp.where(yy32 == 0, 1.0, yy32), gamma)
            return (jnp.where(good, S_n, S), jnp.where(good, Y_n, Y),
                    jnp.where(good, rho_n, rho),
                    jnp.where(good, g_n, gamma))
    else:
        def engine_init():
            return jnp.eye(n, dtype=jnp.float32)

        def engine_direction(H, g32):
            # true-f32 einsum: an f32 `@` may run in TF32 (core.numerics)
            return -matvec(H, g32)

        def engine_reset(H, keep):
            return jnp.where(keep, H, jnp.eye(n, dtype=jnp.float32))

        def engine_update(H, s32, y32, sy32, yy32, good, first):
            # first good pair: H0 = (s.y / y.y) I (Nocedal-Wright 6.20)
            gamma = jnp.where(good & first & (yy32 > 0.0),
                              sy32 / jnp.where(yy32 == 0, 1.0, yy32), 1.0)
            H = H * gamma
            rho = jnp.where(good,
                            1.0 / jnp.where(sy32 == 0, 1.0, sy32), 0.0)
            Hy = matvec(H, y32)
            sHy = jnp.outer(s32, Hy)
            H_new = (H - rho * (sHy + sHy.T)
                     + (rho * rho * numerics_dot(y32, Hy) + rho)
                     * jnp.outer(s32, s32))
            return jnp.where(good, H_new, H)

    def cond(c):
        x, fv, g, est, k, done = c
        return (~done) & (k < max_iter)

    def body(c):
        x, fv, g, est, k, done = c
        first = k == 0
        with df.launder_constants(df.runtime_true(x.hi)):
            # direction in f32 off the df gradient's hi part
            g32 = g.hi
            if bounded:
                # two-metric projection: coordinates sitting ON a bound
                # with the gradient pushing outward are ACTIVE — excluded
                # from the quasi-Newton metric (the curvature model mixes
                # them into free coordinates and stalls the projected
                # direction at ~tol; measured on the low-curvature bounded
                # LSE class).  df.clip sets x.hi exactly to the bound, so
                # the activity test is exact equality.
                active_set = (((x.hi <= lower) & (g32 > 0.0))
                              | ((x.hi >= upper) & (g32 < 0.0)))
                g_eff = jnp.where(active_set, 0.0, g32)
                d = engine_direction(est, g_eff)
                d = jnp.where(active_set, 0.0, d)
                # projected path: clip the target, direction toward the
                # projected point (projected_gradient_descent.rs:57)
                tgt = jnp.clip(x.hi + d, lower, upper)
                d = tgt - x.hi
            else:
                d = engine_direction(est, g32)
            gd = df.dot(g, df.from_f32(d))
            descent = gd.hi < 0.0
            # non-descent (curvature model gone bad): steepest restart
            d_sd = -g32 if not bounded else (
                jnp.clip(x.hi - g32, lower, upper) - x.hi)
            d = jnp.where(descent, d, d_sd)
            est = engine_reset(est, descent)
            gd = df.where(descent, gd, df.dot(g, df.from_f32(d)))

            d_df = df.from_f32(d)

            # df backtracking Armijo: f(x + t d) <= f + c1 t g.d, t = 2^-i
            def ls_body(s):
                t, ft, xt, i, ok = s
                t_new = t * 0.5
                xt_new = df.add(x, df.mul_f(d_df, t_new))
                if bounded:
                    xt_new = df.clip(xt_new, df.from_f32(lower),
                                     df.from_f32(upper))
                ft_new = eval_f(xt_new)
                armijo = df.le(ft_new,
                               df.add(fv, df.mul_f(gd, c1 * t_new)))
                return (t_new, ft_new, xt_new, i + 1, armijo)

            def ls_cond(s):
                t, ft, xt, i, ok = s
                return (~ok) & (i < max_iter_ls)

            x1 = df.add(x, d_df) if not bounded else df.clip(
                df.add(x, d_df), df.from_f32(lower), df.from_f32(upper))
            f1 = eval_f(x1)
            ok0 = df.le(f1, df.add(fv, df.mul_f(gd, c1)))
            t, ft, xt, _, ls_ok = lax.while_loop(
                ls_cond, ls_body,
                (jnp.float32(1.0), f1, x1, jnp.int32(0), ok0))

            f_new, g_new = eval_vg(xt)
            # df secant pair: the cancellation in y = g+ - g is EXACT here
            s_df = df.sub(xt, x)
            y_df = df.sub(g_new, g)
            sy = df.dot(s_df, y_df)
            yy = df.dot(y_df, y_df)
            s32 = s_df.hi + s_df.lo
            y32 = y_df.hi + y_df.lo
            good = (sy.hi > 0.0) & ls_ok
            est = engine_update(est, s32, y32, sy.hi, yy.hi, good, first)

            pg = _pg_inf_norm(xt, g_new, lower, upper)
            conv = pg < grad_tol
            bad = ~jnp.isfinite(f_new.hi)
            # a failed line search at a non-certified point cannot make
            # further progress -> stop (status resolved at exit)
            done_new = conv | bad | ~ls_ok
            return (xt, f_new, g_new, est, k + 1, done_new)

    def eval_f(x: DF):
        # value-only oracle for the Armijo loop (grad skipped, same
        # cost-saving the main driver's value path gives Armijo searches)
        return val(x)

    return cond, body, engine_init


@functools.partial(
    jax.jit,
    static_argnames=("f", "n", "grad_tol", "max_iter",
                     "max_iter_ls", "bounded", "memory"))
def _polish_jit(f, data, x0_hi, x0_lo, n, grad_tol, max_iter,
                max_iter_ls, lower, upper, bounded, memory):
    vg1 = df_value_and_grad(f, jnp.zeros(n, jnp.float32), data=data)
    val1 = df_value(f, jnp.zeros(n, jnp.float32), data=data)

    lo1 = lower if bounded else None
    up1 = upper if bounded else None

    def solve_one(xh, xl, lo_i, up_i):
        cond, body, engine_init = _single_polish(
            vg1, val1, n, grad_tol, max_iter, max_iter_ls, lo_i, up_i,
            memory=memory)
        x0 = DF(xh, xl)
        if bounded:
            x0 = df.clip(x0, df.from_f32(lo_i), df.from_f32(up_i))
        with df.launder_constants(df.runtime_true(xh)):
            f0, g0 = vg1(x0)
            pg0 = _pg_inf_norm(x0, g0, lo_i, up_i)
        done0 = (pg0 < grad_tol) | ~jnp.isfinite(f0.hi)
        x, fv, g, _, k, done = lax.while_loop(
            cond, body, (x0, f0, g0, engine_init(), jnp.int32(0), done0))
        with df.launder_constants(df.runtime_true(x.hi)):
            pg = _pg_inf_norm(x, g, lo_i, up_i)
        status = jnp.where(
            ~jnp.isfinite(fv.hi), jnp.int32(Status.OUT_OF_DOMAIN),
            jnp.where(pg < grad_tol, jnp.int32(Status.CONVERGED),
                      jnp.where(k >= max_iter,
                                jnp.int32(Status.MAX_ITER_REACHED),
                                jnp.int32(Status.STALLED))))
        return x, fv.hi, g.hi, k, status, pg

    if bounded:
        in_axes = (0, 0, 0 if jnp.ndim(lower) == 2 else None,
                   0 if jnp.ndim(upper) == 2 else None)
        xs = (x0_hi, x0_lo, lower, upper)
    else:
        in_axes = (0, 0, None, None)
        xs = (x0_hi, x0_lo, None, None)
    x, fv, g, k, status, pg = jax.vmap(solve_one, in_axes=in_axes)(*xs)
    return DFPolishResult(x, fv, g, k, status, pg)


def df_polish_minimize(f, x0, *, data=(), x0_lo=None, bounds=None,
                       grad_tol=1e-6, max_iter=200,
                       max_iter_ls=30, memory="auto") -> DFPolishResult:
    """Batched double-float BFGS solve/polish from ``x0``.

    ``f`` is a raw scalar objective ``f(x, *data)``; it is re-traced and interpreted in f32x2, so only
    primitives with df rules are supported (core/df_interp.py — loud
    failure otherwise).  ``x0`` is (B, n) f32 (a 1-D x0 is promoted to a
    batch of one); ``x0_lo`` optionally carries the low words of a df
    starting point.  ``bounds=(lower, upper)`` activates the projected
    variant ((n,) shared or (B, n) per-lane).

    ``memory`` selects the direction engine: ``"auto"`` (dense inverse-
    BFGS up to n = 512, L-BFGS(10) beyond — an (n, n) H at large n would
    be O(n^2) memory per lane), ``None`` forces dense, an int forces
    L-BFGS with that history length.

    Usable two ways: as a *polish* from an f32 solver's exit (the
    ``precision="f32x2"`` path — lanes already certified exit at zero
    cost), or as a standalone df solve from any starting point (slower:
    every oracle op costs ~10-20 elementwise f32 ops)."""
    x0 = jnp.asarray(x0, jnp.float32)
    single = x0.ndim == 1
    if single:
        x0 = x0[None]
    B, n = x0.shape
    x0_lo = (jnp.zeros_like(x0) if x0_lo is None
             else jnp.asarray(x0_lo, jnp.float32).reshape(x0.shape))
    data = tuple(jnp.asarray(c) for c in data)
    data = tuple(c.astype(jnp.float32)
                 if jnp.issubdtype(c.dtype, jnp.floating) else c
                 for c in data)
    bounded = bounds is not None
    if bounded:
        lower = jnp.asarray(bounds[0], jnp.float32)
        upper = jnp.asarray(bounds[1], jnp.float32)
        if lower.ndim == 0:
            lower = jnp.full((n,), lower, jnp.float32)
        if upper.ndim == 0:
            upper = jnp.full((n,), upper, jnp.float32)
    else:
        lower = upper = jnp.zeros((0,), jnp.float32)  # placeholder operand
    if memory == "auto":
        memory = None if n <= 512 else 10
    res = _polish_jit(f, data, x0, x0_lo, n, float(grad_tol),
                      int(max_iter), int(max_iter_ls), lower, upper,
                      bounded, None if memory is None else int(memory))
    if single:
        res = jax.tree.map(lambda a: a[0], res)
        res = DFPolishResult(*res)
    return res
