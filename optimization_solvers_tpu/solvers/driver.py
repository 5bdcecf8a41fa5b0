"""Generic solver driver: the reference ``LineSearchSolver::minimize``
template loop (``/root/reference/src/ls_solver.rs:23-112``) inverted into a
device-resident ``lax.while_loop``.

Key redesign vs. the reference:
  * The per-iteration oracle evaluation at the top of the loop
    (``ls_solver.rs:79``) and the *extra* post-step oracle call made by
    quasi-Newton/SPG/projected-Newton solvers to form ``y = g+ - g``
    (e.g. ``bfgs.rs:98``, ``spg.rs:130``) are the same evaluation one
    iteration apart — the driver computes it once per iteration and carries
    it, halving oracle work for those families.
  * Convergence, domain, and iteration-budget checks live in the while-loop
    *condition*, so a converged instance takes zero extra steps.  Status
    precedence on exit matches the reference: the loop guard ``k < max_iter``
    is tested first (``ls_solver.rs:78``), then the NaN/inf domain check
    (``ls_solver.rs:37-40``), then per-solver convergence (``ls_solver.rs:81``).
  * Everything is a pytree of fixed shape, so the whole ``minimize`` batches
    under ``vmap`` (JAX's while-loop batching keeps per-lane predicates:
    converged lanes freeze while the rest keep stepping) and shards under
    ``pjit`` / ``shard_map`` over a device mesh.

The loop pieces are exposed via :func:`make_step` (init / cond / body) so
multi-chip harnesses and benchmarks can jit a single solver step directly.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from optimization_solvers_tpu.core.oracle import ensure_oracle
from optimization_solvers_tpu.core.types import FuncEval, SolveResult, Status
from optimization_solvers_tpu.linesearch.base import Bounds


class SolverCarry(NamedTuple):
    """While-loop carry: iterate, its evaluation, iteration count, method
    state, line-search state."""

    x: jax.Array
    ev: FuncEval
    k: jax.Array
    mstate: Any
    ls_state: Any


def make_step(method, line_search, oracle, *, bounds: Bounds = None,
              max_iter_ls: int = 100, callback=None):
    """Build ``(init_fn, keep_going_fn, step_fn)`` for the solver loop.

    ``init_fn(x0) -> SolverCarry`` (projects x0 for bounded methods and
    seeds method/line-search state); ``keep_going_fn(carry) -> bool`` is the
    domain + convergence predicate (without the iteration budget);
    ``step_fn(carry) -> carry`` performs one full solver iteration
    (direction -> line search -> iterate update -> state refresh).

    Per-iteration observability (reference ``ls_solver.rs:82-109``): when
    ``OST_LOG=debug`` (or the package logger is configured at DEBUG) and no
    explicit ``callback`` is given, every iteration emits a
    ``k / f / ||g|| / t`` event through the tracing stack via
    ``jax.debug.callback``, targeted per solver component.  The check
    happens at trace time, so tracing is zero-cost when off.
    """
    oracle = ensure_oracle(oracle)
    needs_h = bool(getattr(method, "needs_hessian", False))

    def _strip(ev: FuncEval) -> FuncEval:
        # The dense Hessian never rides the loop carry: an (n, n) buffer in
        # the while-loop carry is select-merged every iteration, and under
        # ``vmap`` an unbatched (constant) Hessian would be broadcast to a
        # (B, n, n) carried buffer.  Hessian-consuming directions
        # re-evaluate the oracle at the current iterate instead; XLA
        # dead-code-eliminates the unused Hessian computation here and
        # hoists loop-invariant Hessians out of the loop.
        if ev.hessian is not None:
            return ev._replace(hessian=None)
        return ev

    trace_cb = None
    if callback is None:
        from optimization_solvers_tpu.utils import telemetry

        if telemetry.debug_enabled():
            trace_cb = telemetry.iteration_tracer(
                f"solver.{type(method).__name__}."
                f"{type(line_search).__name__}")

    def init_fn(x0: jax.Array) -> SolverCarry:
        x0 = method.prepare_x0(x0, bounds)
        ev0 = oracle(x0)
        return SolverCarry(
            x0, _strip(ev0), jnp.int32(0),
            method.init(x0, ev0, bounds),
            line_search.init_state(ev0),
        )

    def keep_going_fn(c: SolverCarry):
        in_domain = jnp.isfinite(c.ev.f)
        return in_domain & ~method.converged(c.mstate, c.x, c.ev, bounds)

    def step_fn(c: SolverCarry) -> SolverCarry:
        # Hessian-consuming directions get a fresh full evaluation at the
        # carried iterate (the carry itself is Hessian-free, see _strip);
        # the duplicate value/grad work is dead-code-eliminated by XLA
        ev_dir = oracle(c.x) if needs_h else c.ev
        d, mstate = method.direction(c.mstate, c.x, ev_dir, bounds)
        # step_len_ev returns the accepted iterate's evaluation so searches
        # that already evaluated it (dcsrch, Hager-Zhang) skip the duplicate
        # oracle call the reference template pays (ls_solver.rs:93-99)
        t, ls_state, x_new, ev_new = line_search.step_len_ev(
            oracle, c.x, c.ev, d, c.ls_state, bounds, max_iter_ls
        )
        ev_new = _strip(ev_new)
        # ev_dir (not the stripped carry) so Hessian-consuming post_steps
        # (SPN precond_bb) see the same full evaluation direction() did
        mstate = method.post_step(mstate, c.x, ev_dir, d, t, x_new, ev_new, bounds)
        if callback is not None:
            # 1-based completed-iteration count, consistent with the
            # telemetry tracer and the reference's per-iteration events
            # (ls_solver.rs:82-109)
            jax.debug.callback(callback, c.k + 1, x_new, ev_new.f)
        elif trace_cb is not None:
            from optimization_solvers_tpu.core.numerics import infinity_norm

            jax.debug.callback(
                trace_cb, c.k + 1, ev_new.f, infinity_norm(ev_new.g), t)
        return SolverCarry(x_new, ev_new, c.k + 1, mstate, ls_state)

    return init_fn, keep_going_fn, step_fn


def _result(final: SolverCarry, max_iter: int,
            bounds: Bounds = None, method=None) -> SolveResult:
    status = jnp.where(
        final.k >= max_iter,
        jnp.int32(Status.MAX_ITER_REACHED),
        jnp.where(
            ~jnp.isfinite(final.ev.f),
            jnp.int32(Status.OUT_OF_DOMAIN),
            jnp.int32(Status.CONVERGED),
        ),
    )
    pg = _pg_norm(final.x, final.ev.g, bounds)
    status = apply_stall_status(status, method, final.x, final.ev.f,
                                final.ev.g, pg, bounds)
    return SolveResult(final.x, final.ev.f, final.ev.g, final.k, status,
                       pg_norm=pg)


def apply_stall_status(status, method, x, f, g, pg_norm, bounds):
    """Re-label CONVERGED lanes as :data:`Status.STALLED` where the method's
    ``stall_status`` hook says the exit was a stall at a non-KKT point
    (quasi-Newton s/y-too-close, ``bfgs_b.rs:92-104``).  Methods without the
    hook (every non-QN family) are untouched; precedence: only CONVERGED is
    ever re-labeled (MAX_ITER / OUT_OF_DOMAIN / ABNORMAL win)."""
    hook = getattr(method, "stall_status", None)
    if hook is None:
        return status
    stall = hook(x, f, g, pg_norm, bounds)
    return jnp.where((status == Status.CONVERGED) & stall,
                     jnp.int32(Status.STALLED), status)


def _pg_norm(x, g, bounds: Bounds):
    """Exit-time stationarity measure for SolveResult.pg_norm: projected-
    gradient infinity norm (plain ``||g||_inf`` unbounded) — the shared
    sbgnrm helper in core.numerics, so the metric has ONE definition."""
    from optimization_solvers_tpu.core.numerics import batched_pg_inf_norm

    if bounds is None:
        return batched_pg_inf_norm(x, g)
    return batched_pg_inf_norm(x, g, bounds[0], bounds[1])


def minimize(
    method,
    line_search,
    oracle,
    x0: jax.Array,
    *,
    bounds: Bounds = None,
    max_iter: int = 1000,
    max_iter_ls: int = 100,
    callback=None,
) -> SolveResult:
    """Minimize ``oracle`` from ``x0``; the universal entry point
    (reference ``ls_solver.rs:66-111``).

    ``method`` is a solver config (direction rule + convergence test +
    post-step state update), ``line_search`` a
    :class:`~optimization_solvers_tpu.linesearch.LineSearch`.  ``callback``,
    if given, is a host function ``(k, x, f) -> None`` invoked per iteration
    via ``jax.debug.callback`` (the reference's per-iteration callback hook,
    ``ls_solver.rs:105-107``) — it stays off the hot path when ``None``.

    Returns a :class:`SolveResult`; wrap in ``jax.jit`` / ``jax.vmap`` freely.
    """
    init_fn, keep_going_fn, step_fn = make_step(
        method, line_search, oracle,
        bounds=bounds, max_iter_ls=max_iter_ls, callback=callback,
    )

    def cond(c: SolverCarry):
        return (c.k < max_iter) & keep_going_fn(c)

    final = lax.while_loop(cond, step_fn, init_fn(x0))
    return _result(final, max_iter, bounds, method)


def minimize_recorded(
    method,
    line_search,
    oracle,
    x0: jax.Array,
    *,
    bounds: Bounds = None,
    max_iter: int = 1000,
    max_iter_ls: int = 100,
):
    """Like :func:`minimize` but also returns the full iterate trajectory
    ``(max_iter + 1, n)`` and per-iteration objective values — the
    device-resident equivalent of the reference's per-iteration callback
    collecting iterates for plotting
    (``examples/quadratic_with_plots.rs:26-29``).

    Implemented as a ``lax.scan`` over exactly ``max_iter`` steps with
    per-step freeze masks (a converged instance repeats its final iterate),
    so the trajectory has static shape and the whole thing batches under
    ``vmap``.  Returns ``(SolveResult, xs, fs)``.
    """
    init_fn, keep_going_fn, step_fn = make_step(
        method, line_search, oracle, bounds=bounds, max_iter_ls=max_iter_ls
    )
    c0 = init_fn(x0)

    def scan_body(c, _):
        active = keep_going_fn(c)
        stepped = step_fn(c)
        c_new = jax.tree.map(lambda old, new: jnp.where(active, new, old), c, stepped)
        return c_new, (c_new.x, c_new.ev.f)

    final, (xs, fs) = lax.scan(scan_body, c0, None, length=max_iter)
    xs = jnp.concatenate([c0.x[None], xs], axis=0)
    fs = jnp.concatenate([c0.ev.f[None], fs], axis=0)
    return _result(final, max_iter, bounds, method), xs, fs


def lockstep_loop(init_fn, keep_going_fn, step_fn, x0, max_iter: int,
                  unroll: int = 1):
    """Run a solver loop over a leading batch axis in LOCKSTEP: one global
    ``lax.while_loop`` whose body is the vmapped ``step_fn``, with lanes
    whose ``keep_going_fn`` went false frozen via per-lane masks.  Returns
    the final batched carry.  Shared scaffold for :func:`batch_minimize`,
    :func:`solvers.lbfgsb.lbfgsb_batch_minimize`, and
    :func:`solvers.newton_cg.newton_cg_batch_minimize`.

    ``unroll`` runs that many solver iterations per while trip (per-step
    budget/convergence masks keep the semantics EXACTLY those of
    ``unroll=1`` — a lane never steps past ``max_iter`` or past its own
    convergence).  Big-carry loops whose per-trip scheduling/copy overhead
    rivals the step itself amortize it across ``unroll`` steps; the trade
    is ~unroll× the compiled body size and up to ``unroll - 1`` wasted
    (masked) steps at the final trip.
    """
    c0 = jax.vmap(init_fn)(x0)
    alive = jax.vmap(keep_going_fn)

    def merge(active, new, old):
        return jnp.where(active.reshape(active.shape + (1,) * (new.ndim - 1)),
                         new, old)

    # the active mask rides the carry so the (potentially expensive) vmapped
    # keep-going predicate runs ONCE per step instead of in both cond and
    # body — it can be oracle-adjacent work (projected-gradient norms)
    def body(s):
        i, c, active = s
        for j in range(unroll):
            ok = active if j == 0 else (active & (i + j < max_iter))
            stepped = jax.vmap(step_fn)(c)
            c = jax.tree.map(lambda nw, od: merge(ok, nw, od), stepped, c)
            active = alive(c)
        return (i + unroll, c, active)

    def cond(s):
        i, c, active = s
        return (i < max_iter) & jnp.any(active)

    _, final, _ = lax.while_loop(cond, body, (jnp.int32(0), c0, alive(c0)))
    return final


@functools.partial(
    jax.jit,
    static_argnames=("method", "line_search", "oracle", "max_iter",
                     "max_iter_ls", "callback", "unroll", "traced"),
)
def _batch_minimize_lockstep(method, line_search, oracle, x0, bounds,
                             *, max_iter=1000, max_iter_ls=100,
                             callback=None, unroll=1,
                             traced=False) -> SolveResult:
    # ``traced`` carries telemetry.debug_enabled() into the jit cache key:
    # the per-iteration/per-trial tracing callbacks are baked in at TRACE
    # time, so toggling OST_LOG between calls must miss the cache (the
    # same staleness _cached_lbfgsb fixes in api.py)
    """Lockstep batched general driver.  Jitted here (static on the
    frozen-dataclass configs and the oracle object) so the batched entry
    point is compiled even when called eagerly: an eager call would
    dispatch every surrounding op separately.
    """
    init_fn, keep_going_fn, step_fn = make_step(
        method, line_search, oracle, bounds=bounds,
        max_iter_ls=max_iter_ls,
        callback=callback,
    )
    final = lockstep_loop(init_fn, keep_going_fn, step_fn, x0, max_iter,
                          unroll=unroll)
    return jax.vmap(lambda c: _result(c, max_iter, bounds, method))(final)


def batch_minimize(
    method,
    line_search,
    oracle,
    x0: jax.Array,
    *,
    bounds: Bounds = None,
    batched_bounds: bool = False,
    **kwargs,
) -> SolveResult:
    """Batched :func:`minimize` over a leading batch axis of ``x0``.

    This is the capability the single-instance reference lacks entirely
    (SURVEY.md §2.5): thousands of instances advance in lockstep per
    device; converged lanes freeze (per-lane masks) while active lanes keep
    iterating, all inside one compiled ``lax.while_loop``
    (:func:`_batch_minimize_lockstep`).  Set ``batched_bounds=True`` if
    ``bounds`` carry a matching leading batch axis (per-lane boxes); that
    case vmaps the single-instance loop (bounds ride the batch axis there).
    """
    unknown = set(kwargs) - {"max_iter", "max_iter_ls", "callback", "unroll"}
    if unknown:
        raise TypeError(
            f"batch_minimize got unexpected keyword argument(s) "
            f"{sorted(unknown)}")

    if batched_bounds and bounds is not None:
        # unroll is a lockstep-loop knob; the vmapped single-instance path
        # has no lockstep trip overhead to amortize
        kwargs = {k: v for k, v in kwargs.items() if k != "unroll"}

        def solve_one(x0_i, bounds_i):
            return minimize(method, line_search, oracle, x0_i,
                            bounds=bounds_i, **kwargs)

        return jax.vmap(solve_one, in_axes=(0, 0))(x0, bounds)

    from optimization_solvers_tpu.utils import telemetry

    return _batch_minimize_lockstep(
        method, line_search, oracle, x0, bounds,
        max_iter=kwargs.get("max_iter", 1000),
        max_iter_ls=kwargs.get("max_iter_ls", 100),
        callback=kwargs.get("callback"),
        # lockstep iterations per while trip (lockstep_loop unroll):
        # semantics identical to 1, amortizes big-carry loop overhead
        unroll=kwargs.get("unroll", 1),
        traced=telemetry.debug_enabled(),
    )


def make_solver(method, line_search, oracle, *, batched: bool = False, **kwargs):
    """Close over static config and return a jitted ``x0 [, bounds] -> SolveResult``."""
    fn = batch_minimize if batched else minimize

    def solve(x0, bounds=None):
        return fn(method, line_search, oracle, x0, bounds=bounds, **kwargs)

    return jax.jit(solve)
