"""L-BFGS-B: limited-memory BFGS with box constraints, device-resident.

Batched replacement for the reference's only native/FFI component — the
Fortran ``setulb_`` reverse-communication loop driven from
``/root/reference/src/quasi_newton/lbfgsb.rs:23-86``.  The reference crosses
the Rust→Fortran ABI boundary every iteration with all state in caller-owned
Fortran workspaces; here that control flow is inverted (SURVEY.md §3.3): the
full Byrd-Lu-Nocedal-Zhu algorithm — limited-memory compact representation,
generalized Cauchy point, primal subspace minimization, strong-Wolfe line
search — runs as one ``lax.while_loop`` whose carry is a pytree of device
arrays, so thousands of instances batch under ``vmap`` and shard over a mesh
with zero host round-trips.

Algorithm reference: R. H. Byrd, P. Lu, J. Nocedal, C. Zhu, "A limited
memory algorithm for bound constrained optimization", SIAM J. Sci. Comput.
16(5), 1995 (the same algorithm the Fortran implements):

  * B_k = theta I - W M W^T with W = [Y  theta S] and
    M^{-1} = [[-D, L^T], [L, theta S^T S]]  (paper eq. 3.3).
  * Generalized Cauchy point: piecewise-quadratic minimization along the
    projected steepest-descent path, walking breakpoints in increasing
    order (paper alg. CP) — here a fixed-shape ``lax.while_loop`` that
    pulls the next breakpoint with a masked argmin per examined segment
    (no upfront sort), O(n + m^2) work per examined segment.
  * Subspace minimization: direct primal method with the Sherman-Morrison-
    Woodbury inverse restricted to the free set (paper eqs. 5.4-5.11); the
    free set is a mask, never a gather, so shapes stay static.
  * Stopping: ``pgtol`` on the infinity norm of the projected gradient and
    ``factr`` on the relative objective decrease — the exact semantics the
    reference exposes via ``set_factr``/``set_pgtol``
    (``lbfgsb.rs:139-145``), plus the wrapper's own
    ``||pg||_inf <= 1e-10 * f`` rule (``lbfgsb.rs:67-72``) as
    ``rel_pg_stop``.

History slots are maintained chronologically by roll-and-write; invalid
slots carry zero rows in W (so they cannot contribute) and are given unit
diagonal entries in M^{-1} to keep it invertible.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from optimization_solvers_tpu.core.numerics import (
    box_projection,
    dot as vdot,
    infinity_norm,
    matmat,
    matvec,
)
from optimization_solvers_tpu.core.oracle import Oracle, ensure_oracle
from optimization_solvers_tpu.ops.smallchol import (
    cholesky_small,
    spd_solve_small,
    spd_solve_small_mat,
)
from optimization_solvers_tpu.core.types import FuncEval, SolveResult, Status
from optimization_solvers_tpu.linesearch.dcsrch import StrongWolfe


class _History(NamedTuple):
    S: jax.Array      # (m, n) correction steps, row m-1 newest
    Y: jax.Array      # (m, n) gradient differences
    valid: jax.Array  # (m,) bool
    theta: jax.Array  # scalar B0 = theta I scaling


class _Carry(NamedTuple):
    x: jax.Array
    f: jax.Array
    g: jax.Array
    hist: _History
    f_prev: jax.Array
    k: jax.Array
    # line search failed with an empty history: terminate with
    # Status.ABNORMAL at the restored iterate (the Fortran's
    # ABNORMAL_TERMINATION_IN_LNSRCH, surfaced by the reference at
    # /root/reference/src/quasi_newton/lbfgsb.rs:76-84)
    abnormal: jax.Array


@dataclasses.dataclass(frozen=True)
class LbfgsbConfig:
    """Tolerance semantics follow the Fortran (``lbfgsb.rs:139-145``):
    ``factr`` is multiplied by machine epsilon; typical values 1e12 (low
    accuracy), 1e7 (moderate), 10 (extremely high).  ``m`` defaults to 5
    (``lbfgsb.rs:91``), recommended range [3, 20] (``lbfgsb.rs:150-154``)."""

    m: int = 5
    factr: float = 1e7
    pgtol: float = 1e-5
    rel_pg_stop: bool = False   # reference wrapper rule: pg_inf <= 1e-10 * f
    max_iter: int = 500
    max_iter_ls: int = 20
    ls_c1: float = 1e-3         # Fortran dcsrch ftol
    ls_c2: float = 0.9          # Fortran dcsrch gtol
    # floor for the curvature acceptance test s.y > eps * y.y; applied as
    # max(curvature_eps, machine eps of the WORKING dtype) — the f64
    # default would be vacuous against f32 cancellation noise
    curvature_eps: float = 2.2e-16
    # Fortran ``iprint`` analogue (lbfgsb.rs:146-148, wired through
    # ``api.Lbfgsb.set_verbosity``): >= 1 emits one k/f/||pg||/t tracing
    # event per outer iteration via jax.debug.callback; < 1 additionally
    # defers to OST_LOG=debug (utils.telemetry.debug_enabled)
    verbose: int = -1
    # breakpoints retired per trip of the generalized-Cauchy-point walk
    # (see _cauchy_point); larger = fewer while trips, more wasted work in
    # the stopping chunk
    gcp_chunk: int = 256
    # outer solver iterations per lockstep while trip (driver.lockstep_loop
    # unroll) — semantics identical to 1; amortizes the big-carry loop's
    # per-trip scheduling/copy overhead on huge-n workloads (config 4)
    lockstep_unroll: int = 1


def _projected_gradient_norm(x, g, lower, upper):
    """``||x - P(x - g)||_inf`` — the Fortran's ``sbgnrm``."""
    return infinity_norm(x - box_projection(x - g, lower, upper))


class _Mid(NamedTuple):
    """Factorized middle operator: solves with
    ``P = [[-E, G], [G^T, H]]`` via the SPD Schur complement
    ``H + G^T E^{-1} G`` — the same block factorization the Fortran
    ``formk`` maintains, built here from two unrolled small Choleskys
    (no jnp.linalg in the hot loop: a generic batched factorization is a
    library call per solve and slow to compile under vmap)."""

    Ech: jax.Array   # (m, m) lower Cholesky of E
    G: jax.Array     # (m, m)
    Sch: jax.Array   # (m, m) lower Cholesky of H + G^T E^{-1} G


def _mid_solve(mid: _Mid, ab: jax.Array) -> jax.Array:
    """Solve ``P z = ab`` with the block elimination
    u = E^{-1}(G v - a),  (H + G^T E^{-1} G) v = b + G^T E^{-1} a."""
    m = mid.G.shape[-1]
    a, b = ab[..., :m], ab[..., m:]
    Einv_a = spd_solve_small(mid.Ech, a)
    v = spd_solve_small(mid.Sch, b + matvec(jnp.swapaxes(mid.G, -1, -2), Einv_a))
    u = spd_solve_small(mid.Ech, matvec(mid.G, v) - a)
    return jnp.concatenate([u, v], axis=-1)


def _grams(hist: _History):
    """Shared history Gram pieces: patched curvature diagonal D,
    chronological strictly-lower L, and the raw S S^T table — computed
    once per outer iteration and consumed by both :func:`_build_middle`
    and :func:`_middle_factors` (they are three (m, n) x (n, m) HIGHEST
    matmuls each; recomputing them doubled the dispatches in the
    while-loop body)."""
    S, Y, valid, theta = hist
    D = jnp.sum(S * Y, axis=1)                              # (m,)
    D = jnp.where(valid, D, jnp.ones_like(D))
    SY = matmat(S, Y.T)                                     # SY[i,j] = s_i . y_j
    L = jnp.tril(SY, k=-1)
    SS = matmat(S, S.T)
    return D, L, SS


def _middle_factors(hist: _History, free=None, grams=None) -> _Mid:
    """Factor the middle matrix ``MM = [[-D, L^T],[L, theta S^T S]]``
    (paper eq. 3.3), or — given a free-variable mask — the subspace matrix
    ``MM - W_F^T W_F / theta`` used by the SMW solve (paper eq. 5.10ff).
    Invalid history slots get unit diagonal blocks; their W rows are zero
    so they cannot contribute."""
    S, Y, valid, theta = hist
    m = S.shape[0]
    dtype = S.dtype
    D, L, SS = _grams(hist) if grams is None else grams
    if free is None:
        E = jnp.diag(D)
        G = L.T
        H = theta * SS
    else:
        YF = Y * free[None, :]
        SF = S * free[None, :]
        E = jnp.diag(D) + matmat(YF, YF.T) / theta
        G = L.T - matmat(YF, SF.T)
        H = theta * (SS - matmat(SF, SF.T))
    H = H + jnp.diag(jnp.where(valid, jnp.zeros((m,), dtype), jnp.ones((m,), dtype)))
    Ech = cholesky_small(E)
    EinvG = spd_solve_small_mat(Ech, G)
    schur = H + matmat(jnp.swapaxes(G, -1, -2), EinvG)
    return _Mid(Ech, G, cholesky_small(schur))


def _middle_inverse(D, Lm, H):
    """Explicit inverse of ``MM = [[-diag(D), Lm^T], [Lm, H]]`` via block
    elimination on the diagonal (1,1) block: the Schur complement
    ``Sc = H + Lm diag(1/D) Lm^T`` is SPD (D > 0 from the curvature-gated
    history; H = theta S^T S + pad), so one unrolled small Cholesky
    replaces the batched LU inverse (XLA's ``jnp.linalg.inv`` measured
    ~0.7 ms/iteration at m=10, B=64 — comparable to the whole rest of the
    direction computation)."""
    dtype = D.dtype
    m = D.shape[-1]
    # accepted pairs guarantee D > 0; the tiny floor only guards exotic
    # external callers against a literal divide-by-zero (the old
    # equilibrated inverse had the same floor)
    D = jnp.maximum(D, jnp.asarray(jnp.finfo(dtype).tiny, dtype))
    U = Lm / D[None, :]                                     # Lm diag(1/D)
    Sc = H + matmat(U, Lm.T)
    J = spd_solve_small_mat(cholesky_small(Sc), jnp.eye(m, dtype=dtype))
    JU = matmat(J, U)                                       # (m, m)
    TL = matmat(U.T, JU) - jnp.diag(1.0 / D)
    return jnp.block([[TL, JU.T], [JU, J]])


def _build_middle(hist: _History, grams=None):
    """W (as rows: (2m, n)) and the dense middle inverse M = MM^{-1}.

    The inverse is explicit (the Cauchy walk applies M to many chunk
    matrices, so a factorization would re-solve constantly); it is built
    by :func:`_middle_inverse`'s block elimination — exactly the
    structure the Fortran ``formk`` factorizes."""
    S, Y, valid, theta = hist
    m = S.shape[0]
    dtype = S.dtype
    Wt = jnp.concatenate([Y, theta * S], axis=0)            # (2m, n)
    D, L, SS = _grams(hist) if grams is None else grams
    SS = SS + jnp.diag(jnp.where(valid, jnp.zeros((m,), dtype), jnp.ones((m,), dtype)))
    return Wt, _middle_inverse(D, L, theta * SS)


def _cauchy_point(x, g, lower, upper, Wt, M, theta, chunk: int = 256):
    """Generalized Cauchy point (paper alg. CP).  Returns
    ``(xcp, c, free_mask)`` with ``c = W^T (xcp - x)``.

    The breakpoint walk is CHUNKED: on bound-rich problems the sweep
    examines thousands of segments (measured up to ~2,400/iteration on the
    10k-dim bounded log-sum-exp), and a one-segment-per-trip
    ``lax.while_loop`` is small-op dispatch-bound.  Within a chunk of the
    next ``K`` sorted breakpoints the per-segment recurrences linearize
    exactly: p is a prefix sum of ``g_b w_b``, c a prefix sum of
    ``dt * p``, and f1/f2 prefix sums given those — so one trip retires K
    segments with a few (2m, K) matmuls and cumsums, and the stop test
    becomes a prefix-AND.  Same algorithm, reassociated (f32 sums within a
    chunk accumulate in a different order than the scalar walk).

    The walk gathers the K needed values per trip (measured negative
    result: pre-gathering g/z/W into full breakpoint order once per
    iteration is 3.4x SLOWER — full-width minor-axis permute-gathers on
    (2m, n) dwarf the per-trip K-element gathers they replace)."""
    n = x.shape[-1]
    dtype = x.dtype
    eps = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    two_m = Wt.shape[0]

    # breakpoints along the projected steepest-descent path (paper eq. 4.1)
    t_break = jnp.where(
        g < 0.0,
        (x - upper) / g,
        jnp.where(g > 0.0, (x - lower) / g, jnp.inf),
    )
    d0 = jnp.where(t_break > 0.0, -g, jnp.zeros_like(g))

    # variables with t_i <= 0 are fixed from the start and never examined.
    # One two-operand sort yields BOTH the sorted keys and the permutation:
    # `keys[argsort(keys)]` re-gathers with scattered indices on the minor
    # axis, which the profiler showed at ~6.5 ms per iteration at n=10k —
    # 10x the sort itself.
    keys = jnp.where(t_break > 0.0, t_break, jnp.inf)
    t_sorted, order = lax.sort(
        (keys, jnp.arange(n, dtype=jnp.int32)), num_keys=1)

    K = min(chunk, n)
    L = ((n + K - 1) // K) * K
    pad = L - n
    bound_vec = jnp.where(d0 > 0.0, upper, lower)
    z = bound_vec - x
    t_pad = jnp.concatenate([t_sorted, jnp.full((pad,), jnp.inf, dtype)])
    ord_pad = jnp.concatenate([order, jnp.zeros((pad,), order.dtype)])
    # one packed array -> ONE per-trip gather for (g, z, W) instead of three
    GZW = jnp.concatenate([g[None, :], z[None, :], Wt], axis=0)
    # prefix sums as a triangular-ones matmul: one (K, K) contraction
    # instead of a cumsum's reduce_window (HIGHEST keeps it exact-f32)
    U_incl = jnp.triu(jnp.ones((K, K), dtype))

    def prefix(v):
        return matmat(v, U_incl) if v.ndim == 2 else matvec(U_incl.T, v)

    def seg_min(f1, f2):
        return jnp.where(
            f2 > eps,
            -f1 / f2,
            jnp.where(f1 < 0.0, jnp.asarray(jnp.inf, dtype), jnp.zeros((), dtype)),
        )

    p0 = matvec(Wt, d0)
    f1_0 = -vdot(d0, d0)
    f2_0 = -theta * f1_0 - vdot(p0, matvec(M, p0))
    dt_min0 = seg_min(f1_0, f2_0)

    def cond(carry):
        j0, cnt, c, p, f1, f2, dt_min, t_old, full = carry
        return full & (j0 < L)

    def body(carry):
        j0, cnt, c, p, f1, f2, dt_min, t_old, full = carry
        t_b = lax.dynamic_slice(t_pad, (j0,), (K,))             # (K,)
        idx = lax.dynamic_slice(ord_pad, (j0,), (K,))
        gzw = GZW[:, idx]                                       # (2m+2, K)
        gb = gzw[0]
        zb = gzw[1]
        Wb = gzw[2:]                                            # (2m, K)
        finite = jnp.isfinite(t_b)

        t_prev = jnp.concatenate([t_old[None], t_b[:-1]])
        # non-finite breakpoints are never processed (prefix mask below);
        # zero their dt so inf cannot poison the chunk's cumsums
        dt = jnp.where(finite, t_b - t_prev, jnp.zeros((), dtype))

        GW = Wb * gb[None, :]
        csGW = prefix(GW)
        Pexc = p[:, None] + (csGW - GW)          # p BEFORE segment j
        Cj = c[:, None] + prefix(Pexc * dt[None, :])  # c AFTER c += dt p

        MCPW = matmat(M, jnp.concatenate([Cj, Pexc, Wb], axis=1))  # (2m, 3K)
        a = jnp.sum(Wb * MCPW[:, :K], axis=0)            # w_j . M c_j
        bq = jnp.sum(Wb * MCPW[:, K:2 * K], axis=0)      # w_j . M p_j
        e = jnp.sum(Wb * MCPW[:, 2 * K:], axis=0)        # w_j . M w_j

        # mask BEFORE the prefix matmuls: entries past the finite
        # breakpoints carry zb = +-inf (infinite bounds) and would
        # NaN-poison every lane of the chunk through the triangular-ones
        # contraction (0 * inf); they are never processed (prefix-AND
        # below), so zeroing their increments is exact
        r = jnp.where(
            finite,
            theta * gb * gb + 2.0 * gb * bq + gb * gb * e,      # f2 decrement
            jnp.zeros((), dtype))
        q = jnp.where(
            finite,
            gb * gb + theta * gb * zb - gb * a,                 # f1 increment
            jnp.zeros((), dtype))
        cs_r = prefix(r)
        F2exc = f2 - (cs_r - r)                  # f2 BEFORE segment j
        F1inc = f1 + prefix(dt * F2exc + q)
        F2inc = f2 - cs_r
        dtm = seg_min(F1inc, F2inc)

        # segment j is processed iff every i <= j passed the walk test
        # (dt_min before i  >=  t_i - t_{i-1})
        dtm_prev = jnp.concatenate([dt_min[None], dtm[:-1]])
        proceed = finite & (dtm_prev >= dt)
        # prefix-AND == "no failures so far": one more prefix matmul
        procmask = prefix(1.0 - proceed.astype(dtype)) < 0.5
        n_proc = jnp.sum(procmask.astype(jnp.int32)).astype(jnp.int32)

        oh = jnp.arange(K) == n_proc - 1                        # one-hot
        some = n_proc > 0

        # mask-then-sum (not multiply-by-one-hot): a legitimate +inf at a
        # NON-selected lane (seg_min past the stop index) would otherwise
        # produce inf * 0 = NaN
        def sel_vec(arr, default):                              # (2m, K) -> (2m,)
            picked = jnp.sum(
                jnp.where(oh[None, :], arr, jnp.zeros((), dtype)), axis=1)
            return jnp.where(some, picked, default)

        def sel(arr, default):                                  # (K,) -> ()
            picked = jnp.sum(jnp.where(oh, arr, jnp.zeros((), dtype)))
            return jnp.where(some, picked, default)

        c_out = sel_vec(Cj, c)
        p_out = sel_vec(p[:, None] + csGW, p)
        f1_out = sel(F1inc, f1)
        f2_out = sel(F2inc, f2)
        t_old_out = sel(t_b, t_old)
        dt_min_out = sel(dtm, dt_min)
        return (j0 + K, cnt + n_proc, c_out, p_out, f1_out, f2_out,
                dt_min_out, t_old_out, n_proc == K)

    init = (
        jnp.int32(0),
        jnp.int32(0),
        jnp.zeros((two_m,), dtype),
        p0,
        f1_0,
        f2_0,
        dt_min0,
        jnp.zeros((), dtype),
        jnp.bool_(True),
    )
    j0, cnt, c, p, f1, f2, dt_min, t_old, full = lax.while_loop(
        cond, body, init)

    # processed set = the first cnt entries of the sorted order
    inv_rank = jnp.zeros((n,), jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    fixed = inv_rank < cnt
    d = jnp.where(fixed, jnp.zeros((), dtype), d0)

    dt_min = jnp.maximum(dt_min, 0.0)
    t_cp = t_old + dt_min
    # same inf-times-zero hazard for the running c = W^T (xcp - x): p is
    # exactly zero whenever dt_min is infinite (d is all zeros then)
    c = c + jnp.where(jnp.isfinite(dt_min), dt_min, 0.0) * p
    # dt_min (hence t_cp) is +inf when the model minimizer lies beyond every
    # breakpoint — possible only when the remaining segment direction is all
    # zeros (every moving coordinate already hit its bound), so guard the
    # inf * 0 = NaN in the straight-line extension
    xcp = jnp.where(fixed, bound_vec, x + jnp.where(d == 0.0, 0.0, t_cp * d))
    free = (t_break > 0.0) & ~fixed
    return xcp, c, free


def _subspace_step(x, g, xcp, c, free, lower, upper, hist, Wt, M, grams=None):
    """Direct primal subspace minimization (paper §5.1) with SMW inverse;
    returns the search point ``xbar`` (free coords moved, alpha-clipped to
    the box)."""
    dtype = x.dtype
    theta = hist.theta

    # reduced gradient of the model at xcp (paper eq. 5.4)
    r = g + theta * (xcp - x) - matvec(Wt.T, matvec(M, c))
    rF = jnp.where(free, r, jnp.zeros_like(r))

    # (B restricted to free)^{-1} r via SMW (paper eq. 5.10):
    # d = r/theta + W_F (MM - W_F^T W_F/theta)^{-1} W_F^T r / theta^2.
    # (I - M K/theta)^{-1} M  ==  (MM - K/theta)^{-1}, and the right-hand
    # side is exactly the subspace middle matrix _middle_factors builds
    # from the free mask — the same block factorization the Fortran formk
    # maintains, two small unrolled Choleskys instead of a batched LU.
    WtF = Wt * free[None, :]
    mid = _middle_factors(hist, free, grams=grams)
    v = _mid_solve(mid, matvec(WtF, rF))
    dvec = rF / theta + jnp.where(free, matvec(Wt.T, v), 0.0) / (theta * theta)
    du = -dvec

    # alpha* : largest step in [0, 1] keeping free coords in the box
    # (paper eq. 5.8)
    pos = (upper - xcp) / du
    neg = (lower - xcp) / du
    steps = jnp.where(du > 0.0, pos, jnp.where(du < 0.0, neg, jnp.inf))
    steps = jnp.where(free, steps, jnp.inf)
    steps = jnp.where(jnp.isnan(steps), jnp.inf, steps)
    alpha = jnp.minimum(jnp.asarray(1.0, dtype), jnp.min(steps))

    # mathematically xbar is already in the box (alpha clips to it), but
    # fused rounding can leave +-1 ulp of dust on a coordinate sitting
    # exactly on its bound — the search direction then points epsilon-
    # outward and the bounded dcsrch's max feasible step collapses to -0.0
    # (a zero step that trips the factr stall exit at a non-optimum).  The
    # projection removes the dust exactly.
    return box_projection(
        xcp + alpha * jnp.where(free, du, jnp.zeros_like(du)), lower, upper)


def make_lbfgsb_step(oracle, lower: jax.Array, upper: jax.Array,
                     config: LbfgsbConfig = LbfgsbConfig()):
    """Build ``(init_fn, keep_going_fn, step_fn)`` for the L-BFGS-B loop —
    one ``step_fn`` call is a full outer iteration (Cauchy point, subspace
    minimization, line search, history update)."""
    oracle = ensure_oracle(oracle)
    cfg = config

    # the Fortran L-BFGS-B drives MINPACK-2 dcsrch; StrongWolfe is its
    # batched equivalent, with the max feasible step to the boundary as stpmx
    ls = StrongWolfe(c1=cfg.ls_c1, c2=cfg.ls_c2, bounded=True)

    from optimization_solvers_tpu.utils import telemetry

    trace_cb = None
    if cfg.verbose >= 1:
        import logging

        trace_cb = telemetry.iteration_tracer("solver.Lbfgsb", logging.INFO)
    elif telemetry.debug_enabled():
        trace_cb = telemetry.iteration_tracer("solver.Lbfgsb")

    def init_fn(x0: jax.Array) -> _Carry:
        dtype = x0.dtype
        n = x0.shape[-1]
        x0 = box_projection(x0, lower, upper)
        ev0 = oracle(x0)
        hist0 = _History(
            S=jnp.zeros((cfg.m, n), dtype),
            Y=jnp.zeros((cfg.m, n), dtype),
            valid=jnp.zeros((cfg.m,), bool),
            theta=jnp.asarray(1.0, dtype),
        )
        return _Carry(
            x0, ev0.f, ev0.g, hist0, jnp.asarray(jnp.inf, dtype),
            jnp.int32(0), jnp.asarray(False),
        )

    def converged(c: _Carry):
        dtype = c.f.dtype
        f_rtol = cfg.factr * float(jnp.finfo(dtype).eps)
        pg = _projected_gradient_norm(c.x, c.g, lower, upper)
        done = pg <= cfg.pgtol
        if cfg.rel_pg_stop:
            # reference wrapper stopping rule (lbfgsb.rs:67-72)
            done = done | (pg <= 1e-10 * c.f)
        # relative objective decrease (Fortran factr semantics); inactive
        # until one step has completed (f_prev starts at +inf)
        fmax = jnp.maximum(jnp.maximum(jnp.abs(c.f), jnp.abs(c.f_prev)), 1.0)
        done = done | (
            jnp.isfinite(c.f_prev) & ((c.f_prev - c.f) <= f_rtol * fmax)
        )
        return done

    def keep_going_fn(c: _Carry):
        return jnp.isfinite(c.f) & ~c.abnormal & ~converged(c)

    def step_fn(c: _Carry):
        dtype = c.x.dtype
        grams = _grams(c.hist)
        Wt, M = _build_middle(c.hist, grams)
        xcp, cc, free = _cauchy_point(
            c.x, c.g, lower, upper, Wt, M, c.hist.theta, chunk=cfg.gcp_chunk
        )
        xbar = _subspace_step(
            c.x, c.g, xcp, cc, free, lower, upper, c.hist, Wt, M, grams=grams
        )
        d = xbar - c.x

        ev_k = FuncEval(c.f, c.g)
        # the dcsrch search returns the accepted point's evaluation, saving
        # one full oracle call per outer iteration (the eval-bound cost of
        # the lockstep path)
        t, _, x_new, ev_new = ls.step_len_ev(
            oracle, c.x, ev_k, d, None, (lower, upper), cfg.max_iter_ls,
        )

        # Fortran mainlb line-search-failure semantics (surfaced by the
        # reference at lbfgsb.rs:76-84): a dcsrch forced exit that accepted
        # a NON-DESCENT trial (f up), a zero step (bracket collapsed at 0 /
        # non-descent direction), or a numerically-poisoned step (non-finite
        # iterate/eval) RESTORES the previous iterate; then, if corrections
        # exist, the history is discarded and the iteration retried from a
        # steepest-descent model — otherwise the lane terminates ABNORMAL.
        # (Before round 3 these edges stall-exited CONVERGED at the worse /
        # non-stationary iterate via the factr test.)
        ok = jnp.all(jnp.isfinite(x_new)) & jnp.isfinite(ev_new.f) & jnp.all(
            jnp.isfinite(ev_new.g)
        )
        # failure = poisoned eval, accepted-worse trial, zero step, or a
        # tiny forced-exit step whose update underflowed (x bitwise
        # unchanged => no progress is representable: the Fortran's
        # "rounding errors prevent progress" warning geometry)
        ls_fail = (
            (~ok) | (ev_new.f > c.f) | (t <= 0.0) | jnp.all(x_new == c.x)
        )
        has_hist = jnp.any(c.hist.valid)
        restart = ls_fail & has_hist
        abnormal = c.abnormal | (ls_fail & ~has_hist)
        x_new = jnp.where(ls_fail, c.x, x_new)
        ev_new = FuncEval(
            jnp.where(ls_fail, c.f, ev_new.f),
            jnp.where(ls_fail, c.g, ev_new.g),
        )

        s = x_new - c.x
        y = ev_new.g - c.g
        sy = vdot(s, y)
        yy = vdot(y, y)
        curv_eps = max(cfg.curvature_eps, float(jnp.finfo(dtype).eps))
        accept = ok & (sy > curv_eps * yy)
        hist = c.hist
        S = jnp.roll(hist.S, -1, axis=0).at[-1].set(s)
        Y = jnp.roll(hist.Y, -1, axis=0).at[-1].set(y)
        valid = jnp.roll(hist.valid, -1).at[-1].set(True)
        theta = yy / sy
        hist = _History(
            S=jnp.where(accept, S, hist.S),
            Y=jnp.where(accept, Y, hist.Y),
            valid=jnp.where(accept, valid, hist.valid),
            theta=jnp.where(accept, theta, hist.theta),
        )
        # history restart on failure: S/Y must be ZEROED, not just
        # invalidated — invalid slots rely on zero W rows to stay inert
        hist = _History(
            S=jnp.where(restart, jnp.zeros_like(hist.S), hist.S),
            Y=jnp.where(restart, jnp.zeros_like(hist.Y), hist.Y),
            valid=jnp.where(restart, jnp.zeros_like(hist.valid), hist.valid),
            theta=jnp.where(restart, jnp.ones_like(hist.theta), hist.theta),
        )
        # disable the factr stall test for the retry iteration (f did not
        # move; the stall exit would otherwise misreport CONVERGED)
        f_prev = jnp.where(restart, jnp.asarray(jnp.inf, dtype), c.f)
        if trace_cb is not None:
            jax.debug.callback(
                trace_cb, c.k + 1, ev_new.f,
                _projected_gradient_norm(x_new, ev_new.g, lower, upper), t)
        return _Carry(x_new, ev_new.f, ev_new.g, hist, f_prev, c.k + 1,
                      abnormal)

    return init_fn, keep_going_fn, step_fn


def lbfgsb_minimize(
    oracle,
    x0: jax.Array,
    lower: jax.Array,
    upper: jax.Array,
    config: LbfgsbConfig = LbfgsbConfig(),
) -> SolveResult:
    """Minimize with L-BFGS-B; single instance (wrap in ``vmap`` to batch,
    ``jit`` to compile)."""
    cfg = config
    init_fn, keep_going_fn, step_fn = make_lbfgsb_step(oracle, lower, upper, cfg)

    def cond(c: _Carry):
        return (c.k < cfg.max_iter) & keep_going_fn(c)

    final = lax.while_loop(cond, step_fn, init_fn(x0))
    return _lbfgsb_result(final, cfg, lower, upper)


def _lbfgsb_result(final: "_Carry", cfg: LbfgsbConfig,
                   lower, upper) -> SolveResult:
    # elementwise, so the same expression serves single and batched carries.
    # ABNORMAL takes precedence (the Fortran task string wins over the
    # iteration budget; abnormal lanes carry a restored finite iterate).
    status = jnp.where(
        final.abnormal,
        jnp.int32(Status.ABNORMAL),
        jnp.where(
            final.k >= cfg.max_iter,
            jnp.int32(Status.MAX_ITER_REACHED),
            jnp.where(
                ~jnp.isfinite(final.f),
                jnp.int32(Status.OUT_OF_DOMAIN),
                jnp.int32(Status.CONVERGED),
            ),
        ),
    )
    return SolveResult(
        final.x, final.f, final.g, final.k, status,
        pg_norm=_projected_gradient_norm(final.x, final.g, lower, upper))


def lbfgsb_batch_minimize(
    oracle,
    x0: jax.Array,                  # (B, n)
    lower: jax.Array,
    upper: jax.Array,
    config: LbfgsbConfig = LbfgsbConfig(),
) -> SolveResult:
    """Lockstep batched L-BFGS-B: ONE global ``lax.while_loop`` whose body
    is the vmapped outer iteration, converged lanes frozen by per-lane
    masks.

    Prefer this over ``vmap(lbfgsb_minimize)`` for large batches: one
    dispatch covers the whole batch with a single compile.  Wrap in
    ``jax.jit``.
    """
    from optimization_solvers_tpu.solvers.driver import lockstep_loop

    cfg = config
    init_fn, keep_going_fn, step_fn = make_lbfgsb_step(
        oracle, lower, upper, cfg)
    final = lockstep_loop(init_fn, keep_going_fn, step_fn, x0, cfg.max_iter,
                          unroll=cfg.lockstep_unroll)
    return _lbfgsb_result(final, cfg, lower, upper)


def lbfgsb_minimize_scaled(
    oracle,
    x0: jax.Array,
    lower: jax.Array,
    upper: jax.Array,
    diag: jax.Array,
    config: LbfgsbConfig = LbfgsbConfig(),
) -> SolveResult:
    """Scaled (diagonally preconditioned) L-BFGS-B: implicit ``B0 = theta *
    diag(diag)`` instead of the Fortran's ``theta * I``.

    A capability the reference's Fortran core lacks (``setulb_`` hard-codes
    the scalar ``theta`` scaling, reached via
    ``/root/reference/src/quasi_newton/lbfgsb.rs:36-57``).  Realized with
    zero new kernel code through the exact change of variables
    ``z = sqrt(diag) * x``: a positive diagonal scaling maps boxes to boxes
    (``[sqrt(d) l, sqrt(d) u]``), gradients transform as
    ``g_z = g_x / sqrt(diag)``, and running plain L-BFGS-B in z-space is
    algebraically identical to running the scaled method in x-space.  On a
    quadratic with Hessian H, passing ``diag = jnp.diagonal(H)`` is Jacobi
    preconditioning.

    ``pgtol``/``factr`` apply in the scaled metric (that is the point: the
    scaled metric is the one in which the problem is well-conditioned).
    ``diag`` must be elementwise positive.
    """
    base = ensure_oracle(oracle)
    s = jnp.sqrt(jnp.asarray(diag, x0.dtype))

    def full(z):
        ev = base(z / s)
        return FuncEval(ev.f, ev.g / s)

    def value(z):
        return base.value(z / s)

    r = lbfgsb_minimize(
        Oracle(full, value), x0 * s, lower * s, upper * s, config
    )
    # pg_norm stays in the SCALED metric: that is the metric pgtol/factr
    # act in (the whole point of the preconditioning)
    return SolveResult(r.x / s, r.f, r.g * s, r.iterations, r.status,
                       pg_norm=r.pg_norm)
