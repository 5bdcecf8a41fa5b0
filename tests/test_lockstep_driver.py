"""Lockstep batched driver (``solvers.batch_minimize``): every (method,
search) combo must agree lane for lane with the single-instance driver
(``solvers.minimize`` vmapped over the batch), plus odd batch sizes,
per-lane boxes, problem data, the OUT_OF_DOMAIN status and the f32
regressions of the lockstep path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optimization_solvers_tpu import linesearch as ls, solvers
from optimization_solvers_tpu.core.oracle import make_oracle

N, B = 8, 16
DVEC = jnp.asarray(np.linspace(1.0, 50.0, N))


def _quad(x, d):
    return 0.5 * jnp.sum(d * x * x)


def _oracle():
    return make_oracle(_quad, data=(DVEC,))


def _x0():
    return jnp.asarray(np.random.RandomState(0).uniform(-2, 2, (B, N)))


BOUNDS = (jnp.full(N, -1.5), jnp.full(N, 2.5))


def _single(method, search, oracle, x0, bounds, **kw):
    """Reference: the single-instance driver, one lane at a time (vmapped:
    each lane keeps its own while-loop predicate)."""
    return jax.jit(jax.vmap(lambda x: solvers.minimize(
        method, search, oracle, x, bounds=bounds, **kw)))(x0)


def _assert_lanes_match(r, ref, x_atol=1e-5, f_atol=1e-9):
    # QN lanes may legitimately exit STALLED (6): the s/y-stall exit at a
    # point whose pg_norm misses the (tight) tol.  Parity is: same
    # statuses on both paths, all success-class.
    np.testing.assert_array_equal(np.asarray(r.status),
                                  np.asarray(ref.status))
    assert np.isin(np.asarray(r.status), (1, 6)).all(), np.asarray(r.status)
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(ref.x),
                               atol=x_atol)
    np.testing.assert_allclose(np.asarray(r.f), np.asarray(ref.f),
                               atol=f_atol)


COMBOS = [
    (solvers.GradientDescent(grad_tol=1e-6), ls.BackTracking(), False),
    (solvers.GradientDescent(grad_tol=1e-6), ls.GLLQuadratic(), False),
    (solvers.CoordinateDescent(grad_tol=1e-6), ls.BackTracking(), False),
    (solvers.ProjectedGradientDescent(grad_tol=1e-6), ls.BackTrackingB(), True),
    (solvers.SpectralProjectedGradient(grad_tol=1e-6), ls.GLLQuadratic(), True),
    (solvers.NonlinearCG(grad_tol=1e-6, variant="pr+"), ls.BackTracking(), False),
    (solvers.NonlinearCG(grad_tol=1e-6, variant="dy"), ls.BackTracking(), False),
    (solvers.BFGS(tol=1e-8), ls.BackTracking(), False),
    (solvers.BFGS(tol=1e-8), ls.MoreThuente(), False),
    (solvers.LBFGS(tol=1e-8, m=4), ls.HagerZhang(), False),
    (solvers.GradientDescent(grad_tol=1e-6), ls.HagerZhang(), False),
    (solvers.BFGSB(tol=1e-8), ls.HagerZhangB(), True),
    (solvers.GradientDescent(grad_tol=1e-6), ls.MoreThuente(), False),
    (solvers.BFGSB(tol=1e-8), ls.MoreThuenteB(), True),
    (solvers.DFP(tol=1e-8), ls.BackTracking(), False),
    (solvers.Broyden(tol=1e-8), ls.BackTracking(), False),
    (solvers.BFGSB(tol=1e-8), ls.BackTrackingB(), True),
    (solvers.SR1B(tol=1e-8), ls.BackTrackingB(), True),
]


@pytest.mark.parametrize(
    "method,search,bounded", COMBOS,
    ids=[f"{type(m).__name__}-{type(s).__name__}"
         f"-{getattr(m, 'variant', getattr(m, 'update', ''))}"
         for m, s, _ in COMBOS],
)
def test_lockstep_matches_single_instance(method, search, bounded):
    x0 = _x0()
    bounds = BOUNDS if bounded else None
    kw = dict(max_iter=3000, max_iter_ls=40)
    r = solvers.batch_minimize(method, search, _oracle(), x0, bounds=bounds,
                               **kw)
    _assert_lanes_match(r, _single(method, search, _oracle(), x0, bounds,
                                   **kw))


def _coupled(x, d):
    # non-separable strictly-convex objective: dense SPD Hessian
    # diag(d) + 3 (sum x)^2 / n * ones
    s = jnp.sum(x)
    return 0.5 * jnp.sum(d * x * x) + 0.25 * s ** 4 / x.shape[-1]


NEWTON_COMBOS = [
    (solvers.Newton(tol=1e-12), ls.BackTracking(), False),
    (solvers.ProjectedNewton(grad_tol=1e-8), ls.BackTrackingB(), True),
    (solvers.SpectralProjectedNewton(grad_tol=1e-8), ls.BackTrackingB(), True),
]


@pytest.mark.parametrize(
    "method,search,bounded", NEWTON_COMBOS,
    ids=[type(m).__name__ for m, _, _ in NEWTON_COMBOS],
)
def test_newton_lockstep_matches_single_instance(method, search, bounded):
    x0 = _x0()
    bounds = BOUNDS if bounded else None
    oracle = make_oracle(_coupled, data=(DVEC,), with_hessian=True)
    kw = dict(max_iter=200, max_iter_ls=40)
    r = solvers.batch_minimize(method, search, oracle, x0, bounds=bounds,
                               **kw)
    ref = _single(method, search, oracle, x0, bounds, **kw)
    # SPN's BB-scaled step legitimately exhausts the budget on some lanes
    # (on both paths) — parity is status equality, not universal
    # convergence
    np.testing.assert_array_equal(np.asarray(r.status),
                                  np.asarray(ref.status))
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(ref.x), atol=1e-5)
    np.testing.assert_allclose(np.asarray(r.f), np.asarray(ref.f), atol=1e-9)


def test_newton_lockstep_active_bound():
    # the unconstrained optimum x = 2 sits outside the box [-1, 1]
    d = jnp.asarray(np.linspace(1.0, 5.0, N))
    oracle = make_oracle(lambda x, dd: 0.5 * jnp.sum(dd * (x - 2.0) ** 2),
                         data=(d,), with_hessian=True)
    lo, hi = jnp.full(N, -1.0), jnp.full(N, 1.0)
    x0 = jnp.asarray(np.random.RandomState(2).uniform(-1, 1, (16, N)))
    r = solvers.batch_minimize(
        solvers.ProjectedNewton(grad_tol=1e-8), ls.BackTrackingB(), oracle,
        x0, bounds=(lo, hi), max_iter=100)
    assert bool(jnp.all(r.status == 1))
    np.testing.assert_allclose(np.asarray(r.x), np.ones((16, N)), atol=1e-6)


def test_newton_lockstep_nonpd_start():
    # start in a concave region (H not PD): the direction must not emit
    # NaNs, and every lane still converges
    def f(x):
        return jnp.sum(jnp.cosh(x) - 2.0 * jnp.exp(-x * x))

    x0 = jnp.asarray(np.random.RandomState(3).uniform(-0.4, 0.4, (8, 4)))
    r = solvers.batch_minimize(
        solvers.Newton(tol=1e-12), ls.BackTracking(),
        make_oracle(f, with_hessian=True), x0, max_iter=300, max_iter_ls=40)
    assert bool(jnp.all(jnp.isfinite(r.f)))
    assert bool(jnp.all(r.status == 1))


def test_pnorm_descent_exact_preconditioner():
    # P^{-1} = H^{-1}: one step to the minimum (+1 verification pass)
    method = solvers.PnormDescent(grad_tol=1e-6,
                                  inverse_p=jnp.diag(1.0 / DVEC))
    r = solvers.batch_minimize(method, ls.NoSearch(), _oracle(), _x0(),
                               max_iter=200)
    assert bool(jnp.all(r.status == 1))
    assert bool(jnp.all(r.iterations <= 2))
    np.testing.assert_allclose(np.asarray(r.x), np.zeros((B, N)), atol=1e-6)


@pytest.mark.parametrize("batch", [1, 10])
def test_odd_batch_sizes(batch):
    # batches that are not a power of two (or a single lane) need no
    # padding on the lockstep path: results keep the caller's batch axis
    x0 = _x0()[:batch]
    method, search = solvers.GradientDescent(grad_tol=1e-6), ls.BackTracking()
    r = solvers.batch_minimize(method, search, _oracle(), x0,
                               max_iter=3000, max_iter_ls=40)
    assert r.x.shape == (batch, N) and r.pg_norm.shape == (batch,)
    assert bool(jnp.all(r.status == 1))
    _assert_lanes_match(r, _single(method, search, _oracle(), x0, None,
                                   max_iter=3000, max_iter_ls=40))


def test_out_of_domain_status():
    # an objective that is NaN everywhere: every lane exits OUT_OF_DOMAIN
    def f_nan(x, d):
        return jnp.where(jnp.sum(x * x) < 1e6, jnp.nan, 0.0) + 0.0 * d[0]

    r = solvers.batch_minimize(
        solvers.GradientDescent(grad_tol=1e-6), ls.BackTracking(),
        make_oracle(f_nan, data=(DVEC,)), _x0(), max_iter=5, max_iter_ls=4)
    assert bool(jnp.all(r.status == 3))


def test_unknown_keyword_rejected():
    # a typo'd budget must fail loudly, not run with the default
    with pytest.raises(TypeError, match="max_iters"):
        solvers.batch_minimize(
            solvers.GradientDescent(), ls.BackTracking(), _oracle(), _x0(),
            max_iters=5)


def _rosen(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def test_qn_robustness_knobs():
    # scale_b0 + restart_on_degeneracy on Rosenbrock-8: restart mode
    # reaches the minima (median f ~ 1e-14) but certifies the strict 1e-6
    # 2-norm on only some lanes; the rest exit via the stall counter and
    # are honestly labeled STALLED with pg_norm > tol
    xr = jnp.asarray(np.random.RandomState(1).uniform(-2, 2, (16, 8)))
    m = solvers.QuasiNewton(
        tol=1e-6, update="bfgs", scale_b0=True, restart_on_degeneracy=True)
    r = solvers.batch_minimize(m, ls.BackTracking(), make_oracle(_rosen), xr,
                               max_iter=2000, max_iter_ls=40)
    st, pg = np.asarray(r.status), np.asarray(r.pg_norm)
    assert bool(jnp.all((r.status == 1) | (r.status == 6)))
    assert (pg[st == 6] > 1e-6).all()
    assert float(jnp.median(r.f)) < 1e-10


def test_lbfgs_rosenbrock_reaches_a_minimum():
    x0 = jnp.asarray(np.random.RandomState(3).uniform(-2, 2, (8, 20)))
    r = solvers.batch_minimize(
        solvers.LBFGS(tol=1e-5, m=6), ls.MoreThuente(), make_oracle(_rosen),
        x0, max_iter=800, max_iter_ls=40)
    f_vals = np.asarray(r.f)
    assert np.all((f_vals < 1e-8) | (np.abs(f_vals - 3.9866) < 1e-2))


RANDOM_COMBOS = [
    (solvers.SpectralProjectedGradient(grad_tol=1e-6), ls.GLLQuadratic(),
     True),
    # reference-rule GLL on an unbounded method
    (solvers.GradientDescent(grad_tol=1e-5), ls.GLLQuadratic(), False),
    # MINPACK dcsrch on a bounded QN method
    (solvers.BFGSB(tol=1e-6), ls.StrongWolfe(bounded=True), True),
]


@pytest.mark.parametrize("seed", [11, 23, 47])
@pytest.mark.parametrize(
    "method,search,bounded", RANDOM_COMBOS,
    ids=[f"{type(m).__name__}-{type(s).__name__}"
         for m, s, _ in RANDOM_COMBOS])
def test_lockstep_matches_single_random_problems(seed, method, search,
                                                 bounded):
    """Random rotated SPD quadratics with random mixed finite/infinite
    boxes: lockstep and single-instance drivers agree lane for lane."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(N, N))
    Q = jnp.asarray((q * np.logspace(0, 2, N)) @ q.T)
    lo = jnp.asarray(np.where(rng.rand(N) < 0.3, -np.inf,
                              np.sort(rng.uniform(-2, 0, N))))
    hi = jnp.asarray(np.where(rng.rand(N) < 0.3, np.inf,
                              np.sort(rng.uniform(0.3, 2, N))))
    x0 = jnp.asarray(rng.uniform(-2, 2, (B, N)))
    oracle = make_oracle(lambda x, Qm: 0.5 * x @ (Qm @ x), data=(Q,))
    bnds = (lo, hi) if bounded else None
    kw = dict(max_iter=3000, max_iter_ls=40)
    r = solvers.batch_minimize(method, search, oracle, x0, bounds=bnds, **kw)
    _assert_lanes_match(r, _single(method, search, oracle, x0, bnds, **kw),
                        f_atol=1e-8)


def test_gll_stiff_quadratic_converges():
    """The GLL trial update must be the reference's absolute-window
    interpolation (gll_quadratic.rs:78-93), not a relative clip — the clip
    variant limit-cycles under the non-monotone Armijo on stiff
    quadratics."""
    n, batch = 16, 64
    d = jnp.asarray(np.linspace(1.0, 40.0, n))
    x0 = jnp.asarray(np.random.RandomState(0).uniform(-1.4, 2.4, (batch, n)))
    r = solvers.batch_minimize(
        solvers.GradientDescent(grad_tol=1e-4), ls.GLLQuadratic(),
        make_oracle(_quad, data=(d,)), x0, max_iter=300, max_iter_ls=30)
    assert (np.asarray(r.status) == 1).mean() >= 0.95


def test_lbfgs_zero_progress_repair():
    """A descent two-loop direction whose accepted Wolfe step underflows
    the iterate (x + t*d == x) used to leave the state bit-identical and
    wedge the lane at a NON-stationary point forever (Rosenbrock-100 lane
    pinned at pg=9.5).  The zero-progress repair wipes the model and
    retries from steepest descent."""
    x0 = jnp.asarray(
        np.random.RandomState(7).uniform(-2, 2, (32, 100)), jnp.float32)
    r = solvers.batch_minimize(
        solvers.LBFGS(tol=1e-4, m=5), ls.MoreThuente(), make_oracle(_rosen),
        x0, max_iter=600, max_iter_ls=30)
    pg, st = np.asarray(r.pg_norm), np.asarray(r.status)
    # no lane may end wedged far from stationarity; the f32 MT livelock
    # near the local-min basin keeps pg ~ 1e-2, the documented tail
    assert pg[st != 1].max(initial=0.0) < 0.05, pg[st != 1]


def test_mt_approx_wolfe_closes_lbfgs_tail():
    """MoreThuente(approx_wolfe=True) — the Hager-Zhang T2 acceptance —
    eliminates the f32 near-minimum livelock plain MT hits on L-BFGS: all
    lanes certify convergence on the probe."""
    x0 = jnp.asarray(
        np.random.RandomState(7).uniform(-2, 2, (32, 100)), jnp.float32)
    r = solvers.batch_minimize(
        solvers.LBFGS(tol=1e-4, m=5), ls.MoreThuente(approx_wolfe=True),
        make_oracle(_rosen), x0, max_iter=600, max_iter_ls=30)
    assert (np.asarray(r.status) == 1).all()


def test_dcsrch_lockstep_matches_single():
    """MINPACK dcsrch (StrongWolfe): exact iteration counts on the stable
    quadratic, lane for lane, unbounded and bounded."""
    n, batch = 16, 32
    d = jnp.asarray(np.linspace(1.0, 40.0, n))
    oracle = make_oracle(_quad, data=(d,))
    x0 = jnp.asarray(np.random.RandomState(0).uniform(-1.4, 2.4, (batch, n)))
    for method, search, bnds in [
            (solvers.LBFGS(tol=1e-6, m=5), ls.StrongWolfe(), None),
            (solvers.BFGSB(tol=1e-6), ls.StrongWolfe(bounded=True),
             (jnp.full(n, -1.5), jnp.full(n, 2.5)))]:
        kw = dict(max_iter=300, max_iter_ls=30)
        r = solvers.batch_minimize(method, search, oracle, x0, bounds=bnds,
                                   **kw)
        ref = _single(method, search, oracle, x0, bnds, **kw)
        np.testing.assert_array_equal(np.asarray(r.iterations),
                                      np.asarray(ref.iterations))
        _assert_lanes_match(r, ref, x_atol=1e-10)


@pytest.mark.parametrize("method,search", [
    (solvers.SpectralProjectedGradient(grad_tol=1e-8), ls.GLLQuadratic()),
    (solvers.BFGSB(tol=1e-9), ls.BackTrackingB()),
], ids=["spg-gll", "bfgsb-backtrackingb"])
def test_per_lane_bounds(method, search):
    """Per-lane (B, n) boxes (``batched_bounds=True``): each lane solves
    within its own box and lands on its own corner, also for a batch
    that is not a power of two."""
    d = jnp.linspace(1.0, 12.0, N)
    oracle = make_oracle(lambda x, dd: 0.5 * jnp.sum(dd * (x - 1.2) ** 2),
                         data=(d,))
    rng = np.random.RandomState(3)
    lo = jnp.asarray(rng.uniform(-2.0, -1.0, (B, N)))
    hi = jnp.asarray(rng.uniform(0.1, 1.0, (B, N)))
    x0 = jnp.asarray(rng.uniform(-0.9, 0.0, (B, N)))
    expect = np.clip(1.2, np.asarray(lo), np.asarray(hi))
    for size in (B, 10):
        r = solvers.batch_minimize(
            method, search, oracle, x0[:size],
            bounds=(lo[:size], hi[:size]), batched_bounds=True,
            max_iter=500, max_iter_ls=40)
        assert np.isin(np.asarray(r.status), (1, 6)).all()
        assert r.x.shape == (size, N) and r.pg_norm.shape == (size,)
        np.testing.assert_allclose(np.asarray(r.x), expect[:size], atol=1e-6)
