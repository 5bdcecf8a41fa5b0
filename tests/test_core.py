"""Core layer tests: numerics (ref number.rs), FuncEval, oracle factory."""

import jax
import jax.numpy as jnp
import numpy as np

from optimization_solvers_tpu.core.numerics import (
    box_projection,
    infinity_norm,
    projected_gradient,
    rust_clamp,
    rust_max,
    rust_min,
)
from optimization_solvers_tpu.core.oracle import ensure_oracle, make_oracle
from optimization_solvers_tpu.core.types import Status
from optimization_solvers_tpu.core.types import FuncEval
from optimization_solvers_tpu.core import problems


def test_box_projection():
    x = jnp.array([-3.0, 0.5, 7.0])
    lo = jnp.array([-1.0, -1.0, -1.0])
    hi = jnp.array([1.0, 1.0, 1.0])
    np.testing.assert_allclose(box_projection(x, lo, hi), [-1.0, 0.5, 1.0])


def test_infinity_norm():
    assert infinity_norm(jnp.array([1.0, -5.0, 3.0])) == 5.0


def test_projected_gradient_masks_active_bounds():
    # ls_solver.rs:121-133: zero components pushing against an active bound
    x = jnp.array([0.0, 1.0, 0.5])
    lo = jnp.array([0.0, 0.0, 0.0])
    hi = jnp.array([1.0, 1.0, 1.0])
    g = jnp.array([2.0, -2.0, 2.0])  # pushing out at lower(0) / upper(1)
    pg = projected_gradient(g, x, lo, hi)
    np.testing.assert_allclose(pg, [0.0, 0.0, 2.0])
    # gradients pointing inward are kept
    g2 = jnp.array([-2.0, 2.0, 2.0])
    np.testing.assert_allclose(projected_gradient(g2, x, lo, hi), g2)


def test_rust_min_max_nan_semantics():
    nan = jnp.float64(jnp.nan)
    assert rust_min(nan, jnp.float64(2.0)) == 2.0
    assert rust_max(nan, jnp.float64(2.0)) == 2.0
    assert rust_min(jnp.float64(1.0), nan) == 1.0
    assert jnp.isnan(rust_min(nan, nan))
    assert rust_clamp(nan, 0.0, 5.0) == 0.0
    assert rust_clamp(jnp.float64(7.0), 0.0, 5.0) == 5.0


def test_make_oracle_grad_and_hessian():
    f = problems.quadratic_2d(90.0)
    oracle = make_oracle(f, with_hessian=True)
    x = jnp.array([2.0, 3.0])
    ev = oracle(x)
    assert abs(ev.f - 0.5 * (4.0 + 90.0 * 9.0)) < 1e-12
    np.testing.assert_allclose(ev.g, [2.0, 270.0])
    np.testing.assert_allclose(ev.hessian, [[1.0, 0.0], [0.0, 90.0]])
    # value-only path skips gradient work but agrees
    assert oracle.value(x) == ev.f


def test_ensure_oracle_wraps_analytic_closure():
    # the reference seam: user-supplied analytic (f, g) closures
    def analytic(x):
        return FuncEval(0.5 * (x[0] ** 2 + 90.0 * x[1] ** 2),
                        jnp.array([x[0], 90.0 * x[1]]))

    oracle = ensure_oracle(analytic)
    ev = oracle(jnp.array([1.0, 1.0]))
    assert abs(ev.f - 45.5) < 1e-12
    np.testing.assert_allclose(ev.g, [1.0, 90.0])


def test_problems_known_minima():
    ros = problems.rosenbrock()
    assert ros(jnp.ones(100)) == 0.0
    bowl = exp = problems.exp_bowl()
    assert exp(jnp.zeros(2)) == 1.0


def test_make_oracle_explicit_problem_data():
    # data=(...) keeps problem arrays out of closures; the oracle must
    # behave identically to the closure form
    d = jnp.asarray(np.linspace(1.0, 4.0, 8))
    oracle = make_oracle(lambda x, diag: 0.5 * jnp.sum(diag * x * x),
                         data=(d,))
    x = jnp.asarray(np.arange(8.0))
    ev = oracle(x)
    closure = make_oracle(lambda x: 0.5 * jnp.sum(d * x * x))
    ev_c = closure(x)
    assert float(ev.f) == float(ev_c.f)
    np.testing.assert_array_equal(ev.g, ev_c.g)
    assert float(oracle.value(x)) == float(ev.f)


def test_batch_minimize_with_data_oracle():
    from optimization_solvers_tpu import linesearch as ls, solvers

    d = jnp.asarray(np.logspace(0, 2, 16))
    oracle = make_oracle(lambda x, diag: 0.5 * jnp.sum(diag * x * x),
                         data=(d,))
    x0 = jnp.asarray(np.random.RandomState(0).uniform(-2, 2, (4, 16)))
    res = solvers.batch_minimize(
        solvers.SpectralProjectedGradient(grad_tol=1e-6), ls.GLLQuadratic(),
        oracle, x0, bounds=(jnp.full(16, -2.0), jnp.full(16, 2.0)),
        max_iter=2000)
    assert int((res.status == 1).sum()) == 4
    np.testing.assert_allclose(np.asarray(res.x), np.zeros((4, 16)),
                               atol=1e-5)


def test_solve_result_pg_norm_unbounded():
    """SolveResult.pg_norm = ||g||_inf for unbounded solves; stationary()
    agrees with the convergence tolerance."""
    import jax

    from optimization_solvers_tpu import linesearch as ls, solvers
    from optimization_solvers_tpu.core.oracle import make_oracle

    oracle = make_oracle(problems.example_gd())
    res = jax.jit(lambda x0: solvers.minimize(
        solvers.GradientDescent(grad_tol=1e-7), ls.BackTracking(), oracle,
        x0, max_iter=500))(jnp.asarray([10.0, -10.0]))
    assert res.pg_norm is not None
    np.testing.assert_allclose(float(res.pg_norm),
                               float(jnp.max(jnp.abs(res.g))))
    assert bool(res.stationary(1e-7))


def test_solve_result_pg_norm_bounded_active():
    """At an active bound, pg_norm measures the PROJECTED gradient: a lane
    converged onto the boundary is stationary even with a large raw
    gradient."""
    import jax

    from optimization_solvers_tpu.solvers.lbfgsb import (
        LbfgsbConfig, lbfgsb_minimize)
    from optimization_solvers_tpu.core.oracle import make_oracle

    # min (x-2)^2 + (y-3)^2 s.t. x,y <= 1 -> (1,1): raw g = (-2, -4)
    f = problems.shifted_quadratic_2d()
    res = jax.jit(lambda x0: lbfgsb_minimize(
        make_oracle(f), x0, jnp.full(2, -10.0), jnp.full(2, 1.0),
        LbfgsbConfig(pgtol=1e-8, factr=10.0, max_iter=200)))(jnp.zeros(2))
    assert int(res.status) == int(Status.CONVERGED)
    assert float(res.pg_norm) <= 1e-8          # KKT at the bound
    assert float(jnp.max(jnp.abs(res.g))) > 1.0  # raw gradient is NOT small
    assert bool(res.stationary(1e-8))


def test_batch_minimize_pg_norm_per_lane():
    from optimization_solvers_tpu import linesearch as ls, solvers
    from optimization_solvers_tpu.core.oracle import make_oracle

    oracle = make_oracle(problems.rosenbrock())
    x0 = jnp.asarray(np.random.RandomState(0).uniform(-2, 2, (8, 6)))
    res = solvers.batch_minimize(
        solvers.LBFGS(tol=1e-7, m=5), ls.MoreThuente(), oracle, x0,
        max_iter=500)
    assert res.pg_norm.shape == (8,)
    conv = np.asarray(res.status) == int(Status.CONVERGED)
    assert np.all(np.asarray(res.pg_norm)[conv] < 1e-7)
