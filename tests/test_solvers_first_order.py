"""First-order solver family end-to-end tests, mirroring the reference's
inline unit tests (gamma-family ill-conditioned quadratics, bounded
variants) and examples with their tolerances (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optimization_solvers_tpu.core import problems
from optimization_solvers_tpu.core.oracle import make_oracle
from optimization_solvers_tpu.core.types import Status
from optimization_solvers_tpu import linesearch as ls
from optimization_solvers_tpu import solvers


def _solve(method, search, f, x0, **kw):
    oracle = make_oracle(f, with_hessian=getattr(method, "needs_hessian", False))
    return solvers.minimize(method, search, oracle, jnp.asarray(x0), **kw)


# --- gradient descent (ref gradient_descent.rs:86-179) ---------------------

def test_gd_backtracking_quadratic_gamma90():
    res = _solve(
        solvers.GradientDescent(grad_tol=1e-6),
        ls.BackTracking(c1=1e-4, beta=0.5),
        problems.quadratic_2d(90.0),
        [180.0, 152.0],
        max_iter=1000,
    )
    assert res.status == Status.CONVERGED
    assert abs(res.x[0]) < 1e-6
    assert res.f < 1e-6


def test_gd_morethuente_quadratic_gamma90():
    res = _solve(
        solvers.GradientDescent(grad_tol=1e-6),
        ls.MoreThuente(),
        problems.quadratic_2d(90.0),
        [180.0, 152.0],
        max_iter=1000,
    )
    assert res.status == Status.CONVERGED
    assert abs(res.x[0]) < 1e-6
    assert res.f < 1e-6


def test_gd_example_quadratic():
    # examples/gradient_descent_example.rs: f = x^2 + 2y^2, tol 1e-6,
    # <= 100 iterations (BASELINE.md anchor)
    res = _solve(
        solvers.GradientDescent(grad_tol=1e-6),
        ls.BackTracking(c1=1e-4, beta=0.5),
        problems.example_gd(),
        [10.0, -10.0],
        max_iter=100,
    )
    assert res.status == Status.CONVERGED
    assert res.f < 1e-6
    assert res.iterations < 100


def test_gd_max_iter_status():
    res = _solve(
        solvers.GradientDescent(grad_tol=1e-6),
        ls.BackTracking(),
        problems.quadratic_2d(1e9),
        [180.0, 152.0],
        max_iter=3,
    )
    assert res.status == Status.MAX_ITER_REACHED
    assert res.iterations == 3


def test_gd_out_of_domain():
    def f(x):
        return jnp.where(x[0] < 0.5, -jnp.log(x[0]) * 0.0 + jnp.nan, (x[0] - 1.0) ** 2)

    res = _solve(
        solvers.GradientDescent(grad_tol=1e-6),
        ls.BackTracking(),
        lambda x: jnp.sqrt(x[0]) * jnp.nan,  # oracle always NaN
        [1.0],
        max_iter=10,
    )
    assert res.status == Status.OUT_OF_DOMAIN


# --- coordinate descent -----------------------------------------------------

def test_coordinate_descent_example():
    # examples/coordinate_descent_example.rs: f = x1^2 + 2x2^2 + 3x3^2
    res = _solve(
        solvers.CoordinateDescent(grad_tol=1e-6),
        ls.BackTracking(c1=1e-4, beta=0.5),
        lambda x: x[0] ** 2 + 2.0 * x[1] ** 2 + 3.0 * x[2] ** 2,
        [10.0, -5.0, 4.0],
        max_iter=2000,
    )
    assert res.status == Status.CONVERGED
    assert res.f < 1e-6


def test_coordinate_descent_negative_gradient_start():
    # with a negative-gradient leading coordinate (where the reference's
    # signum quirk would ascend) the fixed Gauss-Southwell rule still works
    res = _solve(
        solvers.CoordinateDescent(grad_tol=1e-6),
        ls.BackTracking(),
        problems.quadratic_2d(90.0),
        [-180.0, -152.0],
        max_iter=5000,
    )
    assert res.status == Status.CONVERGED
    assert res.f < 1e-6


# --- p-norm descent ----------------------------------------------------------

def test_pnorm_descent_with_exact_preconditioner():
    # examples/pnorm_descent_example.rs: f = x^2 + 4 y^2; P = hessian
    inv_p = jnp.linalg.inv(jnp.array([[2.0, 0.0], [0.0, 8.0]]))
    res = _solve(
        solvers.PnormDescent(grad_tol=1e-6, inverse_p=inv_p),
        ls.MoreThuente(),
        lambda x: x[0] ** 2 + 4.0 * x[1] ** 2,
        [15.0, -7.0],
        max_iter=100,
    )
    assert res.status == Status.CONVERGED
    assert res.f < 1e-6
    # exact preconditioner => Newton-like convergence in very few steps
    assert res.iterations <= 5


# --- projected gradient descent ---------------------------------------------

def test_pgd_constrained_minimum():
    # examples/projected_gradient_example.rs: f = (x-2)^2 + (y-3)^2 with
    # upper bound 1 on both coords -> min 5 at (1, 1)
    bounds = (jnp.array([-jnp.inf, -jnp.inf]), jnp.array([1.0, 1.0]))
    res = _solve(
        solvers.ProjectedGradientDescent(grad_tol=1e-8),
        ls.BackTrackingB(c1=1e-4, beta=0.5),
        problems.shifted_quadratic_2d(),
        [5.0, 5.0],
        bounds=bounds,
        max_iter=1000,
    )
    assert res.status == Status.CONVERGED
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-6)
    assert abs(res.f - 5.0) < 1e-6


def test_pgd_unbounded_box_matches_gd():
    bounds = (jnp.full(2, -jnp.inf), jnp.full(2, jnp.inf))
    res = _solve(
        solvers.ProjectedGradientDescent(grad_tol=1e-8),
        ls.BackTrackingB(),
        problems.example_gd(),
        [10.0, -10.0],
        bounds=bounds,
        max_iter=1000,
    )
    assert res.status == Status.CONVERGED
    assert res.f < 1e-12


# --- SPG ----------------------------------------------------------------------

def test_spg_gamma1e9_with_active_bound():
    # spg.rs:147-205: gamma=1e9 quadratic, lower bounds [-1, 47] (x1's lower
    # bound ACTIVE at the constrained optimum (0, 47)), GLL search
    gamma = 1e9
    bounds = (jnp.array([-1.0, 47.0]), jnp.array([jnp.inf, jnp.inf]))
    res = _solve(
        solvers.SpectralProjectedGradient(grad_tol=1e-12),
        ls.GLLQuadratic(c1=1e-4, m=10),
        problems.quadratic_2d(gamma),
        [180.0, 152.0],
        bounds=bounds,
        max_iter=10000,
        max_iter_ls=1000,
    )
    assert res.status == Status.CONVERGED
    assert abs(res.x[0]) < 1e-6
    assert res.x[1] == 47.0  # active bound; projected gradient masks it


def test_spg_unconstrained_bowl():
    # examples/spg_example.rs objective
    big = jnp.full(2, jnp.inf)
    res = _solve(
        solvers.SpectralProjectedGradient(grad_tol=1e-6),
        ls.GLLQuadratic(),
        problems.exp_bowl(),
        [1.5, -1.2],
        bounds=(-big, big),
        max_iter=1000,
    )
    assert res.status == Status.CONVERGED
    assert abs(res.f - 1.0) < 1e-6


# --- batching ----------------------------------------------------------------

def test_batch_minimize_vmap_lockstep_masking():
    # per-lane convergence: easy and hard instances in one batch must match
    # their single-instance solves exactly
    f = problems.quadratic_2d(90.0)
    oracle = make_oracle(f)
    method = solvers.GradientDescent(grad_tol=1e-10)
    search = ls.BackTracking()
    x0s = jnp.array([[180.0, 152.0], [1.0, 1.0], [0.0, 0.0], [-7.0, 3.0]])
    batched = solvers.batch_minimize(method, search, oracle, x0s, max_iter=1000)
    for i in range(x0s.shape[0]):
        single = solvers.minimize(method, search, oracle, x0s[i], max_iter=1000)
        np.testing.assert_allclose(batched.x[i], single.x, rtol=0, atol=0)
        assert batched.iterations[i] == single.iterations
        assert batched.status[i] == single.status
    assert batched.iterations[2] == 0  # already-optimal lane takes no steps


def test_jit_wrapped_minimize():
    f = problems.example_gd()
    oracle = make_oracle(f)
    solve = solvers.make_solver(
        solvers.GradientDescent(grad_tol=1e-8), ls.BackTracking(), oracle,
        max_iter=200,
    )
    res = solve(jnp.array([10.0, -10.0]))
    assert res.status == Status.CONVERGED


def test_spg_alternate_bb_closes_f32_cycling_tail():
    """Config-3 tail regression (VERDICT round-3 item 3): on the cond-1e3
    box quadratic in f32, the reference BB1 scalar falls into a lambda
    4-cycle on ~1.5% of lanes and misses the 1000-iteration budget (f still
    decreasing ~1%/iter at exit — BB geometry, not an acceptance freeze;
    the same lanes all converge by ~1819 iterations, and f64 shows the same
    heavy tail).  The opt-in bb_variant="alternate" (BB1/BB2 alternation)
    converges the measured tail lanes in median 274 iterations.  Lane
    indices are from the 2048-start seed-3 sweep."""
    n = 64
    d = jnp.asarray(np.logspace(0, 3, n), jnp.float32)
    oracle = make_oracle(lambda x, diag: 0.5 * jnp.sum(diag * x * x),
                         data=(d,))
    lo = jnp.full((n,), -2.0, jnp.float32)
    hi = jnp.full((n,), 2.0, jnp.float32)
    full = np.random.RandomState(3).uniform(-2, 2, (2048, n))
    xb = jnp.asarray(full[[77, 194, 213, 250]], jnp.float32)

    kw = dict(bounds=(lo, hi), max_iter=1000, max_iter_ls=30)
    r_ref = solvers.batch_minimize(
        solvers.SpectralProjectedGradient(grad_tol=1e-4), ls.GLLQuadratic(),
        oracle, xb, **kw)
    assert (np.asarray(r_ref.status) == 2).all()  # the documented tail
    r_abb = solvers.batch_minimize(
        solvers.SpectralProjectedGradient(grad_tol=1e-4,
                                          bb_variant="alternate"),
        ls.GLLQuadratic(), oracle, xb, **kw)
    assert (np.asarray(r_abb.status) == 1).all()
    assert (np.asarray(r_abb.iterations) < 1000).all()
    assert (np.asarray(r_abb.pg_norm) <= 1e-4).all()


def test_spg_alternate_bb_lockstep_matches_single():
    """The alternate-BB path in the lockstep batched driver must reproduce
    the single-instance trajectories lane for lane in f32."""
    import jax

    n = 16
    d = jnp.asarray(np.logspace(0, 2, n), jnp.float32)

    def quad(x, diag):
        return 0.5 * jnp.sum(diag * x * x)

    lo = jnp.full((n,), -1.5, jnp.float32)
    hi = jnp.full((n,), 2.0, jnp.float32)
    x0 = jnp.asarray(np.random.RandomState(7).uniform(-1.5, 2, (16, n)),
                     jnp.float32)
    m = solvers.SpectralProjectedGradient(grad_tol=1e-5,
                                          bb_variant="alternate")
    oracle = make_oracle(quad, data=(d,))
    r_l = solvers.batch_minimize(
        m, ls.GLLQuadratic(), oracle, x0, bounds=(lo, hi), max_iter=2000,
        max_iter_ls=30)
    r_s = jax.jit(jax.vmap(lambda x: solvers.minimize(
        m, ls.GLLQuadratic(), oracle, x, bounds=(lo, hi), max_iter=2000,
        max_iter_ls=30)))(x0)
    # BB dynamics are chaotic: the two compiled programs may sum in other
    # orders and part in iteration COUNT while agreeing semantically —
    # assert the semantic invariants (both converge, both certify pg,
    # same optimum)
    np.testing.assert_array_equal(np.asarray(r_l.status),
                                  np.asarray(r_s.status))
    assert (np.asarray(r_l.status) == 1).all()
    assert (np.asarray(r_l.pg_norm) <= 1e-5).all()
    np.testing.assert_allclose(np.asarray(r_l.x), np.asarray(r_s.x),
                               atol=1e-5)
    assert np.allclose(np.asarray(r_l.iterations),
                       np.asarray(r_s.iterations), rtol=0.4)


def test_spg_bb_variant_validated():
    import pytest

    with pytest.raises(ValueError, match="bb_variant"):
        solvers.SpectralProjectedGradient(bb_variant="bb3")
