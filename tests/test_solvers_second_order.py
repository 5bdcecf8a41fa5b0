"""Newton-family tests (ref newton/mod.rs:72-164, projected_newton.rs,
spn.rs tests) and the newton_example.rs anchor."""

import jax.numpy as jnp
import numpy as np

from optimization_solvers_tpu.core import problems
from optimization_solvers_tpu.core.oracle import make_oracle
from optimization_solvers_tpu.core.types import Status
from optimization_solvers_tpu import linesearch as ls
from optimization_solvers_tpu import solvers


def _solve(method, search, f, x0, **kw):
    oracle = make_oracle(f, with_hessian=True)
    return solvers.minimize(method, search, oracle, jnp.asarray(x0), **kw)


def test_newton_exp_bowl():
    # examples/newton_example.rs: f = x^2+y^2+exp(x^2+y^2), min f = 1 at 0
    res = _solve(
        solvers.Newton(tol=1e-12),
        ls.BackTracking(c1=1e-4, beta=0.5),
        problems.exp_bowl(),
        [1.0, 1.5],
        max_iter=100,
    )
    assert res.status == Status.CONVERGED
    assert abs(res.f - 1.0) < 1e-6
    np.testing.assert_allclose(res.x, [0.0, 0.0], atol=1e-6)


def test_newton_quadratic_one_step():
    # on a quadratic the (undamped) Newton step is exact
    res = _solve(
        solvers.Newton(tol=1e-12),
        ls.NoSearch(),
        problems.quadratic_2d(999.0),
        [180.0, 152.0],
        max_iter=100,
    )
    assert res.status == Status.CONVERGED
    assert res.f < 1e-12
    assert res.iterations <= 2


def test_newton_singular_hessian_falls_back_to_gd():
    # f = x^4 at 0-curvature start: H singular at x=0 -> fallback -g
    def f(x):
        return x[0] ** 4 + x[1] ** 2

    res = _solve(
        solvers.Newton(tol=1e-10),
        ls.BackTracking(),
        f,
        [0.0, 3.0],  # H = diag(0, 2): singular
        max_iter=200,
    )
    # must not blow up; y-coordinate is driven to 0
    assert abs(res.x[1]) < 1e-4


def test_projected_newton_constrained():
    # projected variant of the shifted quadratic: min at the box corner
    bounds = (jnp.array([-jnp.inf, -jnp.inf]), jnp.array([1.0, 1.0]))
    res = _solve(
        solvers.ProjectedNewton(grad_tol=1e-8),
        ls.BackTrackingB(),
        problems.shifted_quadratic_2d(),
        [0.0, 0.0],
        bounds=bounds,
        max_iter=100,
    )
    assert res.status == Status.CONVERGED
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-6)


def test_spn_constrained():
    bounds = (jnp.array([-1.0, -1.0]), jnp.array([47.0, 47.0]))
    res = _solve(
        solvers.SpectralProjectedNewton(grad_tol=1e-6),
        ls.GLLQuadratic(c1=1e-4, m=5),
        problems.quadratic_2d(90.0),
        [40.0, 30.0],
        bounds=bounds,
        max_iter=1000,
    )
    assert res.status == Status.CONVERGED
    assert res.f < 1e-6


def test_spn_precond_bb_breaks_lambda_freeze():
    """The reference BB update freezes lambda at the inverse Rayleigh
    quotient of the Newton ray (geometric rate 1 - lambda; measured
    identically in f32 and f64 — NOT a precision artifact).  The opt-in
    Newton-metric pair (``precond_bb=True``) restores lambda -> 1 and
    near-one-step convergence; the default stays reference-exact."""
    import numpy as np2

    n, B = 16, 32
    d = jnp.asarray(np2.linspace(1.0, 40.0, n))

    def quad(x):
        return 0.5 * jnp.sum(d * x * x)

    lo, hi = jnp.full(n, -1.5), jnp.full(n, 2.5)
    x0 = jnp.asarray(np2.random.RandomState(0).uniform(-1.4, 2.4, (B, n)))
    oracle = make_oracle(quad, with_hessian=True)

    r_ref = solvers.batch_minimize(
        solvers.SpectralProjectedNewton(grad_tol=1e-6),
        ls.BackTrackingB(), oracle, x0, bounds=(lo, hi),
        max_iter=60, max_iter_ls=30)
    r_pbb = solvers.batch_minimize(
        solvers.SpectralProjectedNewton(grad_tol=1e-6, precond_bb=True),
        ls.BackTrackingB(), oracle, x0, bounds=(lo, hi),
        max_iter=60, max_iter_ls=30)
    st_ref = np.asarray(r_ref.status)
    st_pbb = np.asarray(r_pbb.status)
    # reference semantics: the lambda freeze leaves most lanes unconverged
    # at this budget (documented stall, PARITY.md); the Newton-metric pair
    # converges every lane in a handful of iterations
    assert (st_pbb == int(Status.CONVERGED)).all()
    assert np.median(np.asarray(r_pbb.iterations)) <= 10
    assert (st_ref == int(Status.CONVERGED)).mean() < 0.5


def test_spn_precond_bb_lockstep_matches_single():
    import jax
    import numpy as np2

    n, B = 8, 16
    d = jnp.asarray(np2.linspace(1.0, 12.0, n))
    lo, hi = jnp.full(n, -1.5), jnp.full(n, 2.5)
    x0 = jnp.asarray(np2.random.RandomState(1).uniform(-1.4, 2.4, (B, n)))
    m = solvers.SpectralProjectedNewton(grad_tol=1e-6, precond_bb=True)
    oracle = make_oracle(lambda x, dd: 0.5 * jnp.sum(dd * x * x), data=(d,),
                         with_hessian=True)
    r_l = solvers.batch_minimize(
        m, ls.BackTrackingB(), oracle, x0, bounds=(lo, hi), max_iter=60,
        max_iter_ls=30)
    r_s = jax.jit(jax.vmap(lambda x: solvers.minimize(
        m, ls.BackTrackingB(), oracle, x, bounds=(lo, hi), max_iter=60,
        max_iter_ls=30)))(x0)
    assert (np.asarray(r_l.status) == int(Status.CONVERGED)).all()
    np.testing.assert_array_equal(np.asarray(r_l.iterations),
                                  np.asarray(r_s.iterations))
    np.testing.assert_allclose(
        np.asarray(r_l.x), np.asarray(r_s.x), atol=1e-8)
