"""Compute-kernel tests: the dense Cholesky solve and the unrolled
small-matrix Cholesky against NumPy, and the quasi-Newton update rules
against the reference's formulas."""

import jax.numpy as jnp
import numpy as np
import pytest

from optimization_solvers_tpu import linesearch as ls, solvers
from optimization_solvers_tpu.core import problems
from optimization_solvers_tpu.core.oracle import make_oracle
from optimization_solvers_tpu.ops.linalg import cholesky_solve, solve_spd
from optimization_solvers_tpu.solvers.quasi_newton import _UPDATES
from optimization_solvers_tpu.ops.smallchol import (
    cholesky_small,
    spd_solve_small,
    spd_solve_small_mat,
)


def _spd(rng, b, n, shift=5.0):
    A = rng.randn(b, n, n)
    return jnp.asarray(A @ np.transpose(A, (0, 2, 1)) + shift * np.eye(n))


def test_cholesky_solve_matches_numpy():
    rng = np.random.RandomState(0)
    H = _spd(rng, 4, 24)
    g = jnp.asarray(rng.randn(4, 24))
    ref = np.linalg.solve(np.asarray(H), np.asarray(g)[..., None])[..., 0]
    np.testing.assert_allclose(cholesky_solve(H, g), ref, atol=1e-10)
    # unbatched and through the solve_spd alias
    np.testing.assert_allclose(solve_spd(H[0], g[0]), ref[0], atol=1e-10)


def test_smallchol_solves():
    rng = np.random.RandomState(1)
    A = np.asarray(_spd(rng, 1, 8))[0]
    b = rng.randn(8)
    Bmat = rng.randn(8, 3)
    L = cholesky_small(jnp.asarray(A))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), atol=1e-10)
    np.testing.assert_allclose(
        spd_solve_small(L, jnp.asarray(b)), np.linalg.solve(A, b), atol=1e-9
    )
    np.testing.assert_allclose(
        spd_solve_small_mat(L, jnp.asarray(Bmat)), np.linalg.solve(A, Bmat),
        atol=1e-9,
    )


def _qn_reference(kind, B, s, y):
    """The reference's update formulas, written as in the Rust sources
    (``bfgs.rs:114-124``, ``dfp.rs:114-120``, ``broyden.rs:114-118``,
    ``sr1_b.rs:143-147``)."""
    sy = s @ y
    if kind == "bfgs":
        rho = 1.0 / sy
        eye = np.eye(len(s))
        return ((eye - rho * np.outer(s, y)) @ B @ (eye - rho * np.outer(y, s))
                + rho * np.outer(s, s))
    if kind == "dfp":
        By = B @ y
        return B + np.outer(s, s) / sy - np.outer(By, By) / (y @ By)
    if kind == "broyden":
        return B + np.outer(s - B @ y, B.T @ s) / sy
    shy = s - B @ y
    return B + np.outer(shy, shy) / (shy @ y)


@pytest.mark.parametrize("kind", ["bfgs", "dfp", "broyden", "sr1"])
def test_qn_updates_match_reference_math(kind):
    rng = np.random.RandomState(2)
    B = np.asarray(_spd(rng, 1, 16, shift=3.0))[0]
    s, y = rng.randn(16), rng.randn(16)
    y = y + 2.0 * s            # keep s.y > 0
    got = _UPDATES[kind](jnp.asarray(B), jnp.asarray(s), jnp.asarray(y),
                         jnp.asarray(s @ y))
    np.testing.assert_allclose(got, _qn_reference(kind, B, s, y), atol=1e-9)


def test_qn_degenerate_pair_freezes_b():
    # a correction pair below tol must leave B untouched (bfgs.rs:104-112)
    method = solvers.QuasiNewton(tol=1e-8, update="bfgs")
    x = jnp.asarray(np.random.RandomState(3).randn(6))
    ev = make_oracle(problems.rosenbrock())(x)
    state = method.init(x, ev, None)
    state = state._replace(B=state.B * 2.0)
    x_new = x + 1e-12
    ev_new = make_oracle(problems.rosenbrock())(x_new)
    out = method.post_step(state, x, ev, None, 1.0, x_new, ev_new, None)
    np.testing.assert_array_equal(out.B, state.B)


def test_qn_bounded_solver_reaches_active_bound():
    # f = x1^2 + 2 x2^2 + x1 x2 on x >= 1: the optimum is the corner (1, 1)
    f = lambda x: x[0] ** 2 + 2.0 * x[1] ** 2 + x[0] * x[1]
    bounds = (jnp.array([1.0, 1.0]), jnp.array([jnp.inf, jnp.inf]))
    r = solvers.minimize(
        solvers.QuasiNewtonB(tol=1e-6), ls.MoreThuenteB(), make_oracle(f),
        jnp.array([5.0, 5.0]), bounds=bounds, max_iter=500)
    assert int(r.status) in (1, 6)
    np.testing.assert_allclose(r.x, [1.0, 1.0], atol=1e-8)


def test_newton_family_via_dispatch_still_converges():
    # the Newton family solves through ops.linalg.cholesky_solve
    res = solvers.minimize(
        solvers.ProjectedNewton(grad_tol=1e-8), ls.BackTrackingB(),
        make_oracle(problems.shifted_quadratic_2d(), with_hessian=True),
        jnp.array([0.0, 0.0]),
        bounds=(jnp.array([-jnp.inf, -jnp.inf]), jnp.array([1.0, 1.0])),
        max_iter=100)
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-6)
