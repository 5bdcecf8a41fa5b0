"""Lockstep batched driver parity: batch_minimize must agree
LANE-FOR-LANE (bitwise on x, and on iteration counts and statuses) with
independent single-instance minimize() runs, for every method family and
search.  This pins the semantics of the default batched path
(solvers/driver.py:_batch_minimize_lockstep): frozen lanes keep their
exact exit state while other lanes continue."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optimization_solvers_tpu import linesearch as ls, solvers
from optimization_solvers_tpu.core.oracle import make_oracle

N, B = 6, 5
DVEC = jnp.asarray(np.linspace(1.0, 40.0, N))


def _oracle(hessian=False):
    return make_oracle(lambda x: 0.5 * jnp.sum(DVEC * x * x),
                       with_hessian=hessian)


BOUNDS = (jnp.full(N, -1.5), jnp.full(N, 2.5))

COMBOS = [
    (solvers.GradientDescent(grad_tol=1e-7), ls.BackTracking(), False, False),
    (solvers.CoordinateDescent(grad_tol=1e-7), ls.GLLQuadratic(), False, False),
    (solvers.SpectralProjectedGradient(grad_tol=1e-7), ls.GLLQuadratic(),
     True, False),
    (solvers.ProjectedGradientDescent(grad_tol=1e-7), ls.BackTrackingB(),
     True, False),
    (solvers.NonlinearCG(grad_tol=1e-7, variant="fr"), ls.BackTracking(),
     False, False),
    (solvers.BFGS(tol=1e-8), ls.MoreThuente(), False, False),
    (solvers.DFP(tol=1e-8), ls.BackTracking(), False, False),
    (solvers.BFGSB(tol=1e-8), ls.BackTrackingB(), True, False),
    (solvers.Newton(tol=1e-10), ls.NoSearch(), False, True),
    (solvers.ProjectedNewton(grad_tol=1e-8), ls.BackTrackingB(), True, True),
    (solvers.SpectralProjectedNewton(grad_tol=1e-8), ls.BackTrackingB(),
     True, True),
    (solvers.LBFGS(tol=1e-8, m=4), ls.StrongWolfe(), False, False),
]


@pytest.mark.parametrize(
    "method,search,bounded,needs_h", COMBOS,
    ids=[f"{type(m).__name__}-{type(s).__name__}" for m, s, _, _ in COMBOS],
)
def test_lockstep_matches_single(method, search, bounded, needs_h):
    oracle = _oracle(hessian=needs_h)
    bounds = BOUNDS if bounded else None
    # mixed difficulty so lanes converge at different iterations: near the
    # optimum, mid-range, and far corners
    rng = np.random.RandomState(3)
    x0s = jnp.asarray(np.vstack([
        0.01 * rng.randn(1, N),
        rng.uniform(-0.5, 0.5, (2, N)),
        rng.uniform(-2, 2.5, (2, N)),
    ]))
    batched = solvers.batch_minimize(
        method, search, oracle, x0s, bounds=bounds, max_iter=400)
    for i in range(B):
        single = solvers.minimize(
            method, search, oracle, x0s[i], bounds=bounds, max_iter=400)
        # near-bitwise: XLA may reassociate reductions differently between
        # the vmapped and scalar lowerings (observed: last-ulp drift in the
        # dcsrch Wolfe search), so allow ~1 ulp of relative slack
        np.testing.assert_allclose(
            np.asarray(batched.x[i]), np.asarray(single.x),
            rtol=1e-12, atol=1e-18,
            err_msg=f"lane {i} iterate diverged")
        assert int(batched.iterations[i]) == int(single.iterations), (
            f"lane {i}: {int(batched.iterations[i])} vs "
            f"{int(single.iterations)} iterations")
        assert int(batched.status[i]) == int(single.status)


def test_lockstep_unroll_bitexact():
    """lockstep_loop's unroll knob must be EXACTLY semantics-preserving:
    identical trajectories, iteration counts, and statuses for any unroll,
    including non-divisible max_iter budgets."""
    import dataclasses

    from optimization_solvers_tpu.core import problems
    from optimization_solvers_tpu.solvers.lbfgsb import (
        LbfgsbConfig, lbfgsb_batch_minimize)

    n, B = 12, 8
    oracle = make_oracle(problems.rosenbrock())
    x0 = jnp.asarray(np.random.RandomState(5).uniform(-2, 2, (B, n)))
    lo, hi = jnp.full(n, -2.0), jnp.full(n, 2.0)
    cfg1 = LbfgsbConfig(m=5, pgtol=1e-7, factr=10.0, max_iter=51)
    r1 = lbfgsb_batch_minimize(oracle, x0, lo, hi, cfg1)
    for u in (2, 3):
        ru = lbfgsb_batch_minimize(
            oracle, x0, lo, hi, dataclasses.replace(cfg1, lockstep_unroll=u))
        np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(ru.x))
        np.testing.assert_array_equal(
            np.asarray(r1.iterations), np.asarray(ru.iterations))
        np.testing.assert_array_equal(
            np.asarray(r1.status), np.asarray(ru.status))
    # general API surface: the kwarg routes through batch_minimize
    r_gen1 = solvers.batch_minimize(
        solvers.GradientDescent(grad_tol=1e-6), ls.BackTracking(),
        make_oracle(problems.example_gd()),
        jnp.asarray(np.random.RandomState(2).uniform(-5, 5, (8, 2))),
        max_iter=33)
    r_gen2 = solvers.batch_minimize(
        solvers.GradientDescent(grad_tol=1e-6), ls.BackTracking(),
        make_oracle(problems.example_gd()),
        jnp.asarray(np.random.RandomState(2).uniform(-5, 5, (8, 2))),
        max_iter=33, unroll=4)
    np.testing.assert_array_equal(np.asarray(r_gen1.x), np.asarray(r_gen2.x))
    np.testing.assert_array_equal(
        np.asarray(r_gen1.iterations), np.asarray(r_gen2.iterations))
