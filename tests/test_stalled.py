"""Status.STALLED: the quasi-Newton s/y-too-close exit at a non-KKT point
(VERDICT round-3 item 5).

The reference reports plain success when the iterate stops moving even if
the gradient test never passed (``bfgs.rs:64-76`` / ``bfgs_b.rs:92-104``);
``SolveResult.pg_norm`` made those lanes *measurable* (round 3) and
``Status.STALLED`` now makes them *identifiable from the status alone* —
on the single-instance and lockstep paths.  The reference-parity API layer
(api.py) still treats the exit as success, exactly like the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np

from optimization_solvers_tpu import linesearch as ls, solvers
from optimization_solvers_tpu.core.numerics import box_projection
from optimization_solvers_tpu.core.oracle import make_oracle
from optimization_solvers_tpu.core.types import Status


def _stall_problem(seed=47, n=5):
    """Deterministic bounded-QN non-KKT stall (found by the property sweep
    that first documented the inherited exit, tests/test_property.py):
    BFGSB + BackTrackingB stalls on an active bound after 4 iterations at
    pg ~ 1.47 with mixed finite/infinite bounds."""
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n)
    H = A @ A.T + n * np.eye(n)
    b = rng.randn(n) * 1.5
    Hj, bj = jnp.asarray(H), jnp.asarray(b)

    def f(x):
        return 0.5 * x @ (Hj @ x) - bj @ x

    x0 = jnp.asarray(rng.uniform(-1.5, 1.5, n))
    rng2 = np.random.RandomState(seed + 5)
    lo = jnp.asarray(np.where(rng2.rand(n) < 0.4, -np.inf,
                              np.sort(rng2.uniform(-2, 0, n))))
    hi = jnp.asarray(np.where(rng2.rand(n) < 0.4, np.inf,
                              np.sort(rng2.uniform(0.3, 2, n))))
    return f, x0, (lo, hi)


def test_stalled_unfused_single():
    f, x0, bounds = _stall_problem()
    res = solvers.minimize(
        solvers.BFGSB(tol=1e-7), ls.BackTrackingB(),
        make_oracle(f), x0, bounds=bounds, max_iter=3000, max_iter_ls=40)
    assert int(res.status) == int(Status.STALLED)
    assert bool(res.stalled) and not bool(res.converged)
    assert float(res.pg_norm) > 1e-4  # genuinely non-KKT
    # the exit point is the reference's exit point: s/y stalled, g not small
    assert float(jnp.linalg.norm(res.g)) > 1e-7


def test_stalled_lockstep_batch_and_summary():
    f, x0, bounds = _stall_problem()
    # lane 0 stalls; a lane started AT the constrained optimum certifies
    from optimization_solvers_tpu.utils.telemetry import summarize

    xb = jnp.stack([x0, x0 + 0.01])
    res = solvers.batch_minimize(
        solvers.BFGSB(tol=1e-7), ls.BackTrackingB(), make_oracle(f), xb,
        bounds=bounds, max_iter=3000, max_iter_ls=40)
    st = np.asarray(res.status)
    assert int(st[0]) == int(Status.STALLED)
    stats = summarize(res)
    assert stats["stalled"] == int((st == int(Status.STALLED)).sum()) >= 1


def test_stalled_lockstep_data_oracle_parity():
    f, x0, bounds = _stall_problem()
    # the same problem with its arrays as explicit problem data: every
    # lane of an identical-start batch must stall like the closure form
    rng = np.random.RandomState(47)
    A = rng.randn(5, 5)
    Hj = jnp.asarray(A @ A.T + 5 * np.eye(5))
    bj = jnp.asarray(rng.randn(5) * 1.5)

    def f_c(x, H, b):
        return 0.5 * x @ (H @ x) - b @ x

    xb = jnp.broadcast_to(x0, (8, x0.shape[0]))
    res = solvers.batch_minimize(
        solvers.BFGSB(tol=1e-7), ls.BackTrackingB(),
        make_oracle(f_c, data=(Hj, bj)), xb, bounds=bounds,
        max_iter=3000, max_iter_ls=40)
    assert (np.asarray(res.status) == int(Status.STALLED)).all()
    assert (np.asarray(res.pg_norm) > 1e-4).all()


def test_stall_at_kkt_point_stays_converged():
    """A lane that stalls at a CERTIFIED stationary point (active bound
    where the gradient pushes outward, so pg = 0) keeps CONVERGED — the
    re-label only fires when pg_norm exceeds tol."""
    d = jnp.asarray([1.0, 4.0])

    def f(x):
        return 0.5 * jnp.sum(d * (x - 2.0) ** 2)  # optimum x = 2, outside

    lo, hi = jnp.full(2, -1.0), jnp.full(2, 1.0)
    x0 = jnp.asarray([0.5, -0.5])
    res = solvers.minimize(
        solvers.BFGSB(tol=1e-7), ls.BackTrackingB(), make_oracle(f), x0,
        bounds=(lo, hi), max_iter=500, max_iter_ls=40)
    # constrained optimum is the corner (1, 1): pg = 0 there, raw ||g|| >> 0
    assert int(res.status) == int(Status.CONVERGED), int(res.status)
    assert float(res.pg_norm) <= 1e-6
    assert float(jnp.linalg.norm(res.g)) > 1.0  # 2-norm test never passed
    np.testing.assert_allclose(np.asarray(res.x), [1.0, 1.0], atol=1e-6)


def test_stalled_is_success_in_reference_api():
    """api.py mirrors the reference surface: the stall exit is Ok(())
    (bfgs_b.rs:92-104) — no exception, solver state updated."""
    from optimization_solvers_tpu import api

    f, x0, bounds = _stall_problem()
    solver = api.BFGSB(1e-7, x0, bounds[0], bounds[1])
    solver.minimize(ls.BackTrackingB(), make_oracle(f),
                    max_iter_solver=3000, max_iter_line_search=40)
    assert int(solver.result.status) == int(Status.STALLED)


def test_non_qn_methods_never_stall_label():
    """The re-label is scoped to the QN family: gradient-descent-family
    exits keep their reference statuses."""
    d = jnp.asarray([1.0, 10.0])
    oracle = make_oracle(lambda x: 0.5 * jnp.sum(d * x * x))
    res = solvers.minimize(solvers.GradientDescent(grad_tol=1e-6),
                           ls.BackTracking(), oracle, jnp.asarray([1.0, 1.0]))
    assert int(res.status) == int(Status.CONVERGED)
