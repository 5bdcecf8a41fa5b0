"""Auxiliary subsystem tests: checkpoint/resume, profiling timer, and
differentiable (implicit) solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optimization_solvers_tpu import linesearch as ls, solvers
from optimization_solvers_tpu.core import problems
from optimization_solvers_tpu.core.oracle import make_oracle
from optimization_solvers_tpu.utils import load_state, save_state, wall_timer


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    oracle = make_oracle(problems.quadratic_2d(90.0))
    method = solvers.GradientDescent(grad_tol=1e-10)
    search = ls.BackTracking()
    init_fn, keep_going, step_fn = solvers.make_step(method, search, oracle)

    # uninterrupted: 40 steps
    c_ref = init_fn(jnp.array([180.0, 152.0]))
    for _ in range(40):
        c_ref = step_fn(c_ref)

    # interrupted at 15, checkpointed, resumed for 25 more
    c = init_fn(jnp.array([180.0, 152.0]))
    for _ in range(15):
        c = step_fn(c)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, c)
    c2 = load_state(path, like=init_fn(jnp.array([180.0, 152.0])))
    for _ in range(25):
        c2 = step_fn(c2)

    np.testing.assert_allclose(c2.x, c_ref.x, atol=0)
    assert int(c2.k) == int(c_ref.k) == 40


def test_checkpoint_rejects_wrong_shape(tmp_path):
    oracle = make_oracle(problems.quadratic_2d(1.0))
    init_fn, _, _ = solvers.make_step(
        solvers.GradientDescent(grad_tol=1e-8), ls.BackTracking(), oracle)
    c = init_fn(jnp.array([1.0, 2.0]))
    path = str(tmp_path / "ckpt.npz")
    save_state(path, c)
    bad_like = init_fn(jnp.array([1.0, 2.0, 3.0]))
    try:
        load_state(path, like=bad_like)
        assert False, "expected shape mismatch error"
    except ValueError:
        pass


def test_wall_timer_fences():
    out = {}
    x = jnp.ones((64, 64))
    with wall_timer(out, fence=x @ x):
        _ = x @ x
    assert out["seconds"] > 0


def test_implicit_gradient_matches_analytic():
    # f(x, theta) = 0.5 ||x - A theta||^2 + 0.5 lam ||x||^2
    # x*(theta) = A theta / (1 + lam);  d(sum x*)/dtheta = A^T 1 / (1 + lam)
    A = jnp.array([[2.0, 0.5], [0.0, 1.5], [1.0, 1.0]])
    lam = 0.3

    def f(x, theta):
        r = x - A @ theta
        return 0.5 * r @ r + 0.5 * lam * x @ x

    def solve_fn(theta, x0):
        oracle = make_oracle(lambda x: f(x, theta))
        return solvers.minimize(
            solvers.BFGS(tol=1e-12), ls.StrongWolfe(c1=1e-4, c2=0.9),
            oracle, x0, max_iter=200).x

    x_star = solvers.make_implicit_solver(f, solve_fn)
    theta = jnp.array([0.7, -1.2])
    x0 = jnp.zeros(3)

    # value check
    np.testing.assert_allclose(
        x_star(theta, x0), (A @ theta) / (1 + lam), atol=1e-8)

    # gradient check
    g = jax.grad(lambda th: jnp.sum(x_star(th, x0)))(theta)
    np.testing.assert_allclose(g, A.T @ jnp.ones(3) / (1 + lam), atol=1e-6)


def test_nonlinear_cg_variants():
    oracle = make_oracle(problems.rosenbrock())
    x0 = jnp.full(20, -1.2)
    for variant in ("fr", "pr+", "hs"):
        res = solvers.minimize(
            solvers.NonlinearCG(grad_tol=1e-5, variant=variant),
            ls.StrongWolfe(c1=1e-4, c2=0.4),
            oracle, x0, max_iter=5000)
        assert int(res.status) == 1, variant
        np.testing.assert_allclose(res.x, np.ones(20), atol=1e-3,
                                   err_msg=variant)
    # DY is conservative on narrow valleys; exercise it on a quadratic
    res = solvers.minimize(
        solvers.NonlinearCG(grad_tol=1e-8, variant="dy"),
        ls.StrongWolfe(c1=1e-4, c2=0.1),
        make_oracle(problems.quadratic_2d(90.0)),
        jnp.array([180.0, 152.0]), max_iter=500)
    assert int(res.status) == 1


def test_nonlinear_cg_quadratic_fast():
    # on an SPD quadratic, CG with exact-ish line search converges in
    # far fewer iterations than gradient descent
    f = problems.quadratic_2d(90.0)
    oracle = make_oracle(f)
    cg = solvers.minimize(
        solvers.NonlinearCG(grad_tol=1e-8, variant="pr+"),
        ls.StrongWolfe(c1=1e-4, c2=0.1), oracle,
        jnp.array([180.0, 152.0]), max_iter=200)
    gd = solvers.minimize(
        solvers.GradientDescent(grad_tol=1e-8), ls.BackTracking(), oracle,
        jnp.array([180.0, 152.0]), max_iter=2000)
    assert int(cg.status) == 1
    assert int(cg.iterations) < int(gd.iterations)


def test_implicit_bounded_active_set_gradients():
    # x*(p) = clip(p, l, u): interior coords have dx*/dp = 1, coords pinned
    # at a bound have 0 (strict complementarity)
    from optimization_solvers_tpu.solvers.lbfgsb import (
        LbfgsbConfig, lbfgsb_minimize)

    n = 5
    lo = jnp.full((n,), -1.0)
    hi = jnp.full((n,), 1.0)
    f = lambda x, p: 0.5 * jnp.sum((x - p) ** 2)

    def solve_fn(p, x0):
        return lbfgsb_minimize(
            make_oracle(lambda x: f(x, p)), x0, lo, hi,
            LbfgsbConfig(pgtol=1e-12, factr=0.0, max_iter=200)).x

    x_star = solvers.make_implicit_solver_bounded(
        f, solve_fn, lambda p: (lo, hi))
    p = jnp.array([0.5, 2.0, -3.0, 0.9, 0.0])
    x0 = jnp.zeros((n,))
    np.testing.assert_allclose(
        x_star(p, x0), np.clip(np.asarray(p), -1, 1), atol=1e-8)
    g = jax.grad(lambda p: jnp.sum(x_star(p, x0) ** 2))(p)
    inside = (np.asarray(p) > -1) & (np.asarray(p) < 1)
    np.testing.assert_allclose(
        g, 2 * np.clip(np.asarray(p), -1, 1) * inside, atol=1e-6)


def test_implicit_bounded_parametric_bounds():
    # upper bound IS the parameter; every coordinate rides it, so
    # d sum(x*) / d u = n through the bounds_fn VJP path
    from optimization_solvers_tpu.solvers.lbfgsb import (
        LbfgsbConfig, lbfgsb_minimize)

    n = 4
    f = lambda x, p: 0.5 * jnp.sum((x - 3.0) ** 2)

    def bounds_fn(p):
        return jnp.full((n,), -1.0), p * jnp.ones((n,))

    def solve_fn(p, x0):
        l2, u2 = bounds_fn(p)
        return lbfgsb_minimize(
            make_oracle(lambda x: f(x, p)), x0, l2, u2,
            LbfgsbConfig(pgtol=1e-12, factr=0.0, max_iter=200)).x

    x_star = solvers.make_implicit_solver_bounded(f, solve_fn, bounds_fn)
    x0 = jnp.zeros((n,))
    g = jax.grad(lambda p: jnp.sum(x_star(p, x0)))(jnp.asarray(1.5))
    np.testing.assert_allclose(float(g), float(n), atol=1e-6)


def test_implicit_bounded_interior_matches_unbounded():
    # with no active bounds the KKT path reduces exactly to the plain IFT
    A = jnp.array([[2.0, 0.5], [0.0, 1.5], [1.0, 1.0]])
    lam = 0.3

    def f(x, theta):
        r = x - A @ theta
        return 0.5 * r @ r + 0.5 * lam * x @ x

    lo = jnp.full((3,), -100.0)
    hi = jnp.full((3,), 100.0)

    def solve_fn(theta, x0):
        oracle = make_oracle(lambda x: f(x, theta))
        return solvers.minimize(
            solvers.BFGS(tol=1e-12), ls.StrongWolfe(c1=1e-4, c2=0.9),
            oracle, x0, max_iter=200).x

    theta = jnp.array([0.7, -1.2])
    x0 = jnp.zeros(3)
    g_plain = jax.grad(lambda th: jnp.sum(
        solvers.make_implicit_solver(f, solve_fn)(th, x0)))(theta)
    g_kkt = jax.grad(lambda th: jnp.sum(
        solvers.make_implicit_solver_bounded(
            f, solve_fn, lambda p: (lo, hi))(th, x0)))(theta)
    np.testing.assert_allclose(g_kkt, g_plain, atol=1e-10)


def test_checkpoint_orbax_roundtrip_and_resume(tmp_path):
    from optimization_solvers_tpu.utils import load_state_orbax, save_state_orbax

    oracle = make_oracle(problems.quadratic_2d(90.0))
    init_fn, _, step_fn = solvers.make_step(
        solvers.GradientDescent(grad_tol=1e-10), ls.BackTracking(), oracle)

    c_ref = init_fn(jnp.array([180.0, 152.0]))
    for _ in range(20):
        c_ref = step_fn(c_ref)

    c = init_fn(jnp.array([180.0, 152.0]))
    for _ in range(8):
        c = step_fn(c)
    path = str(tmp_path / "orbax_ckpt")
    save_state_orbax(path, c)
    c2 = load_state_orbax(path, like=init_fn(jnp.array([0.0, 0.0])))
    assert type(c2) is type(c)
    for _ in range(12):
        c2 = step_fn(c2)
    np.testing.assert_allclose(c2.x, c_ref.x, atol=0)
    assert int(c2.k) == int(c_ref.k) == 20


def test_op_profile_reports_ops(tmp_path):
    # the xprof-backed op-level breakdown must attribute device/host time
    # to named ops of a jitted computation (the tool behind the config-4
    # hot-loop rebuild)
    pytest.importorskip("xprof")
    import jax
    import jax.numpy as jnp

    from optimization_solvers_tpu.utils import op_profile

    @jax.jit
    def fn(a):
        def body(_, acc):
            return jnp.tanh(acc @ a) * 0.5 + acc * 0.5
        return jax.lax.fori_loop(0, 50, body, a).sum()

    x = jnp.ones((512, 512))
    fn(x)  # warm
    rows = op_profile(fn, x, trace_dir=str(tmp_path / "prof"))
    assert rows, "empty op table"
    assert all({"self_us", "occurrences", "name"} <= set(r) for r in rows)
    # on a real device the table names the dot/fusion ops; the CPU backend
    # sometimes reports only IDLE for small programs — require named ops
    # only when any non-IDLE row exists
    named = [r for r in rows if r["type"] not in (None, "IDLE")]
    if named:
        names = " ".join(str(r["name"]) + str(r["type"]) for r in named)
        assert ("dot" in names or "tanh" in names or "fusion" in names
                or "while" in names)


def test_line_search_trial_tracing(monkeypatch, caplog):
    """OST_LOG=debug emits per-TRIAL line-search events (reference
    ``RUST_LOG=debug`` behavior, backtracking.rs:38-53): one record per
    trial with the step, the objective value, and the decision."""
    import logging

    from optimization_solvers_tpu import linesearch as ls
    from optimization_solvers_tpu.core import problems
    from optimization_solvers_tpu.core.oracle import make_oracle

    monkeypatch.setenv("OST_LOG", "debug")
    oracle = make_oracle(problems.rosenbrock())
    x = jnp.asarray([-1.2, 1.0, 0.8])
    ev = oracle(x)

    with caplog.at_level(logging.DEBUG, logger="optimization_solvers_tpu"):
        t, _ = ls.BackTracking().step_len(oracle, x, ev, -ev.g, None, None, 50)
        jax.effects_barrier()
    records = [r for r in caplog.records
               if "linesearch.BackTracking" in r.name]
    assert records, "no per-trial events were emitted"
    assert any("shrink" in r.getMessage() or "accept" in r.getMessage()
               for r in records)
    # the gate is trace-time: with OST_LOG unset AND the package logger
    # below DEBUG, no callback is staged at all
    monkeypatch.delenv("OST_LOG")
    logging.getLogger("optimization_solvers_tpu").setLevel(logging.INFO)
    caplog.clear()
    ls.BackTracking(c1=1e-3).step_len(oracle, x, ev, -ev.g, None, None, 50)
    jax.effects_barrier()
    assert not [r for r in caplog.records
                if "linesearch.BackTracking" in r.name]


def test_trial_tracing_all_searches(monkeypatch, caplog):
    import logging

    from optimization_solvers_tpu import linesearch as ls
    from optimization_solvers_tpu.core import problems
    from optimization_solvers_tpu.core.oracle import make_oracle

    monkeypatch.setenv("OST_LOG", "debug")
    oracle = make_oracle(problems.rosenbrock())
    x = jnp.asarray([-1.2, 1.0, 0.8])
    ev = oracle(x)
    lo, hi = jnp.full(3, -2.0), jnp.full(3, 2.0)

    cases = [
        (ls.GLLQuadratic(), None, "GLLQuadratic"),
        (ls.MoreThuente(), None, "MoreThuente"),
        (ls.StrongWolfe(), None, "StrongWolfe"),
        (ls.HagerZhang(), None, "HagerZhang"),
        (ls.BackTrackingB(), (lo, hi), "BackTrackingB"),
    ]
    for search, bounds, name in cases:
        caplog.clear()
        with caplog.at_level(logging.DEBUG,
                             logger="optimization_solvers_tpu"):
            state = search.init_state(ev)
            search.step_len(oracle, x, ev, -ev.g, state, bounds, 50)
            jax.effects_barrier()
        assert [r for r in caplog.records
                if f"linesearch.{name}" in r.name], name
