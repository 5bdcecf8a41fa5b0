"""Batched solves through the public entry points (``ost.minimize`` with a
(B, n) ``x0``, ``lbfgsb_batch_minimize``, ``newton_cg_batch_minimize``):
known minima, active-bound geometry, infeasible starts, mixed infinite
bounds, problem data and statuses, each lane checked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import optimization_solvers_tpu as ost
from optimization_solvers_tpu.core import problems
from optimization_solvers_tpu.core.oracle import make_oracle
from optimization_solvers_tpu.core.types import Status
from optimization_solvers_tpu.solvers import (
    NewtonCGConfig, newton_cg_batch_minimize, newton_cg_minimize)
from optimization_solvers_tpu.solvers.lbfgsb import (
    LbfgsbConfig, lbfgsb_batch_minimize, lbfgsb_minimize)


def _rosen_minima(f_vals, tol=1e-8):
    # the global minimum (f=0) or Rosenbrock's local minimum near x0=-1
    f_vals = np.asarray(f_vals)
    return np.all((f_vals < tol) | (np.abs(f_vals - 3.9866) < 1e-2))


# -- L-BFGS-B ---------------------------------------------------------------

def test_lbfgsb_bounded_rosenbrock():
    n = 20
    x0 = jnp.asarray(np.random.RandomState(0).uniform(-2, 2, (8, n)))
    res = ost.minimize(problems.rosenbrock(), x0, method="lbfgsb",
                       bounds=(-2.0, 2.0), m=5, tol=1e-6, factr=10.0,
                       max_iter=500)
    assert int((res.status == Status.CONVERGED).sum()) == 8
    assert _rosen_minima(res.f, 1e-10)


def test_lbfgsb_active_bounds():
    # min (x-2)^2 + (y-3)^2 s.t. x,y <= 1 -> (1,1), f = 5
    x0 = jnp.asarray(np.random.RandomState(1).uniform(-0.5, 0.5, (4, 2)))
    res = ost.minimize(problems.shifted_quadratic_2d(), x0, method="lbfgsb",
                       bounds=([-10.0, -10.0], [1.0, 1.0]), tol=1e-8,
                       factr=10.0, max_iter=200)
    assert int((res.status == Status.CONVERGED).sum()) == 4
    np.testing.assert_allclose(res.x, np.tile([1.0, 1.0], (4, 1)), atol=1e-6)
    np.testing.assert_allclose(res.f, np.full(4, 5.0), atol=1e-6)


def test_lbfgsb_projects_infeasible_start():
    x0 = jnp.asarray([[-10.0, 10.0], [7.0, -3.0]])
    res = ost.minimize(problems.example_gd(), x0, method="lbfgsb",
                       bounds=(2.0, 5.0), tol=1e-8, factr=10.0, max_iter=200)
    np.testing.assert_allclose(res.x, np.tile([2.0, 2.0], (2, 1)), atol=1e-8)


def test_lbfgsb_batch_matches_vmapped_single():
    n = 12
    oracle = make_oracle(problems.rosenbrock())
    lower, upper = jnp.full(n, -1.5), jnp.full(n, 1.5)
    x0 = jnp.asarray(np.random.RandomState(2).uniform(-1.4, 1.4, (4, n)))
    cfg = LbfgsbConfig(m=5, pgtol=1e-7, factr=10.0, max_iter=1000)
    batch = jax.jit(lambda x: lbfgsb_batch_minimize(
        oracle, x, lower, upper, cfg))(x0)
    single = jax.jit(jax.vmap(
        lambda x: lbfgsb_minimize(oracle, x, lower, upper, cfg)))(x0)
    assert int((batch.status == 1).sum()) == 4
    np.testing.assert_array_equal(np.asarray(batch.iterations),
                                  np.asarray(single.iterations))
    np.testing.assert_allclose(batch.x, single.x, atol=1e-10)


def test_lbfgsb_mixed_infinite_bounds_with_data():
    # one-sided and absent bounds mixed in one box; lane 0 starts ON the
    # optimal bounds of its bounded coordinates, so its only breakpoints
    # are +inf — the staggered mix the chunked Cauchy walk must survive
    d = jnp.asarray([3.0, 10.0, 1.0, 5.0, 2.0])
    target = jnp.asarray([4.0, -7.0, 9.0, -3.0, 6.0])

    def f(x, dd, tt):
        return 0.5 * jnp.sum(dd * (x - tt) ** 2)

    lower = jnp.asarray([-1.0, -1.0, -1.0, -jnp.inf, -jnp.inf])
    upper = jnp.asarray([1.0, 1.0, 1.0, jnp.inf, jnp.inf])
    x0 = jnp.asarray(np.random.RandomState(2).uniform(-0.5, 0.5, (4, 5)))
    x0 = x0.at[0].set(jnp.asarray([1.0, -1.0, 1.0, 0.3, -0.2]))
    res = ost.minimize(f, x0, method="lbfgsb", bounds=(lower, upper),
                       data=(d, target), tol=1e-6, factr=10.0, max_iter=300)
    assert int((res.status == Status.CONVERGED).sum()) == 4
    expect = np.tile([1.0, -1.0, 1.0, -3.0, 6.0], (4, 1))
    np.testing.assert_allclose(np.asarray(res.x), expect, atol=1e-4)


def test_lbfgsb_column_data_keeps_its_shape():
    """A genuinely 2-D (k, 1) data array reaches the objective with its
    own shape beside a 1-D one."""
    n = 6
    rng = np.random.RandomState(5)
    d_col = jnp.asarray(rng.uniform(1.0, 3.0, (n, 1)))
    t_vec = jnp.asarray(rng.uniform(-0.5, 0.5, n))

    def f(x, dcol, tv):
        assert dcol.ndim == 2 and tv.ndim == 1           # trace-time shapes
        return 0.5 * jnp.sum(dcol[:, 0] * (x - tv) ** 2)

    x0 = jnp.asarray(rng.uniform(-1.0, 1.0, (4, n)))
    res = ost.minimize(f, x0, method="lbfgsb", bounds=(-2.0, 2.0),
                       data=(d_col, t_vec), m=4, tol=1e-8, factr=10.0,
                       max_iter=200)
    assert int((res.status == Status.CONVERGED).sum()) == 4
    np.testing.assert_allclose(
        np.asarray(res.x), np.tile(np.asarray(t_vec), (4, 1)), atol=1e-6)


def test_lbfgsb_unbounded_via_infinite_bounds():
    # bounds=None and explicit +-inf bounds are the same problem
    n = 16
    x0 = jnp.asarray(np.random.RandomState(5).uniform(-2, 2, (4, n)))
    kw = dict(method="lbfgsb", m=5, tol=1e-7, factr=10.0, max_iter=800)
    r_none = ost.minimize(problems.rosenbrock(), x0, **kw)
    r_inf = ost.minimize(problems.rosenbrock(), x0,
                         bounds=(-jnp.inf, jnp.inf), **kw)
    assert (np.asarray(r_none.status) == 1).all()
    assert _rosen_minima(r_none.f, 1e-10)
    np.testing.assert_array_equal(np.asarray(r_none.x), np.asarray(r_inf.x))


def test_lbfgsb_status_codes_per_lane():
    # a budget of 3 iterations: far lanes report MAX_ITER_REACHED while a
    # lane started at the minimizer converges at once
    x0 = jnp.asarray([[1.0] * 8, [-1.5] * 8, [0.5] * 8])
    res = ost.minimize(problems.rosenbrock(), x0, method="lbfgsb",
                       bounds=(-2.0, 2.0), tol=1e-8, factr=0.0, max_iter=3)
    st = np.asarray(res.status)
    assert st[0] == int(Status.CONVERGED)
    assert (st[1:] == int(Status.MAX_ITER_REACHED)).all()
    assert (np.asarray(res.iterations)[1:] == 3).all()


def test_lbfgsb_large_n_lse_matches_scipy():
    """The config-4 class in miniature: bounded log-sum-exp with a shared
    design matrix as problem data, against scipy's Fortran L-BFGS-B."""
    from scipy.optimize import fmin_l_bfgs_b

    n, rows, B = 200, 64, 4
    rng = np.random.RandomState(4)
    A = rng.standard_normal((rows, n)) / np.sqrt(n)
    b = np.linspace(-1.0, 1.0, rows)
    x0 = rng.uniform(-0.5, 0.5, (B, n))

    def lse(x, A_, b_):
        return jax.nn.logsumexp(A_ @ x + b_)

    res = ost.minimize(lse, jnp.asarray(x0), method="lbfgsb",
                       data=(jnp.asarray(A), jnp.asarray(b)),
                       bounds=(-1.0, 1.0), m=10, tol=1e-8, factr=10.0,
                       max_iter=500)

    def fg(x):
        z = A @ x + b
        m = z.max()
        e = np.exp(z - m)
        return m + np.log(e.sum()), A.T @ (e / e.sum())

    assert (np.asarray(res.status) == 1).all()
    for i in range(B):
        f_ref = fmin_l_bfgs_b(fg, x0[i], bounds=[(-1.0, 1.0)] * n, m=10,
                              factr=10.0, pgtol=1e-10)[1]
        assert abs(float(res.f[i]) - f_ref) <= 1e-9 * (1.0 + abs(f_ref))


# -- Newton-CG ---------------------------------------------------------------

def test_newton_cg_rosenbrock_interior():
    n = 16
    x0 = jnp.asarray(np.random.RandomState(0).uniform(-2, 2, (8, n)))
    cfg = NewtonCGConfig(pgtol=1e-8, factr=0.0, max_iter=300, cg_max=40)
    res = newton_cg_batch_minimize(make_oracle(problems.rosenbrock()), x0,
                                   jnp.full(n, -5.0), jnp.full(n, 5.0), cfg)
    assert int((res.status == Status.CONVERGED).sum()) == 8
    assert _rosen_minima(res.f, 1e-12)
    # superlinear local convergence: far fewer outer iterations than the
    # ~5n lockstep count limited-memory methods need on this family
    assert float(np.median(np.asarray(res.iterations))) < 150


def test_newton_cg_active_bounds_quadratic():
    # 0.5 sum(d x^2) on the box [1, 2]^n: the optimum is pinned at 1
    d = jnp.asarray(np.random.RandomState(1).uniform(1.0, 5.0, 8))
    x0 = jnp.asarray(np.random.RandomState(2).uniform(1.0, 2.0, (8, 8)))
    res = ost.minimize(lambda x, dd: 0.5 * jnp.sum(dd * x * x), x0,
                       method="newton_cg", bounds=(1.0, 2.0), data=(d,),
                       tol=1e-8, factr=0.0, max_iter=100)
    assert int((res.status == Status.CONVERGED).sum()) == 8
    np.testing.assert_allclose(np.asarray(res.x), np.ones((8, 8)), atol=1e-7)


def test_newton_cg_mixed_active_set():
    # the reference SPG test geometry (spg.rs:147-205): optimum (0, 47),
    # one coordinate bound-active, one interior
    x0 = jnp.asarray(np.random.RandomState(3).uniform(0, 40, (8, 2)))
    res = ost.minimize(problems.quadratic_2d(90.0), x0, method="newton_cg",
                       bounds=([-1.0, 47.0], [1e6, 1e6]), tol=1e-10,
                       factr=0.0, max_iter=500)
    assert int((res.status == Status.CONVERGED).sum()) == 8
    np.testing.assert_allclose(res.x[:, 1], np.full(8, 47.0), atol=1e-9)
    np.testing.assert_allclose(res.x[:, 0], np.zeros(8), atol=1e-7)


def test_newton_cg_matches_lbfgsb():
    # the same bounded Rosenbrock (upper bound active at the solution)
    # through both second-order-ish solvers: same stationary points
    n = 12
    oracle = make_oracle(problems.rosenbrock())
    lower, upper = jnp.full(n, -2.0), jnp.full(n, 0.5)
    x0 = jnp.asarray(np.random.RandomState(4).uniform(-2, 0.5, (8, n)))
    res = newton_cg_batch_minimize(
        oracle, x0, lower, upper,
        NewtonCGConfig(pgtol=1e-7, factr=0.0, max_iter=300, cg_max=40))
    ref = jax.jit(lambda x: lbfgsb_batch_minimize(
        oracle, x, lower, upper,
        LbfgsbConfig(m=8, pgtol=1e-7, factr=0.0, max_iter=500)))(x0)
    assert int((res.status == Status.CONVERGED).sum()) == 8
    np.testing.assert_allclose(np.asarray(res.f), np.asarray(ref.f),
                               rtol=1e-5, atol=1e-8)


def test_newton_cg_single_matches_batch():
    n = 8
    lower, upper = jnp.full(n, -2.0), jnp.full(n, 2.0)
    oracle = make_oracle(problems.rosenbrock())
    cfg = NewtonCGConfig(pgtol=1e-8, factr=0.0, max_iter=200)
    x0s = jnp.asarray(np.random.RandomState(8).uniform(-2, 2, (4, n)))
    batched = newton_cg_batch_minimize(oracle, x0s, lower, upper, cfg)
    single = jax.jit(
        lambda x: newton_cg_minimize(oracle, x, lower, upper, cfg))
    for i in range(4):
        r = single(x0s[i])
        np.testing.assert_allclose(np.asarray(batched.x[i]),
                                   np.asarray(r.x), atol=0)
        assert batched.iterations[i] == r.iterations


# -- SPG, BFGS, L-BFGS through the front end ---------------------------------

def test_spg_active_bound_geometry():
    # the reference SPG test (spg.rs:147-205): gamma=90 quadratic, lower
    # bound 47 on x1 active at the constrained optimum (0, 47)
    x0 = jnp.asarray(np.random.RandomState(0).uniform(0, 40, (8, 2)))
    res = ost.minimize(problems.quadratic_2d(90.0), x0, method="spg",
                       bounds=([-1.0, 47.0], [jnp.inf, jnp.inf]), tol=1e-10,
                       max_iter=2000)
    assert int((res.status == Status.CONVERGED).sum()) == 8
    np.testing.assert_array_equal(res.x[:, 1], np.full(8, 47.0))
    np.testing.assert_allclose(res.x[:, 0], np.zeros(8), atol=1e-8)


def test_spg_exp_bowl():
    x0 = jnp.asarray(np.random.RandomState(1).uniform(-1, 1, (8, 2)))
    res = ost.minimize(problems.exp_bowl(), x0, method="spg",
                       bounds=(-1.0, 1.0), tol=1e-8, max_iter=500)
    assert int((res.status == Status.CONVERGED).sum()) == 8
    np.testing.assert_allclose(res.f, np.ones(8), atol=1e-10)


@pytest.mark.parametrize("policy", ["fast", "reference"])
def test_spg_box_quadratic_batch(policy):
    # config-3 shape: box-constrained diagonal quadratic, the diagonal as
    # problem data
    d = jnp.asarray(np.random.RandomState(2).uniform(1.0, 10.0, 16))
    x0 = jnp.asarray(np.random.RandomState(3).uniform(-3, 3, (16, 16)))
    res = ost.minimize(lambda x, dd: 0.5 * jnp.sum(dd * x * x), x0,
                       method="spg", bounds=(-2.0, 2.0), data=(d,),
                       tol=1e-8, max_iter=1000, policy=policy)
    assert int((res.status == Status.CONVERGED).sum()) == 16
    np.testing.assert_allclose(res.x, np.zeros((16, 16)), atol=1e-7)


def test_bfgs_rosenbrock_batch():
    x0 = jnp.asarray(np.random.RandomState(0).uniform(-2, 2, (8, 20)))
    res = ost.minimize(problems.rosenbrock(), x0, method="bfgs", tol=1e-5,
                       max_iter=800)
    assert np.isin(np.asarray(res.status), (1, 6)).all()
    assert _rosen_minima(res.f)
    global_lanes = np.asarray(res.f) < 1e-8
    np.testing.assert_allclose(
        np.asarray(res.x)[global_lanes],
        np.ones((int(global_lanes.sum()), 20)), atol=1e-4)


@pytest.mark.parametrize("method", ["bfgs", "lbfgs"])
def test_quasi_newton_quadratic_exact(method):
    x0 = jnp.asarray(np.random.RandomState(1).uniform(-5, 5, (16, 3)))
    res = ost.minimize(problems.example_bfgs(), x0, method=method, tol=1e-8,
                       max_iter=200)
    assert int((res.status == Status.CONVERGED).sum()) == 16
    assert float(jnp.max(res.f)) < 1e-12


def test_lbfgs_rosenbrock_batch():
    x0 = jnp.asarray(np.random.RandomState(0).uniform(-2, 2, (8, 20)))
    res = ost.minimize(problems.rosenbrock(), x0, method="lbfgs", m=10,
                       tol=1e-5, max_iter=800)
    assert int((res.status == Status.CONVERGED).sum()) == 8
    assert _rosen_minima(res.f)
