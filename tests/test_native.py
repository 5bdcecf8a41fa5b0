"""Native C++ L-BFGS-B backend tests: cross-check against the JAX
device-resident implementation (same algorithm, independent code paths) and
against known minima."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

if shutil.which("g++") is None:  # pragma: no cover
    pytest.skip("no C++ toolchain", allow_module_level=True)

from optimization_solvers_tpu.core import problems
from optimization_solvers_tpu.core.oracle import make_oracle
from optimization_solvers_tpu.native import lbfgsb_minimize_native
from optimization_solvers_tpu.solvers.lbfgsb import LbfgsbConfig, lbfgsb_minimize


def _rosen_vg(x):
    f = float(np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2))
    g = np.zeros_like(x)
    g[:-1] = -400.0 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2.0 * (1.0 - x[:-1])
    g[1:] += 200.0 * (x[1:] - x[:-1] ** 2)
    return f, g


def test_native_matches_jax_unbounded():
    n = 25
    x, f, iters, status = lbfgsb_minimize_native(
        _rosen_vg, np.full(n, -1.2), np.full(n, -np.inf), np.full(n, np.inf),
        m=10, factr=10.0, pgtol=1e-7, max_iter=1000)
    assert status == 1
    res = lbfgsb_minimize(
        make_oracle(problems.rosenbrock()), jnp.full(n, -1.2),
        jnp.full(n, -jnp.inf), jnp.full(n, jnp.inf),
        LbfgsbConfig(m=10, pgtol=1e-7, factr=10.0, max_iter=1000))
    # independent implementations of the same algorithm: identical
    # iteration counts and matching minimizers
    assert iters == int(res.iterations)
    np.testing.assert_allclose(x, np.asarray(res.x), atol=1e-6)
    assert abs(f - float(res.f)) < 1e-12


def test_native_active_bounds():
    x, f, iters, status = lbfgsb_minimize_native(
        lambda x: ((x[0] - 2) ** 2 + (x[1] - 3) ** 2,
                   np.array([2 * (x[0] - 2), 2 * (x[1] - 3)])),
        np.array([0.0, 0.0]), np.array([-np.inf, -np.inf]),
        np.array([1.0, 1.0]), m=5, factr=10.0, pgtol=1e-8, max_iter=200)
    assert status == 1
    np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-8)
    assert abs(f - 5.0) < 1e-10


def test_native_projects_infeasible_start():
    x, f, iters, status = lbfgsb_minimize_native(
        lambda x: (float(x[0] ** 2 + 2 * x[1] ** 2),
                   np.array([2 * x[0], 4 * x[1]])),
        np.array([-10.0, 10.0]), np.array([2.0, 2.0]), np.array([5.0, 5.0]),
        m=5, pgtol=1e-8, factr=10.0, max_iter=200)
    assert status == 1
    np.testing.assert_allclose(x, [2.0, 2.0], atol=1e-8)


def test_native_max_iter_status():
    x, f, iters, status = lbfgsb_minimize_native(
        _rosen_vg, np.full(30, -1.2), np.full(30, -np.inf), np.full(30, np.inf),
        m=5, factr=0.0, pgtol=0.0, max_iter=3)
    assert status == 2 and iters == 3


def test_lockstep_lbfgsb_matches_native_bounded():
    """The lockstep batched L-BFGS-B cross-checked against the clean-room
    C++ core on a bound-active Rosenbrock: two independent implementations
    of the same algorithm reach the same constrained minimizer."""
    from optimization_solvers_tpu.solvers.lbfgsb import lbfgsb_batch_minimize

    n = 16
    lo_np = np.full(n, -1.5)
    hi_np = np.full(n, 0.8)   # upper bound cuts off the global minimum
    x0 = np.random.RandomState(3).uniform(-1.4, 0.7, n)
    x_nat, f_nat, _, st_nat = lbfgsb_minimize_native(
        _rosen_vg, x0.copy(), lo_np, hi_np,
        m=5, pgtol=1e-8, factr=10.0, max_iter=500)
    assert st_nat == 1
    res = jax.jit(lambda x: lbfgsb_batch_minimize(
        make_oracle(problems.rosenbrock()), x, jnp.asarray(lo_np),
        jnp.asarray(hi_np),
        LbfgsbConfig(m=5, pgtol=1e-8, factr=10.0, max_iter=500)))(
            jnp.asarray(x0)[None, :])
    assert int(res.status[0]) == 1
    np.testing.assert_allclose(np.asarray(res.x[0]), x_nat, atol=1e-5)
    assert abs(float(res.f[0]) - f_nat) < 1e-9 * max(1.0, abs(f_nat))
