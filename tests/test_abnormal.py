"""ABNORMAL-termination semantics across all three L-BFGS-B backends.

The Fortran core restores the previous iterate and reports
``ABNORMAL_TERMINATION_IN_LNSRCH`` when the line search cannot produce an
acceptable step; the reference surfaces that task string as an error
(``/root/reference/src/quasi_newton/lbfgsb.rs:76-84``).  Before round 3 these
edges stall-exited ``CONVERGED`` at a worse / non-stationary iterate.  Two
deterministic geometries are exercised:

  * an INCONSISTENT oracle (gradient is the negative of the true gradient):
    every search direction looks like descent but f strictly increases, so
    the strong-Wolfe search force-exits or collapses its bracket at 0;
  * a NaN WALL: f is finite only in a tiny ball around x0, so every trial
    evaluation is out-of-domain and the accepted step is poisoned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optimization_solvers_tpu.core.oracle import Oracle, make_oracle
from optimization_solvers_tpu.core.types import FuncEval, Status
from optimization_solvers_tpu.solvers.lbfgsb import (
    LbfgsbConfig,
    _History,
    lbfgsb_batch_minimize,
    lbfgsb_minimize,
    make_lbfgsb_step,
)


def _inconsistent_oracle():
    """f = ||x||^2 but g = -2x: reported descent directions are ascent."""

    def full(x):
        return FuncEval(jnp.sum(x * x), -2.0 * x)

    def value(x):
        return jnp.sum(x * x)

    return Oracle(full, value)


def _nan_wall(delta=1e-9):
    """Scalar objective finite only within max|x| < delta of the origin."""

    def f(x):
        inside = jnp.max(jnp.abs(x)) < delta
        return jnp.where(inside, jnp.sum((x - 1.0) ** 2),
                         jnp.asarray(jnp.nan, x.dtype))

    return f


def test_jax_inconsistent_oracle_abnormal():
    x0 = jnp.asarray([1.5, -2.0])
    lo = jnp.full(2, -jnp.inf)
    up = jnp.full(2, jnp.inf)
    res = lbfgsb_minimize(
        _inconsistent_oracle(), x0, lo, up,
        LbfgsbConfig(pgtol=1e-8, factr=10.0, max_iter=100))
    assert int(res.status) == int(Status.ABNORMAL)
    # the previous (initial) iterate is RESTORED, not the worse trial
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(x0))
    assert float(res.f) == pytest.approx(float(jnp.sum(x0 * x0)))


def test_jax_nan_wall_abnormal():
    x0 = jnp.zeros(3)
    res = lbfgsb_minimize(
        make_oracle(_nan_wall()), x0, jnp.full(3, -10.0), jnp.full(3, 10.0),
        LbfgsbConfig(pgtol=1e-8, factr=10.0, max_iter=50))
    assert int(res.status) == int(Status.ABNORMAL)
    np.testing.assert_allclose(np.asarray(res.x), np.zeros(3))
    assert float(res.f) == pytest.approx(3.0)


def test_jax_restart_then_abnormal():
    """With history present, a failure first RESTARTS (wipes the model,
    keeps the iterate, disables the stall exit); only a second failure from
    the empty model terminates ABNORMAL — the Fortran mainlb retry rule."""
    x0 = jnp.asarray([1.5, -2.0])
    lo = jnp.full(2, -jnp.inf)
    up = jnp.full(2, jnp.inf)
    cfg = LbfgsbConfig(pgtol=1e-8, factr=10.0, max_iter=100)
    init_fn, keep_going_fn, step_fn = make_lbfgsb_step(
        _inconsistent_oracle(), lo, up, cfg)
    c = init_fn(x0)
    # seed one plausible curvature pair so the history is non-empty
    s = jnp.asarray([0.1, 0.1])
    y = jnp.asarray([0.2, 0.2])
    hist = _History(
        S=c.hist.S.at[-1].set(s),
        Y=c.hist.Y.at[-1].set(y),
        valid=c.hist.valid.at[-1].set(True),
        theta=jnp.asarray(1.0, x0.dtype),
    )
    c = c._replace(hist=hist)

    c1 = step_fn(c)
    assert not bool(c1.abnormal)
    np.testing.assert_allclose(np.asarray(c1.x), np.asarray(x0))
    assert not bool(jnp.any(c1.hist.valid))          # model wiped
    assert np.all(np.asarray(c1.hist.S) == 0.0)      # W rows inert
    assert not np.isfinite(float(c1.f_prev))         # stall exit disabled
    assert bool(keep_going_fn(c1))                   # lane keeps going

    c2 = step_fn(c1)
    assert bool(c2.abnormal)                         # empty model: terminate
    assert not bool(keep_going_fn(c2))


def _walled_aniso():
    """Finite only in a tiny ball at the origin (lane 0's start) and in a
    small basin around the anisotropic minimum (1, 1).  The anisotropy
    matters: the search ray from the origin is d = (2, 8), and no point of
    that ray lies in the basin (x0 in the basin needs t in (0.25, 0.75),
    x1 needs t in (0.0625, 0.1875) — disjoint), so NO line-search trial can
    jump the wall regardless of the trial-selection rule."""

    def f(x):
        q = (x[0] - 1.0) ** 2 + 4.0 * (x[1] - 1.0) ** 2
        at_start = jnp.max(jnp.abs(x)) < 1e-9
        in_basin = jnp.max(jnp.abs(x - 1.0)) < 0.5
        return jnp.where(at_start | in_basin, q,
                         jnp.asarray(jnp.nan, x.dtype))

    return f


def test_jax_batched_abnormal_isolated_lane():
    """One walled lane goes ABNORMAL; basin lanes still converge."""
    x0 = jnp.asarray([[0.0, 0.0], [1.2, 0.9], [0.8, 1.3]])
    res = jax.jit(
        lambda x: lbfgsb_batch_minimize(
            make_oracle(_walled_aniso()), x,
            jnp.full(2, -100.0), jnp.full(2, 100.0),
            LbfgsbConfig(pgtol=1e-6, factr=10.0, max_iter=200)))(x0)
    status = np.asarray(res.status)
    assert status[0] == int(Status.ABNORMAL)
    assert status[1] == int(Status.CONVERGED)
    assert status[2] == int(Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x)[1:], np.ones((2, 2)),
                               atol=1e-4)


def test_native_inconsistent_oracle_abnormal():
    import shutil

    if shutil.which("g++") is None:  # pragma: no cover
        pytest.skip("no C++ toolchain")
    from optimization_solvers_tpu.native import lbfgsb_minimize_native

    def vg(x):
        return float(np.sum(x * x)), -2.0 * x

    x0 = np.array([1.5, -2.0])
    x, f, iters, status = lbfgsb_minimize_native(
        vg, x0, np.full(2, -np.inf), np.full(2, np.inf),
        m=5, factr=10.0, pgtol=1e-8, max_iter=100)
    assert status == int(Status.ABNORMAL)
    np.testing.assert_allclose(x, x0)
    assert f == pytest.approx(float(np.sum(x0 * x0)))


def test_native_nan_wall_abnormal():
    import shutil

    if shutil.which("g++") is None:  # pragma: no cover
        pytest.skip("no C++ toolchain")
    from optimization_solvers_tpu.native import lbfgsb_minimize_native

    def vg(x):
        if np.max(np.abs(x)) < 1e-9:
            return float(np.sum((x - 1.0) ** 2)), 2.0 * (x - 1.0)
        return float("nan"), np.zeros_like(x)

    x, f, iters, status = lbfgsb_minimize_native(
        vg, np.zeros(3), np.full(3, -10.0), np.full(3, 10.0),
        m=5, factr=10.0, pgtol=1e-8, max_iter=50)
    assert status == int(Status.ABNORMAL)
    np.testing.assert_allclose(x, np.zeros(3))
    assert f == pytest.approx(3.0)


def test_frontend_nan_wall_abnormal():
    import optimization_solvers_tpu as ost

    res = ost.minimize(_nan_wall(), jnp.zeros((2, 3)), method="lbfgsb",
                       bounds=(-10.0, 10.0), tol=1e-8, factr=10.0, m=5,
                       max_iter=50)
    assert np.all(np.asarray(res.status) == int(Status.ABNORMAL))
    np.testing.assert_allclose(np.asarray(res.x), np.zeros((2, 3)))
    np.testing.assert_allclose(np.asarray(res.f), np.full(2, 3.0))


def test_frontend_abnormal_lane_isolated():
    """Through the one-call front end: a walled lane reports ABNORMAL
    while its batch-mates converge normally."""
    import optimization_solvers_tpu as ost

    x0 = jnp.asarray([[0.0, 0.0], [1.2, 0.9], [0.8, 1.3], [1.4, 1.1]])
    res = ost.minimize(_walled_aniso(), x0, method="lbfgsb",
                       bounds=(-100.0, 100.0), tol=1e-6, factr=10.0, m=5,
                       max_iter=200)
    status = np.asarray(res.status)
    assert status[0] == int(Status.ABNORMAL)
    assert np.all(status[1:] == int(Status.CONVERGED))
    np.testing.assert_allclose(np.asarray(res.x)[1:], np.ones((3, 2)),
                               atol=1e-4)


def test_api_raises_abnormal_termination():
    from optimization_solvers_tpu import api

    solver = api.Lbfgsb(2)
    solver.set_pgtol(1e-8)
    solver.set_factr(10.0)
    with pytest.raises(api.AbnormalTermination):
        solver.minimize(_inconsistent_oracle(), jnp.asarray([1.5, -2.0]))
