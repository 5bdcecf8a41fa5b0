"""Mesh/sharding layer tests on the virtual 8-device CPU mesh: sharded
solves must match local solves per-lane, and the scaling harness must
produce efficiency records."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from optimization_solvers_tpu import linesearch as ls, solvers
from optimization_solvers_tpu.core import problems
from optimization_solvers_tpu.core.oracle import make_oracle
from optimization_solvers_tpu.parallel import (
    make_mesh,
    scaling_report,
    sharded_batch_minimize,
    sharded_lbfgsb_minimize,
    sharded_summary,
)
from optimization_solvers_tpu.solvers.lbfgsb import LbfgsbConfig, lbfgsb_minimize

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual mesh"
)


def test_sharded_gd_matches_local():
    mesh = Mesh(jax.devices()[:8], ("dp",))
    oracle = make_oracle(problems.quadratic_2d(90.0))
    method = solvers.GradientDescent(grad_tol=1e-8)
    x0 = jnp.asarray(np.random.RandomState(0).uniform(-5, 5, (64, 2)))
    res = sharded_batch_minimize(
        method, ls.BackTracking(), oracle, x0, mesh=mesh, max_iter=2000)
    local = solvers.batch_minimize(
        method, ls.BackTracking(), oracle, x0, max_iter=2000)
    np.testing.assert_array_equal(res.iterations, local.iterations)
    np.testing.assert_allclose(res.x, local.x, atol=1e-12)
    stats = sharded_summary(res, mesh)
    assert stats["converged"] == 64


def test_sharded_bounded_replicated_bounds():
    mesh = Mesh(jax.devices()[:8], ("dp",))
    oracle = make_oracle(problems.shifted_quadratic_2d())
    bounds = (jnp.array([-jnp.inf, -jnp.inf]), jnp.array([1.0, 1.0]))
    x0 = jnp.asarray(np.random.RandomState(1).uniform(-3, 3, (16, 2)))
    res = sharded_batch_minimize(
        solvers.ProjectedGradientDescent(grad_tol=1e-8), ls.BackTrackingB(),
        oracle, x0, mesh=mesh, bounds=bounds, max_iter=1000)
    np.testing.assert_allclose(
        res.x, np.tile([1.0, 1.0], (16, 1)), atol=1e-6)


def test_sharded_lbfgsb_matches_local():
    mesh = Mesh(jax.devices()[:8], ("dp",))
    n = 20
    oracle = make_oracle(problems.rosenbrock())
    lower, upper = jnp.full(n, -5.0), jnp.full(n, 5.0)
    cfg = LbfgsbConfig(m=5, pgtol=1e-6, factr=10.0, max_iter=500)
    x0 = jnp.asarray(np.random.RandomState(2).uniform(-2, 2, (32, n)))
    res = sharded_lbfgsb_minimize(oracle, x0, lower, upper, cfg, mesh=mesh)
    local = jax.vmap(
        lambda x: lbfgsb_minimize(oracle, x, lower, upper, cfg))(x0)
    assert sharded_summary(res, mesh)["converged"] == 32
    # solutions agree to the stopping tolerance (compilation differences
    # may reorder reductions between the sharded and local programs)
    np.testing.assert_allclose(res.x, local.x, atol=1e-5)
    np.testing.assert_allclose(res.f, local.f, atol=1e-10)


def test_scaling_report_runs():
    oracle = make_oracle(problems.quadratic_2d(90.0))
    method = solvers.GradientDescent(grad_tol=1e-8)
    x0 = jnp.asarray(np.random.RandomState(3).uniform(-5, 5, (64, 2)))

    def solve_fn(mesh):
        return sharded_batch_minimize(
            method, ls.BackTracking(), oracle, x0, mesh=mesh, max_iter=2000)

    recs = scaling_report(solve_fn, batch=64, device_counts=[1, 2, 8])
    assert [r["devices"] for r in recs] == [1, 2, 8]
    assert recs[0]["efficiency"] == 1.0
    assert all(r["solves_per_sec"] > 0 for r in recs)


def test_make_mesh_helper():
    mesh = make_mesh((8, 1))
    assert mesh.shape == {"dp": 8, "tp": 1}


def test_sharded_lbfgsb_f32_lanes_agree_with_one_device():
    """The four-card comparison of chip_smoke.py at CPU size: the
    data-parallel lockstep L-BFGS-B over a 4-device ("dp",) mesh against
    the whole batch on one device, in f32 with the smoke's per-lane
    rule."""
    import chip_smoke

    r = chip_smoke.phase_sharded_dp("cpu", jax.devices()[:4], batch=32,
                                    n=20)
    assert r["same_status"] >= chip_smoke.AGREE_FRACTION
    assert r["agreement"] >= chip_smoke.AGREE_FRACTION


def test_sharded_spg_matches_single_device():
    # the general sharded driver with replicated bounds must agree lane for
    # lane with the lockstep driver run unsharded
    n, B = 8, 32
    d = jnp.asarray(np.linspace(1.0, 20.0, n))
    oracle = make_oracle(lambda x, dd: 0.5 * jnp.sum(dd * x * x), data=(d,))
    x0 = jnp.asarray(np.random.RandomState(5).uniform(-2, 2, (B, n)))
    bounds = (jnp.full((n,), -1.5), jnp.full((n,), 2.5))
    mesh = make_mesh((8,), ("dp",))
    method = solvers.SpectralProjectedGradient(grad_tol=1e-8)
    kw = dict(bounds=bounds, max_iter=500, max_iter_ls=30)
    r_sharded = sharded_batch_minimize(
        method, ls.GLLQuadratic(), oracle, x0, mesh=mesh, axis="dp", **kw)
    r_single = solvers.batch_minimize(method, ls.GLLQuadratic(), oracle, x0,
                                      **kw)
    np.testing.assert_allclose(
        np.asarray(r_sharded.x), np.asarray(r_single.x), atol=1e-12)
    np.testing.assert_array_equal(
        np.asarray(r_sharded.iterations), np.asarray(r_single.iterations))
    np.testing.assert_array_equal(
        np.asarray(r_sharded.status), np.asarray(r_single.status))


def test_coordinate_sharded_lbfgsb_f32_matches_one_device():
    """The four-card coordinate-sharded comparison of chip_smoke.py at CPU
    size: one bounded log-sum-exp instance with its coordinate axis over a
    4-device ("tp",) mesh against the same solve on one device, in f32."""
    import chip_smoke

    r = chip_smoke.phase_sharded_tp("cpu", jax.devices()[:4], n=512,
                                    rows=64)
    assert abs(r["f_tp"] - r["f_card0"]) <= chip_smoke.F_RTOL * (
        1.0 + abs(r["f_card0"]))
