"""Tensor-parallel (coordinate-sharded) solves to CONVERGENCE on the
virtual 8-device mesh: the sharded result must match the replicated solve
within reduction-order tolerance (VERDICT round-1 item 2; SURVEY.md §2.5
"model/tensor parallel" — the reference has no counterpart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from optimization_solvers_tpu import linesearch as ls, solvers
from optimization_solvers_tpu.core import problems
from optimization_solvers_tpu.core.oracle import make_oracle
from optimization_solvers_tpu.parallel import (
    coordinate_sharded_lbfgsb_minimize,
    coordinate_sharded_minimize,
)
from optimization_solvers_tpu.solvers.lbfgsb import LbfgsbConfig, lbfgsb_minimize

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual mesh"
)


def _tp_mesh():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8), ("dp", "tp"))


def _lse(n=512, rows=64, seed=0, mu=0.01):
    # ridge-regularized log-sum-exp: with rows < n the plain LSE is
    # unbounded below (0 is a.s. outside the rows' convex hull), so add a
    # strongly-convex term to give it a unique interior minimum
    key = jax.random.PRNGKey(seed)
    A = jax.random.normal(key, (rows, n), jnp.float64) / np.sqrt(n)
    b = jnp.linspace(-1.0, 1.0, rows).astype(jnp.float64)
    lse = problems.log_sum_exp(A, b)
    return lambda x: lse(x) + 0.5 * mu * jnp.sum(x * x)


def test_tp_lbfgsb_lse_convergence_matches_replicated():
    # config-4 shape: bounded log-sum-exp, coordinate axis sharded 8-way.
    # The L-BFGS-B two-loop/compact dot products contract over the sharded
    # axis -> XLA inserts psum collectives; the full solve must converge and
    # agree with the replicated solve.
    n = 512
    f = _lse(n=n)
    oracle = make_oracle(f)
    lower = jnp.full((n,), -2.0, jnp.float64)
    upper = jnp.full((n,), 2.0, jnp.float64)
    cfg = LbfgsbConfig(m=5, pgtol=1e-8, factr=0.0, max_iter=200)
    x0 = jnp.zeros((n,), jnp.float64)

    r_tp = coordinate_sharded_lbfgsb_minimize(
        oracle, x0, lower, upper, cfg, mesh=_tp_mesh(), axis="tp")
    r_ref = jax.jit(
        lambda x: lbfgsb_minimize(oracle, x, lower, upper, cfg))(x0)

    assert int(r_tp.status) == 1
    assert int(r_ref.status) == 1
    np.testing.assert_allclose(
        np.asarray(r_tp.x), np.asarray(r_ref.x), atol=1e-6)
    np.testing.assert_allclose(
        float(r_tp.f), float(r_ref.f), rtol=1e-10)


def test_tp_minimize_first_order_matches_replicated():
    n = 64
    f = _lse(n=n, rows=32, seed=1)
    oracle = make_oracle(f)
    x0 = jnp.full((n,), 0.25, jnp.float64)
    method = solvers.GradientDescent(grad_tol=1e-8)

    r_tp = coordinate_sharded_minimize(
        method, ls.BackTracking(), oracle, x0, mesh=_tp_mesh(),
        max_iter=2000)
    r_ref = jax.jit(lambda x: solvers.minimize(
        method, ls.BackTracking(), oracle, x, max_iter=2000))(x0)

    assert int(r_tp.status) == 1
    np.testing.assert_allclose(
        np.asarray(r_tp.x), np.asarray(r_ref.x), atol=1e-8)


def test_tp_batched_minimize():
    # (dp, tp) combined: leading batch axis replicated, coordinates sharded
    n, B = 64, 4
    f = _lse(n=n, rows=32, seed=2)
    oracle = make_oracle(f)
    x0 = jnp.asarray(
        np.random.RandomState(0).uniform(-0.5, 0.5, (B, n)))
    method = solvers.SpectralProjectedGradient(grad_tol=1e-8)
    bounds = (jnp.full((n,), -1.0), jnp.full((n,), 1.0))

    r_tp = coordinate_sharded_minimize(
        method, ls.GLLQuadratic(), oracle, x0, mesh=_tp_mesh(),
        bounds=bounds, max_iter=2000)
    r_ref = solvers.batch_minimize(
        method, ls.GLLQuadratic(), oracle, x0, bounds=bounds,
        max_iter=2000)

    assert bool(jnp.all(r_tp.status == 1))
    np.testing.assert_allclose(
        np.asarray(r_tp.x), np.asarray(r_ref.x), atol=1e-8)
