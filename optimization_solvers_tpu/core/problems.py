"""Problem library: the reference example/test objectives plus batched,
high-dimensional benchmark problems.

Mirrors the de-facto integration suite of the reference
(``/root/reference/examples/README.md:17-93`` and the inline solver tests,
e.g. ``src/steepest_descent/gradient_descent.rs:86-179``): the
ill-conditioned 2-D quadratic family, the small coupled quadratics of the
``examples/`` programs, the exp-bowl Newton example, and box-constrained
variants — extended with Rosenbrock-n and log-sum-exp for the large-scale
benchmark configs (``BASELINE.json`` configs 2 and 4), which the
single-instance reference never exercises.

Every entry is a plain scalar objective ``f(x) -> float`` suitable for
:func:`optimization_solvers_tpu.core.oracle.make_oracle`; known minimizers
are provided for golden tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quadratic_2d(gamma: float):
    """``f = 0.5 (x0^2 + gamma x1^2)`` — the reference's universal inline test
    problem with gamma in {1, 90, 999, 1222, 1e9}
    (e.g. ``gradient_descent.rs:95-99``, ``spg.rs:147-205``)."""

    def f(x):
        return 0.5 * (x[0] ** 2 + gamma * x[1] ** 2)

    return f


def example_gd():
    """``f = x1^2 + 2 x2^2`` (``examples/gradient_descent_example.rs:18``);
    min 0 at origin."""

    def f(x):
        return x[0] ** 2 + 2.0 * x[1] ** 2

    return f


def example_bfgs():
    """``f = x1^2 + 2 x2^2 + 3 x3^2 + x1 x2 + x2 x3``
    (``examples/bfgs_example.rs:17``); min 0 at origin."""

    def f(x):
        return (
            x[0] ** 2
            + 2.0 * x[1] ** 2
            + 3.0 * x[2] ** 2
            + x[0] * x[1]
            + x[1] * x[2]
        )

    return f


def exp_bowl():
    """``f = x1^2 + x2^2 + exp(x1^2 + x2^2)``
    (``examples/newton_example.rs:16``, ``examples/spg_example.rs:18``);
    min f = 1 at the origin."""

    def f(x):
        r2 = jnp.sum(x**2)
        return r2 + jnp.exp(r2)

    return f


def shifted_quadratic_2d():
    """``f = (x1-2)^2 + (x2-3)^2`` (``examples/projected_gradient_example.rs:18``);
    unconstrained min 0 at (2, 3); with box [[-inf,1],[-inf,1]] the
    constrained min is 5 at (1, 1) (``examples/README.md:60-66``)."""

    def f(x):
        return (x[0] - 2.0) ** 2 + (x[1] - 3.0) ** 2

    return f


def quadratic_form(matrix: jax.Array):
    """``f = x^T M x`` (``examples/quadratic.rs:12``)."""

    def f(x):
        return jnp.sum(x * (matrix @ x))

    return f


def quadratic(Q: jax.Array, b: jax.Array | None = None):
    """General convex quadratic ``f = 0.5 x^T Q x + b^T x``."""

    def f(x):
        v = 0.5 * jnp.sum(x * (Q @ x))
        if b is not None:
            v = v + jnp.sum(b * x)
        return v

    return f


def diag_quadratic(d: jax.Array):
    """Separable quadratic ``f = 0.5 sum d_i x_i^2`` — the n-dimensional
    generalization of :func:`quadratic_2d` used for the 100-D baseline
    config (``BASELINE.json`` config 1)."""

    def f(x):
        return 0.5 * jnp.sum(d * x**2)

    return f


def rosenbrock():
    """n-dimensional Rosenbrock ``sum_i 100 (x_{i+1} - x_i^2)^2 + (1-x_i)^2``;
    min 0 at the all-ones vector.  Headline benchmark objective
    (``BASELINE.json``: 10k-batch Rosenbrock-100)."""

    def f(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    return f


def log_sum_exp(A: jax.Array, b: jax.Array):
    """``f = log sum_i exp(a_i^T x + b_i)`` — smooth convex objective for the
    block-partitioned multi-host config (``BASELINE.json`` config 4)."""

    def f(x):
        return jax.nn.logsumexp(A @ x + b)

    return f


def random_quadratic(key: jax.Array, n: int, cond: float = 1e2, dtype=jnp.float32):
    """Random SPD quadratic with condition number ``cond``; returns
    ``(f, Q, x_star)`` with minimizer ``x_star = 0``."""
    k1, _ = jax.random.split(key)
    q, _ = jnp.linalg.qr(jax.random.normal(k1, (n, n), dtype=jnp.float32))
    eigs = jnp.logspace(0.0, jnp.log10(cond), n, dtype=jnp.float32)
    Q = (q * eigs) @ q.T
    Q = (0.5 * (Q + Q.T)).astype(dtype)
    return quadratic(Q), Q, jnp.zeros((n,), dtype)
