"""Dense linear-algebra cores (reference L4-adjacent: the nalgebra
inverse/Cholesky calls at ``newton/mod.rs:36``, ``projected_newton.rs:75``,
``spn.rs:86``).  ``jnp.linalg.cholesky`` plus two triangular solves; XLA
hands both to cuSOLVER on the GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cholesky_solve(h: jax.Array, g: jax.Array) -> jax.Array:
    """Solve ``H s = g`` for SPD ``H`` via Cholesky (the reference's
    ``hessian.cholesky().unwrap().solve(g)``).  Non-PD ``H`` produces NaNs
    (XLA semantics) rather than a panic.  Broadcasts over leading batch
    dims."""
    chol = jnp.linalg.cholesky(h)
    y = jax.scipy.linalg.solve_triangular(chol, g, lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol, -1, -2), y, lower=False
    )


def solve_spd(h: jax.Array, g: jax.Array) -> jax.Array:
    """Alias used by Newton-family solvers."""
    return cholesky_solve(h, g)
