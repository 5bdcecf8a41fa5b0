"""Small-matrix Cholesky and triangular solves, unrolled in pure jnp.

The L-BFGS-B middle matrix is 2m x 2m with m in [3, 20]; a generic
batched LU/Cholesky library call is overkill there (slow to compile under
vmap, one library launch per factorization).  For such tiny systems an
unrolled Cholesky-Crout over the static dimension is a handful of
elementwise ops per column that XLA fuses into the surrounding step, and
it batches trivially.

All functions broadcast over leading batch axes; the matrix dimension is
static and fully unrolled.  Solves take matrix right-hand sides of shape
``(..., m, k)``; use :func:`spd_solve_small` for vector RHS.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cholesky_small(A: jax.Array) -> jax.Array:
    """Lower Cholesky factor of a small SPD matrix (static last dims m x m)."""
    m = A.shape[-1]
    L = jnp.zeros_like(A)
    for j in range(m):
        if j == 0:
            s = A[..., j, j]
        else:
            s = A[..., j, j] - jnp.sum(L[..., j, :j] * L[..., j, :j], axis=-1)
        ljj = jnp.sqrt(s)
        L = L.at[..., j, j].set(ljj)
        if j + 1 < m:
            if j == 0:
                col = A[..., j + 1 :, j]
            else:
                col = A[..., j + 1 :, j] - jnp.sum(
                    L[..., j + 1 :, :j] * L[..., None, j, :j], axis=-1
                )
            L = L.at[..., j + 1 :, j].set(col / ljj[..., None])
    return L


def solve_lower_small_mat(L: jax.Array, B: jax.Array) -> jax.Array:
    """Solve ``L Y = B`` (lower triangular), RHS ``B`` of shape (..., m, k)."""
    m = L.shape[-1]
    Y = jnp.zeros_like(B)
    for i in range(m):
        if i == 0:
            s = B[..., i, :]
        else:
            s = B[..., i, :] - jnp.sum(
                L[..., i, :i, None] * Y[..., :i, :], axis=-2
            )
        Y = Y.at[..., i, :].set(s / L[..., i, i, None])
    return Y


def solve_upper_small_mat(L: jax.Array, B: jax.Array) -> jax.Array:
    """Solve ``L^T X = B`` given lower ``L``, RHS of shape (..., m, k)."""
    m = L.shape[-1]
    X = jnp.zeros_like(B)
    for i in range(m - 1, -1, -1):
        if i == m - 1:
            s = B[..., i, :]
        else:
            s = B[..., i, :] - jnp.sum(
                L[..., i + 1 :, i, None] * X[..., i + 1 :, :], axis=-2
            )
        X = X.at[..., i, :].set(s / L[..., i, i, None])
    return X


def spd_solve_small_mat(Lch: jax.Array, B: jax.Array) -> jax.Array:
    """``A^{-1} B`` given ``Lch = cholesky_small(A)``; B (..., m, k)."""
    return solve_upper_small_mat(Lch, solve_lower_small_mat(Lch, B))


def spd_solve_small(Lch: jax.Array, b: jax.Array) -> jax.Array:
    """``A^{-1} b`` for vector RHS (..., m)."""
    return spd_solve_small_mat(Lch, b[..., None])[..., 0]
