"""Vector substrate: box projection, norms, safe clamps.

Batched equivalent of the reference L0 layer
(``/root/reference/src/number.rs:5-31``).  Everything is shape-polymorphic
jnp code that vectorizes under ``vmap`` and shards under ``pjit``; the
reference's per-element Rust loops become elementwise array ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def box_projection(x: jax.Array, lower: jax.Array, upper: jax.Array) -> jax.Array:
    """Clamp ``x`` into ``[lower, upper]`` elementwise.

    Reference: ``number.rs:5-21`` (``self.sup(l).inf(u)``).  ``lower``/``upper``
    may contain ``+/-inf`` for one-sided or absent bounds.
    """
    return jnp.minimum(jnp.maximum(x, lower), upper)


def infinity_norm(v: jax.Array) -> jax.Array:
    """``max_i |v_i|`` along the last axis.  Reference: ``number.rs:23-31``."""
    return jnp.max(jnp.abs(v), axis=-1)


def projected_gradient(
    g: jax.Array, x: jax.Array, lower: jax.Array, upper: jax.Array
) -> jax.Array:
    """Zero out gradient components that push against an active bound.

    Reference: ``HasProjectedGradient::projected_gradient``
    (``ls_solver.rs:121-133``): at ``x_i == lower_i`` with ``g_i > 0`` or
    ``x_i == upper_i`` with ``g_i < 0`` the first-order optimality residual
    is zero, so those components are masked.
    """
    at_lower = (x == lower) & (g > 0)
    at_upper = (x == upper) & (g < 0)
    return jnp.where(at_lower | at_upper, jnp.zeros_like(g), g)


def rust_min(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a.min(b)`` with Rust f64 semantics: NaN operands are *discarded*
    (``f64::min(NaN, x) == x``) instead of propagated like ``jnp.minimum``.
    The More-Thuente trial-value selection relies on this
    (``morethuente.rs:268-270``)."""
    return jnp.where(jnp.isnan(a), b, jnp.where(jnp.isnan(b), a, jnp.minimum(a, b)))


def rust_max(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a.max(b)`` with Rust NaN-discarding semantics (see :func:`rust_min`)."""
    return jnp.where(jnp.isnan(a), b, jnp.where(jnp.isnan(b), a, jnp.maximum(a, b)))


def rust_clamp(t: jax.Array, t_min, t_max) -> jax.Array:
    """``t.max(t_min).min(t_max)`` with Rust float max/min NaN semantics.

    Rust's ``f64::max(NaN, a) == a`` (NaN is discarded), whereas
    ``jnp.maximum`` propagates NaN.  The More-Thuente trial step is clamped
    this way in the reference (``morethuente.rs:290``), and a NaN trial there
    must collapse to ``t_min`` for parity.
    """
    t1 = jnp.where(jnp.isnan(t), t_min, jnp.maximum(t, t_min))
    return jnp.minimum(t1, t_max)


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Last-axis inner product as an elementwise multiply-reduce.

    On a GPU, ``a @ b`` in float32 lowers to a DEFAULT-precision
    dot_general that XLA may run on the tensor cores in TF32 — a 10-bit
    mantissa, about three decimal digits, which destroys the curvature dot
    products (s.y, y.y, g.d) every quasi-Newton update depends on.  An
    elementwise multiply-reduce never touches the tensor cores and keeps
    full f32.
    """
    return jnp.sum(a * b, axis=-1)


def matvec(A: jax.Array, x: jax.Array) -> jax.Array:
    """``A @ x`` over the last two axes at HIGHEST precision (true f32
    instead of the TF32 a DEFAULT-precision f32 product may use; see
    :func:`dot`)."""
    return jnp.einsum(
        "...ij,...j->...i", A, x, precision=jax.lax.Precision.HIGHEST
    )


def matmat(A: jax.Array, B: jax.Array) -> jax.Array:
    """``A @ B`` at HIGHEST precision (see :func:`dot`)."""
    return jnp.einsum(
        "...ij,...jk->...ik", A, B, precision=jax.lax.Precision.HIGHEST
    )


def batched_pg_inf_norm(x, g, lower=None, upper=None):
    """Per-row stationarity measure over a trailing coordinate axis:
    ``||x - P_box(x - g)||_inf`` (plain ``||g||_inf`` when unbounded) — the
    Fortran's ``sbgnrm``, used to fill ``SolveResult.pg_norm``."""
    if lower is None:
        return jnp.max(jnp.abs(g), axis=-1)
    return jnp.max(jnp.abs(x - jnp.clip(x - g, lower, upper)), axis=-1)
