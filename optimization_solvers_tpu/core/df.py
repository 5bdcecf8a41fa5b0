"""Double-float ("f32x2") arithmetic: emulated-f64 precision from f32 ops.

The reference computes everything in f64 (``/root/reference/src/number.rs:3``,
``type Floating = f64``).  This module emulates f64-grade precision for
f32 inputs while computing only in f32: each scalar is an unevaluated
pair ``hi + lo`` of f32 with ``|lo| <= ulp(hi)/2``, carried through
error-free transformations (Dekker/Knuth two_sum / two_prod; Bailey/Hida
double-double add/mul/div/sqrt).  Working precision is ~2^-47 relative
(~1.4e-14) — slightly under true f64 (2^-53) but 6-7 decimal digits beyond
plain f32, which is what the strict-tolerance certification wall needs
(f32 gradients carry ~1e-4 absolute cancellation noise on the Rosenbrock
class; a pg < 1e-6 certificate is unreachable in plain f32).

All functions are elementwise on arrays and shape-polymorphic, jit/vmap
compatible, and use only elementwise f32 ops (adds, muls, selects) —
nothing here is a matrix product, so no reduced-precision (TF32) tensor-core
pass can leak in.  XLA preserves IEEE f32
semantics for these ops by default; the error-free transforms rely on that
(and NOT on reassociation being disabled anywhere special).

Transcendentals are computed to near-df accuracy, not f32-ulp accuracy:
``exp`` by range reduction (k*ln2 with ln2 held as a df constant) plus a
df Taylor tail, ``log`` by one df Newton step off the f32 seed.  This
matters: the point of f32x2 is removing evaluation error, and an f32-ulp
exp (~6e-8 relative) would silently cap gradient accuracy on LSE-class
objectives.

No reference-crate counterpart exists (the reference gets f64 from the
language); cited per component where the SEMANTICS mirror the reference's
f64 behavior.
"""

from __future__ import annotations

import contextlib as _contextlib
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Dekker split constant for f32: 2^12 + 1 (f32 has 24 mantissa bits)
_SPLIT = 4097.0


class DF(NamedTuple):
    """A double-float value: ``hi + lo`` with ``|lo| <= ulp(hi)/2``.

    A pytree of two same-shaped f32 arrays; flows through jit/vmap/scan
    like any other pair."""

    hi: jax.Array
    lo: jax.Array

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype


# Ambient runtime zero for constant laundering — see _f32.  A plain list so
# the context manager below can nest; trace-time Python state (everything
# here runs while tracing, like any JAX transform).
_RT0 = [None]


@_contextlib.contextmanager
def launder_constants(pred):
    """Within this context, every constant lifted by df ops is routed
    through ``where(pred, c, 0)`` with ``pred`` a runtime-true boolean
    from :func:`runtime_true` — making it opaque to the compiler.

    Why: XLA's algebraic simplifier treats f32 addition as associative
    when constants are involved (measured on this stack, two distinct
    rewrites: ``(c + b) - c -> b``, and re-association that hoists ``c``
    back out of an ``add(c, rt)`` laundering sum), which silently deletes
    the :func:`two_sum` error-free transform whenever one operand is a
    compile-time constant — eager df was ~2e-15 relative, the SAME code
    under jit ~1e-7 absolute.  ``lax.optimization_barrier`` does NOT
    survive this toolchain's pipeline (measured: stripped from the
    optimized HLO), and additive laundering (``c + runtime_zero``) is
    re-associated away.  A *select* with a runtime predicate survives:
    the simplifier folds ``select`` only for constant predicates, and no
    add/sub pattern sees a constant operand through it.  Pinned by
    tests/test_df.py::test_jit_matches_eager_precision."""
    old = _RT0[0]
    _RT0[0] = pred
    try:
        yield
    finally:
        _RT0[0] = old


def runtime_true(v) -> jax.Array:
    """A boolean scalar that is always True at runtime but opaque to the
    compiler (derived from ``v``; NaN/inf-hardened so poisoned inputs
    cannot flip it)."""
    z = jnp.asarray(v, jnp.float32).ravel()
    v0 = z[0] if z.size else jnp.zeros((), jnp.float32)
    v0 = jnp.where(jnp.isfinite(v0), v0, jnp.zeros((), jnp.float32))
    return (v0 * 0.0) == 0.0


def _f32(x):
    """Lift to f32, laundering constants when an ambient runtime-true
    predicate is installed (:func:`launder_constants`).

    Laundering applies UNCONDITIONALLY inside the context: on this JAX
    version a constant inserted during tracing is itself a tracer
    (constant lifting), so "is it concrete?" cannot distinguish constants
    from runtime values — and ``where(true, v, 0)`` is semantically exact
    for both, costing one fused select."""
    v = jnp.asarray(x, jnp.float32)
    if _RT0[0] is not None:
        v = jnp.where(_RT0[0], v, jnp.zeros_like(v))
    return v


def from_f32(hi, lo=None) -> DF:
    """Lift an f32 array (exactly) into df; ``lo`` defaults to zero."""
    hi = _f32(hi)
    return DF(hi, jnp.zeros_like(hi) if lo is None else _f32(lo))


def from_f64(x) -> DF:
    """Split a host-side f64 array into (hi, lo) f32 pairs exactly
    (to f32x2 resolution).  Host/test helper — the solve itself stays in
    f32; on-device values enter via :func:`from_f32`."""
    import numpy as np

    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF(jnp.asarray(hi), jnp.asarray(lo))


def to_f64(a: DF):
    """Host-side recombination for tests/reporting (f64 = hi + lo)."""
    import numpy as np

    return np.asarray(a.hi, np.float64) + np.asarray(a.lo, np.float64)


def two_sum(a, b):
    """Knuth: s + err == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Dekker: requires |a| >= |b| (or a == 0); 3 flops."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """p + err == a * b exactly, p = fl(a * b) (Dekker, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def add(x: DF, y: DF) -> DF:
    """Accurate double-double addition (Hida-Li-Bailey ``ieee_add``)."""
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = fast_two_sum(s, e)
    e = e + f
    s, e = fast_two_sum(s, e)
    return DF(s, e)


def add_f(x: DF, y) -> DF:
    s, e = two_sum(x.hi, _f32(y))
    e = e + x.lo
    return DF(*fast_two_sum(s, e))


def neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def sub(x: DF, y: DF) -> DF:
    return add(x, neg(y))


def sub_f(x: DF, y) -> DF:
    return add_f(x, -_f32(y))


def mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DF(*fast_two_sum(p, e))


def mul_f(x: DF, y) -> DF:
    y = _f32(y)
    p, e = two_prod(x.hi, y)
    e = e + x.lo * y
    return DF(*fast_two_sum(p, e))


def div(x: DF, y: DF) -> DF:
    """Long division with two df remainder corrections (QD ``ddiv``)."""
    q1 = x.hi / y.hi
    r = sub(x, mul_f(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_f(y, q2))
    q3 = r.hi / y.hi
    s, e = fast_two_sum(q1, q2)
    return add_f(DF(s, e), q3)


def sqrt(x: DF) -> DF:
    """Karp-Markstein: f32 seed + one df correction step; df-accurate for
    x > 0 (0 maps to 0; negatives produce NaN like f64 sqrt would)."""
    y0 = jnp.sqrt(x.hi)
    # r = x - y0^2 (df-exact), correction r / (2 y0)
    sq = DF(*two_prod(y0, y0))
    r = sub(x, sq)
    corr = r.hi / (2.0 * y0)
    out = DF(*fast_two_sum(y0, corr))
    # sqrt(0) = 0 (the correction divides by 0)
    zero = x.hi == 0.0
    return DF(jnp.where(zero, 0.0, out.hi), jnp.where(zero, 0.0, out.lo))


def abs_(x: DF) -> DF:
    flip = x.hi < 0.0
    return DF(jnp.where(flip, -x.hi, x.hi), jnp.where(flip, -x.lo, x.lo))


def where(c, x: DF, y: DF) -> DF:
    return DF(jnp.where(c, x.hi, y.hi), jnp.where(c, x.lo, y.lo))


# comparisons: valid because df values are normalized (|lo| <= ulp(hi)/2)
def lt(x: DF, y: DF):
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo < y.lo))


def le(x: DF, y: DF):
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo <= y.lo))


def gt(x: DF, y: DF):
    return lt(y, x)


def ge(x: DF, y: DF):
    return le(y, x)


def maximum(x: DF, y: DF) -> DF:
    return where(ge(x, y), x, y)


def minimum(x: DF, y: DF) -> DF:
    return where(le(x, y), x, y)


def clip(x: DF, lo: DF, hi: DF) -> DF:
    return minimum(maximum(x, lo), hi)


def tree_sum(x: DF, axis: int = -1) -> DF:
    """Sum along ``axis`` by pairwise (binary-tree) df addition.

    log2(n) levels of vectorized :func:`add` — each level halves the axis
    (odd remainders fold in via a zero pad, exact).  The reference's f64
    ``jnp.sum`` has error ~n*2^-53; this has ~log(n)*2^-47 with NO
    cancellation blowup, which is the property the oracle accumulations
    need (SURVEY.md §2.4 hot cores; used by df dot products and the
    interpreter's reduce_sum rule)."""
    axis = axis % x.hi.ndim
    hi, lo = jnp.moveaxis(x.hi, axis, -1), jnp.moveaxis(x.lo, axis, -1)
    v = DF(hi, lo)
    n = v.hi.shape[-1]
    while n > 1:
        if n % 2:
            pad = [(0, 0)] * (v.hi.ndim - 1) + [(0, 1)]
            v = DF(jnp.pad(v.hi, pad), jnp.pad(v.lo, pad))
            n += 1
        a = DF(v.hi[..., 0::2], v.lo[..., 0::2])
        b = DF(v.hi[..., 1::2], v.lo[..., 1::2])
        v = add(a, b)
        n //= 2
    return DF(v.hi[..., 0], v.lo[..., 0])


def dot(x: DF, y: DF, axis: int = -1) -> DF:
    """df inner product: exact per-element products (two_prod) + pairwise
    tree accumulation.  The f32x2 sibling of ``core.numerics.dot`` (which
    exists because an f32 ``@`` may run in TF32 — here no matrix product
    is used at all)."""
    return tree_sum(mul(x, y), axis=axis)


# ---- transcendentals (near-df accuracy, see module docstring) ----------

def const(v: float, like) -> DF:
    """A host-f64 constant as a df pair broadcast to ``like``'s shape
    (components constant-laundered — see :func:`_f32`)."""
    import numpy as np

    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return DF(_f32(jnp.full_like(like, hi)), _f32(jnp.full_like(like, lo)))


def _exp2i(k):
    """Exact 2^k for integer-valued f32 ``k`` in [-126, 127], via exponent
    bit construction.  ``jnp.exp2`` is only f32-ULP accurate (measured:
    exp2(15) -> 32767.984 on this stack) — a silent 5e-7 relative error
    that would defeat the whole df exp."""
    ki = k.astype(jnp.int32)
    return jax.lax.bitcast_convert_type((ki + 127) << 23, jnp.float32)


def exp(x: DF) -> DF:
    """df exp by range reduction: x = k*ln2 + r, |r| <= ln2/2, e^r by a
    df Taylor tail (13 terms, |r|^14/14! < 2^-48), exact scale by 2^k.

    Inputs far outside f32 exp's domain behave like f32: overflow -> inf,
    underflow -> 0."""
    k = jnp.round(x.hi / 0.6931471805599453)
    # r = x - k*ln2, with ln2 as a df constant (exact to 2^-47)
    r = sub(x, mul_f(const(0.6931471805599453, x.hi), k))
    # Taylor: sum r^i/i! for i=0..13, Horner in df with df 1/i constants
    acc = from_f32(jnp.ones_like(x.hi))
    for i in range(13, 0, -1):
        acc = add_f(mul(acc, mul(r, const(1.0 / i, x.hi))), 1.0)
    kc = jnp.clip(k, -126.0, 127.0)
    s = _exp2i(kc)
    out = DF(acc.hi * s, acc.lo * s)
    over = x.hi > 88.72
    under = x.hi < -87.33
    hi = jnp.where(over, jnp.inf, jnp.where(under, 0.0, out.hi))
    lo = jnp.where(over | under, 0.0, out.lo)
    return DF(hi, lo)


def log(x: DF) -> DF:
    """df log: f32 seed + one Newton step ``y += x*exp(-y) - 1`` with the
    df exp above (doubles the seed's correct digits twice over)."""
    y0 = jnp.log(x.hi)
    # y1 = y0 + x*exp(-y0) - 1   (df)
    e = exp(DF(-y0, jnp.zeros_like(y0)))
    y = add_f(sub_f(mul(x, e), 1.0), y0)
    # one more step for full df accuracy
    e2 = exp(neg(y))
    return add(sub_f(mul(x, e2), 1.0), y)


def expm1(x: DF) -> DF:
    """df expm1: exact df subtraction after :func:`exp` — no cancellation
    for small x because exp's Taylor path keeps the low word."""
    return sub_f(exp(x), 1.0)


def log1p(x: DF) -> DF:
    """df log1p: ``log(1 + x)`` with the addition done in df (exact), so
    small-x accuracy is preserved."""
    return log(add_f(x, 1.0))


def tanh(x: DF) -> DF:
    """df tanh via the exp identity, on the numerically stable side:
    ``tanh(x) = sign(x) * (1 - 2/(e^{2|x|} + 1))``."""
    ax = abs_(x)
    e2 = exp(mul_f(ax, 2.0))
    two = from_f32(jnp.full_like(x.hi, 2.0))
    t = sub(from_f32(jnp.ones_like(x.hi)), div(two, add_f(e2, 1.0)))
    flip = x.hi < 0.0
    return DF(jnp.where(flip, -t.hi, t.hi), jnp.where(flip, -t.lo, t.lo))


def logistic(x: DF) -> DF:
    """df sigmoid ``1 / (1 + e^{-x})`` computed on the stable side."""
    ax = abs_(x)
    e = exp(neg(ax))                      # in (0, 1]
    one = from_f32(jnp.ones_like(x.hi))
    p = div(one, add_f(e, 1.0))           # sigmoid(|x|)
    q = sub(one, p)                       # sigmoid(-|x|), exact in df
    pos = x.hi >= 0.0
    return DF(jnp.where(pos, p.hi, q.hi), jnp.where(pos, p.lo, q.lo))


def powi(x: DF, n: int) -> DF:
    """Integer power by binary exponentiation (df); n >= 0."""
    if n == 0:
        return from_f32(jnp.ones_like(x.hi))
    acc = None
    base = x
    while n:
        if n & 1:
            acc = base if acc is None else mul(acc, base)
        n >>= 1
        if n:
            base = mul(base, base)
    return acc
