"""Evaluate a traced JAX objective (and its gradient) in f32x2 double-float.

The reference gets f64 oracles for free from the language
(``src/number.rs:3``).  This module emulates that precision for f32 inputs:
trace the user's objective (or its
``value_and_grad``) to a jaxpr once, then *interpret* that jaxpr with every
float flowing as a :class:`~optimization_solvers_tpu.core.df.DF` pair —
error-free-transform arithmetic, pairwise-tree reductions, near-df
transcendentals.  The result is the objective/gradient of the SAME f32
program evaluated to ~2^-47 relative precision: the cancellation noise that
capped f32 gradient accuracy at ~1e-4 absolute on the Rosenbrock class
vanishes, which is what lets a pg < 1e-6 stationarity certificate exist for
an f32 solve at all.

This is a jaxpr interpreter in the standard JAX-transform style (compare
``jax.experimental.jet`` or custom tracers): it runs at *trace* time inside
whatever jit/vmap/scan surrounds it, emitting ordinary f32 ops — so the
df oracle batches, shards, and fuses like any other JAX code.

Known, documented deviation from true f64 semantics: Python/f32 literals in
the objective stay f32 (``0.1`` means ``float32(0.1)``, not ``0.1f64``) —
the interpreter evaluates the f32-parameterized program exactly rather than
re-parameterizing it.  Objectives whose constants are exactly representable
in f32 (the whole reference example/test set) are unaffected.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
from jax import lax

_Literal = jax.extend.core.Literal

from optimization_solvers_tpu.core import df
from optimization_solvers_tpu.core.df import DF


def _is_float(aval) -> bool:
    return jnp.issubdtype(aval.dtype, jnp.floating)


def _lift(v) -> Any:
    """Lift a constant into the interpreter's value domain.

    Float components go through ``df._f32``, which launders compile-time
    constants past XLA's float-unsafe reassociate-constants rewrite (see
    its docstring) — without this, literals like the ``1.0`` in
    ``(1 - x)**2`` silently degrade the whole df evaluation to f32
    accuracy under jit."""
    v = jnp.asarray(v)
    if jnp.issubdtype(v.dtype, jnp.floating):
        if v.dtype == jnp.float64:      # host-side tracing under x64
            import numpy as _np

            hi = _np.asarray(v, _np.float64).astype(_np.float32)
            lo = (_np.asarray(v, _np.float64) - hi.astype(_np.float64)
                  ).astype(_np.float32)
            return DF(df._f32(hi), df._f32(lo))
        v = df._f32(v.astype(jnp.float32))
        return DF(v, jnp.zeros_like(v))
    return v


def _hi(v):
    return v.hi if isinstance(v, DF) else v


def _tree_reduce(x: DF, axis, combine, pad_hi):
    """Pairwise (binary-tree) reduction of a df array along one axis."""
    axis = axis % x.hi.ndim
    hi, lo = jnp.moveaxis(x.hi, axis, -1), jnp.moveaxis(x.lo, axis, -1)
    v = DF(hi, lo)
    n = v.hi.shape[-1]
    if n == 0:
        raise NotImplementedError("df reduction over empty axis")
    while n > 1:
        if n % 2:
            pad = [(0, 0)] * (v.hi.ndim - 1) + [(0, 1)]
            v = DF(jnp.pad(v.hi, pad, constant_values=pad_hi),
                   jnp.pad(v.lo, pad, constant_values=0.0))
            n += 1
        a = DF(v.hi[..., 0::2], v.lo[..., 0::2])
        b = DF(v.hi[..., 1::2], v.lo[..., 1::2])
        v = combine(a, b)
        n //= 2
    return DF(v.hi[..., 0], v.lo[..., 0])


def _reduce(x: DF, axes, combine, pad_hi) -> DF:
    for ax in sorted(axes, reverse=True):
        x = _tree_reduce(x, ax, combine, pad_hi)
    return x


def _dot_general(lhs: DF, rhs: DF, dimension_numbers, **_) -> DF:
    """df dot_general: exact per-element products + pairwise-tree contraction
    (no matrix product is used — by design, a TF32 pass cannot leak in;
    same rationale as ``core.numerics.dot``)."""
    (lc, rc), (lb, rb) = dimension_numbers

    def arrange(v, batch, contract):
        # -> (prod(batch), prod(free), prod(contract)), remembering frees
        free = [i for i in range(v.hi.ndim)
                if i not in batch and i not in contract]
        perm = list(batch) + free + list(contract)
        hi = jnp.transpose(v.hi, perm)
        lo = jnp.transpose(v.lo, perm)
        bsh = [v.hi.shape[i] for i in batch]
        fsh = [v.hi.shape[i] for i in free]
        csh = [v.hi.shape[i] for i in contract]
        shp = (int(np.prod(bsh, dtype=np.int64)) if bsh else 1,
               int(np.prod(fsh, dtype=np.int64)) if fsh else 1,
               int(np.prod(csh, dtype=np.int64)) if csh else 1)
        return DF(hi.reshape(shp), lo.reshape(shp)), bsh, fsh

    L, bsh, lfsh = arrange(lhs, lb, lc)
    R, _, rfsh = arrange(rhs, rb, rc)
    a = DF(L.hi[:, :, None, :], L.lo[:, :, None, :])
    b = DF(R.hi[:, None, :, :], R.lo[:, None, :, :])
    out = _tree_reduce(df.mul(a, b), -1, df.add, 0.0)     # (B, Lf, Rf)
    out_shape = tuple(bsh) + tuple(lfsh) + tuple(rfsh)
    return DF(out.hi.reshape(out_shape), out.lo.reshape(out_shape))


def _integer_pow(x: DF, y: int) -> DF:
    if y >= 0:
        return df.powi(x, y)
    inv = df.powi(x, -y)
    one = df.from_f32(jnp.ones_like(x.hi))
    return df.div(one, inv)


def _select_n(pred, *cases):
    if not isinstance(cases[0], DF):
        return lax.select_n(pred, *cases)
    hi = lax.select_n(pred, *[c.hi for c in cases])
    lo = lax.select_n(pred, *[c.lo for c in cases])
    return DF(hi, lo)


def _convert(v, new_dtype, **_):
    if isinstance(v, DF):
        if jnp.issubdtype(new_dtype, jnp.floating):
            return v                      # df stays df (f32/f64 alike)
        return lax.convert_element_type(v.hi, new_dtype)
    if jnp.issubdtype(new_dtype, jnp.floating):
        return _lift(lax.convert_element_type(v, jnp.float32))
    return lax.convert_element_type(v, new_dtype)


def _sign(x: DF):
    return _lift(jnp.sign(x.hi))


# value-domain rules: f(DF args, **params) -> DF (or raw for predicates)
_RULES = {
    "add": lambda a, b: df.add(a, b),
    "add_any": lambda a, b: df.add(a, b),
    "sub": lambda a, b: df.sub(a, b),
    "mul": lambda a, b: df.mul(a, b),
    "div": lambda a, b: df.div(a, b),
    "neg": lambda a: df.neg(a),
    "abs": lambda a: df.abs_(a),
    "sign": _sign,
    "max": lambda a, b: df.maximum(a, b),
    "min": lambda a, b: df.minimum(a, b),
    "exp": lambda a, **kw: df.exp(a),
    "log": lambda a, **kw: df.log(a),
    "expm1": lambda a, **kw: df.expm1(a),
    "log1p": lambda a, **kw: df.log1p(a),
    "tanh": lambda a, **kw: df.tanh(a),
    "logistic": lambda a, **kw: df.logistic(a),
    "sqrt": lambda a, **kw: df.sqrt(a),
    "rsqrt": lambda a, **kw: df.div(
        df.from_f32(jnp.ones_like(a.hi)), df.sqrt(a)),
    "integer_pow": lambda a, y: _integer_pow(a, y),
    "pow": lambda a, b, **kw: df.exp(df.mul(b, df.log(a))),
    "reduce_sum": lambda a, axes, **kw: _reduce(a, axes, df.add, 0.0),
    "reduce_max": lambda a, axes, **kw: _reduce(
        a, axes, df.maximum, -jnp.inf),
    "reduce_min": lambda a, axes, **kw: _reduce(
        a, axes, df.minimum, jnp.inf),
    "dot_general": _dot_general,
    "select_n": _select_n,
    "convert_element_type": _convert,
    "stop_gradient": lambda a: a,
    "copy": lambda a: a,
    "lt": lambda a, b: df.lt(a, b) if isinstance(a, DF) else a < b,
    "le": lambda a, b: df.le(a, b) if isinstance(a, DF) else a <= b,
    "gt": lambda a, b: df.gt(a, b) if isinstance(a, DF) else a > b,
    "ge": lambda a, b: df.ge(a, b) if isinstance(a, DF) else a >= b,
    "eq": lambda a, b: ((a.hi == b.hi) & (a.lo == b.lo))
    if isinstance(a, DF) else a == b,
    "ne": lambda a, b: ((a.hi != b.hi) | (a.lo != b.lo))
    if isinstance(a, DF) else a != b,
    "is_finite": lambda a: jnp.isfinite(a.hi) if isinstance(a, DF)
    else jnp.isfinite(a),
}

# shape-only primitives: bind componentwise on (hi, lo) with the original
# static params — correct because they move data without arithmetic
_STRUCTURAL = {
    "broadcast_in_dim", "reshape", "transpose", "slice", "squeeze",
    "expand_dims", "rev", "concatenate", "pad", "dynamic_slice",
    "gather",
}


def _bind_structural(prim, args, params):
    if not any(isinstance(a, DF) for a in args):
        return prim.bind(*args, **params)
    his = [_hi(a) for a in args]
    los = [a.lo if isinstance(a, DF) else a for a in args]
    return DF(prim.bind(*his, **params), prim.bind(*los, **params))


def eval_jaxpr_df(jaxpr, consts, *args):
    """Interpret ``jaxpr`` with float leaves as DF pairs.

    ``args`` match the jaxpr invars: DF for float avals, raw arrays
    otherwise.  Returns the outvars in the same convention.  Raises
    ``NotImplementedError`` naming the primitive on anything outside the
    rule table — loud, so unsupported objectives fail at build time, not
    with silent precision loss.
    """
    env = {}

    def read(v):
        if isinstance(v, _Literal):
            return _lift(v.val)
        return env[v]

    def write(v, val):
        env[v] = val

    for v, c in zip(jaxpr.constvars, consts):
        write(v, _lift(c))
    for v, a in zip(jaxpr.invars, args):
        write(v, a)

    for eqn in jaxpr.eqns:
        prim = eqn.primitive
        name = prim.name
        vals = [read(v) for v in eqn.invars]
        if name in ("pjit", "closed_call", "custom_jvp_call",
                    "custom_vjp_call", "custom_vjp_call_jaxpr",
                    "remat", "checkpoint"):
            sub = (eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
                   or eqn.params.get("fun_jaxpr"))
            closed = sub if hasattr(sub, "jaxpr") else None
            inner = closed.jaxpr if closed is not None else sub
            inner_consts = closed.consts if closed is not None else ()
            if name.startswith("custom_"):
                # drop the rule operands: call_jaxpr consumes the primal args
                nargs = len(inner.invars)
                vals = vals[len(vals) - nargs:]
            outs = eval_jaxpr_df(inner, inner_consts, *vals)
        elif name in _STRUCTURAL:
            outs = [_bind_structural(prim, vals, eqn.params)]
        elif name in _RULES:
            outs = [_RULES[name](*vals, **eqn.params)]
        else:
            raise NotImplementedError(
                f"f32x2 interpreter has no rule for primitive {name!r}; "
                f"supported: {sorted(_RULES) + sorted(_STRUCTURAL)}")
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        if prim.multiple_results:
            for v, o in zip(eqn.outvars, outs):
                write(v, o)
        else:
            write(eqn.outvars[0], outs[0])

    return [read(v) for v in jaxpr.outvars]


def df_value_and_grad(f, example_x, data=()):
    """Build ``(x: DF) -> (f: DF scalar, g: DF)`` evaluating the objective
    AND its reverse-mode gradient in f32x2.

    ``example_x`` fixes the trace shape/dtype (f32, unbatched — wrap the
    result in ``jax.vmap`` for a batch; the interpreter is transform-
    transparent).  ``data`` rides into the trace as constants, lifted
    exactly into df."""
    fx = (lambda x: f(x, *data)) if data else f
    example = jnp.zeros(jnp.shape(example_x), jnp.float32)
    closed = jax.make_jaxpr(jax.value_and_grad(fx))(example)

    def run(x: DF):
        with df.launder_constants(df.runtime_true(x.hi)):
            fv, gv = eval_jaxpr_df(closed.jaxpr, closed.consts, x)
        return fv, gv

    return run


def df_value(f, example_x, data=()):
    """Value-only sibling of :func:`df_value_and_grad`."""
    fx = (lambda x: f(x, *data)) if data else f
    example = jnp.zeros(jnp.shape(example_x), jnp.float32)
    closed = jax.make_jaxpr(fx)(example)

    def run(x: DF):
        with df.launder_constants(df.runtime_true(x.hi)):
            (fv,) = eval_jaxpr_df(closed.jaxpr, closed.consts, x)
        return fv

    return run
