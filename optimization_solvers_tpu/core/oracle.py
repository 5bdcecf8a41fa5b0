"""Oracle layer: autodiff function-evaluation protocol.

Batched re-design of the reference oracle seam
(``/root/reference/src/func_eval.rs:5-41``): the reference takes user closures
``FnMut(&DVector<f64>) -> FuncEvalMultivariate`` with *analytic* gradients and
no autodiff anywhere.  Here the default path is a jitted
``jax.value_and_grad`` (+ ``jax.hessian``) oracle built from a plain scalar
objective, while hand-written oracles (the reference seam, also used by the
WASM binding ``/root/reference/src/wasm.rs:84-106``) remain supported via
:func:`ensure_oracle`.

Line searches that only test the Armijo condition (backtracking / GLL) call
:meth:`Oracle.value`, skipping the gradient computation entirely — a cost the
reference cannot avoid because its oracles always return ``(f, g)``.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax

from optimization_solvers_tpu.core.types import FuncEval


class Oracle:
    """A function-evaluation oracle ``x -> FuncEval``.

    ``value(x)`` is the cheap value-only path used by Armijo-only line
    searches; it falls back to the full evaluation when no value function is
    available (e.g. wrapped user oracles).
    """

    def __init__(
        self,
        full_fn: Callable[[jax.Array], FuncEval],
        value_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
    ):
        self._full = full_fn
        self._value = value_fn

    def __call__(self, x: jax.Array) -> FuncEval:
        ev = self._full(x)
        if not isinstance(ev, FuncEval):
            # tolerate (f, g) / (f, g, h) tuples, mirroring the reference
            # From<(Floating, DVector)> impl (func_eval.rs:36-41)
            ev = FuncEval(*ev)
        return ev

    def value(self, x: jax.Array) -> jax.Array:
        if self._value is not None:
            return self._value(x)
        return self(x).f


def make_oracle(
    f: Callable[..., jax.Array],
    *,
    with_hessian: bool = False,
    data: tuple = (),
) -> Oracle:
    """Build an autodiff oracle from a scalar objective ``f(x) -> f``.

    Replaces the reference's hand-written analytic oracles: gradients come
    from reverse-mode AD and (optionally) Hessians from forward-over-reverse,
    all fused by XLA into the surrounding jitted solve.

    ``data`` carries problem-data arrays explicitly: the objective is called
    as ``f(x, *data)`` (the JAX-idiomatic split of code vs. arrays, same
    shape as flax's params-outside-module).
    """
    data = tuple(jax.numpy.asarray(c) for c in data)
    f_x = (lambda x: f(x, *data)) if data else f
    value_and_grad = jax.value_and_grad(f_x)
    hess = jax.hessian(f_x) if with_hessian else None

    def full(x: jax.Array) -> FuncEval:
        fv, g = value_and_grad(x)
        h = hess(x) if hess is not None else None
        return FuncEval(fv, g, h)

    oracle = Oracle(full, value_fn=f_x)

    # Hessian-vector products via forward-over-reverse (~2 gradient
    # evaluations, no (n, n) storage) — the matrix-free second-order seam
    # used by the truncated Newton-CG solver
    _g = jax.grad(f_x)

    def hvp(x: jax.Array, v: jax.Array) -> jax.Array:
        return jax.jvp(_g, (x,), (v,))[1]

    oracle.hvp = hvp
    return oracle


def ensure_oracle(oracle) -> Oracle:
    """Coerce a plain callable ``x -> FuncEval`` (the reference seam) to
    :class:`Oracle`."""
    if isinstance(oracle, Oracle):
        return oracle
    return Oracle(oracle)
