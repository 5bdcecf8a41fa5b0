"""Shared example runner: solve, print, and assert like the reference
examples do (each prints the iterate/eval and asserts the known minimum,
e.g. ``examples/gradient_descent_example.rs:56-70``)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# the reference examples are f64 on CPU, so the parity examples pin the CPU
# backend in x64 (see batched_rosenbrock_example.py for the
# accelerator-resident f32 path)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from optimization_solvers_tpu import linesearch as ls  # noqa: F401
from optimization_solvers_tpu import solvers  # noqa: F401
from optimization_solvers_tpu.core.oracle import make_oracle  # noqa: F401
from optimization_solvers_tpu.core.types import Status
from optimization_solvers_tpu.utils import Tracer, LogFormat


def report(name, res, f):
    Tracer().with_normal_stdout_layer().build()
    print(f"[{name}] iterate: {res.x}")
    print(f"[{name}] f(x*) = {float(res.f)}")
    print(f"[{name}] iterations: {int(res.iterations)}  status: {Status(int(res.status)).name}")
    return res


def check(res, x_star, f_star=0.0, *, x_tol=1e-5, f_tol=1e-10):
    """Reference-strictness example checks (examples/quadratic.rs:43 asserts
    the exact minimum): converged status, iterate at the known minimizer,
    value at the known minimum."""
    assert int(res.status) == int(Status.CONVERGED), Status(int(res.status))
    err = float(jnp.max(jnp.abs(res.x - jnp.asarray(x_star, res.x.dtype))))
    assert err < x_tol, f"|x - x*|_inf = {err}"
    assert abs(float(res.f) - f_star) < f_tol, f"f = {float(res.f)}"
