"""The capability the single-instance reference lacks: 1024 Rosenbrock-100
instances solved in lockstep through the one-call front end
(``ost.minimize`` with a (B, n) ``x0`` -> one compiled ``lax.while_loop``
for the whole batch).

Runs on whatever device JAX sees, in f32; the compile cache lives where
``$JAX_COMPILATION_CACHE_DIR`` says, else in the checkout's ``.jax_cache``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import optimization_solvers_tpu as ost
from optimization_solvers_tpu.core import problems
from optimization_solvers_tpu.utils import summarize
from optimization_solvers_tpu.utils.runtime import enable_compile_cache

enable_compile_cache()
n, batch = 100, 1024
x0 = jnp.asarray(np.random.RandomState(0).uniform(-2, 2, (batch, n)),
                 jnp.float32)
res = jax.jit(lambda x: ost.minimize(
    problems.rosenbrock(), x, method="lbfgsb", bounds=(-5.0, 5.0),
    tol=1e-3, m=5, factr=100.0, max_iter=600))(x0)
stats = summarize(res)
print(stats)
assert stats["converged"] == batch
