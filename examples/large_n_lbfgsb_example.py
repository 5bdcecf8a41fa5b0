"""Large-n bounded L-BFGS-B (the BASELINE config-4 workload class): a
10,000-dimensional bounded log-sum-exp batch through the one-call front
end (the lockstep batched L-BFGS-B).

Reference capability: the Fortran ``setulb_`` core reached from
``src/quasi_newton/lbfgsb.rs:34-85`` (one instance at a time on the CPU).
Run: ``python large_n_lbfgsb_example.py`` — shapes are scaled down by
default so the example also runs on CPU in seconds; pass ``--full`` on a
GPU for the real 10k-dim batch.
"""

import sys

from common import *  # noqa: F401,F403 — repo-root sys.path + jax config

import jax
import jax.numpy as jnp
import numpy as np

import optimization_solvers_tpu as ost
from optimization_solvers_tpu.utils.telemetry import summarize

FULL = "--full" in sys.argv
n, rows, B = (10_000, 512, 64) if FULL else (400, 64, 8)

key = jax.random.PRNGKey(0)
A = (jax.random.normal(key, (rows, n)) / np.sqrt(n)).astype(jnp.float32)
b = jnp.linspace(-1.0, 1.0, rows).astype(jnp.float32)


def lse(x, A_, b_):
    z = A_ @ x + b_
    mx = jnp.max(z)
    return mx + jnp.log(jnp.sum(jnp.exp(z - mx)))


x0 = jnp.asarray(
    np.random.RandomState(4).uniform(-0.5, 0.5, (B, n)), jnp.float32)

# problem data rides `data=` instead of the objective's closure
res = ost.minimize(lse, x0, method="lbfgsb", bounds=(-1.0, 1.0),
                   data=(A, b), m=10, pgtol=1e-5, factr=1e3, max_iter=200)

stats = summarize(res)
print(f"n={n}, batch={B}: {stats['converged']}/{stats['instances']} "
      f"converged, median f = {stats['f_p50']:.6f}, "
      f"median iterations = {stats['iters_p50']:.0f}")
assert stats["converged"] == B, stats
# every lane strictly feasible
assert bool(jnp.all(res.x >= -1.0)) and bool(jnp.all(res.x <= 1.0))
print("OK")
