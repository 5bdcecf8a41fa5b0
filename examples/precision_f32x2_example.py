"""f32x2: emulated f64 for f32 inputs (round 5).

The reference certifies grad_tol 1e-6 because it computes in f64
(``src/number.rs:3``).  A plain f32 solve hits a ~2e-4 certification
wall; ``precision="f32x2"`` runs the
fast f32 path first, then polishes every lane with a double-float BFGS
(solvers/df_polish.py) whose oracle is re-evaluated in (hi, lo) f32-pair
arithmetic — delivering the reference-grade 1e-6 certificate at the pair
``res.x + res.x_lo``.

This example forces the f32 pipeline ON CPU (where plain f32 shows the
same wall) and validates the certificate against true f64 autodiff."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)   # for the f64 VALIDATION only

import jax.numpy as jnp
import numpy as np

import optimization_solvers_tpu as ost
from optimization_solvers_tpu.core.types import Status


def rosen(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                   + (1.0 - x[:-1]) ** 2)


B, n = 16, 50
x0 = jnp.asarray(np.random.RandomState(0).uniform(-2, 2, (B, n)),
                 jnp.float32)                       # f32: the GPU working dtype

# plain f32: the strict tolerance is NOT certifiable (MAX_ITER / STALLED)
plain = ost.minimize(rosen, x0, method="bfgs", tol=1e-6, max_iter=2000)
plain_conv = float(np.mean(np.asarray(plain.status) == Status.CONVERGED))

# f32x2: same f32 arithmetic, reference-grade certificate
res = ost.minimize(rosen, x0, method="bfgs", precision="f32x2",
                   max_iter=2000)
conv = float(np.mean(np.asarray(res.status) == Status.CONVERGED))
print(f"[f32x2] plain-f32 conv@1e-6: {plain_conv:.2f}   "
      f"f32x2 conv@1e-6: {conv:.2f}")
print(f"[f32x2] pg_norm max: {float(np.max(np.asarray(res.pg_norm))):.2e}")

# validate every CERTIFIED lane against TRUE f64 autodiff at the df pair
ok = np.asarray(res.status) == Status.CONVERGED
x_pair = np.asarray(res.x, np.float64) + np.asarray(res.x_lo, np.float64)
g64 = jax.vmap(jax.grad(rosen))(jnp.asarray(x_pair))
true_pg = float(np.max(np.abs(np.asarray(g64)[ok])))
print(f"[f32x2] TRUE f64 pg over certified lanes: {true_pg:.2e}")

assert conv >= 0.9, conv
assert conv > plain_conv
assert true_pg <= 1.1e-6, true_pg
print("[f32x2] OK: reference-grade 1e-6 certificates from f32 arithmetic")
