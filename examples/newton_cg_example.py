"""Truncated Newton-CG (matrix-free second-order; a batched extension of
the reference's Newton family, newton/projected_newton.rs:64-80) on bounded
Rosenbrock-32 through the one-call front end: Hessian-vector products
instead of (n, n) factorizations, so the second-order step scales to large
n."""
from common import *

import optimization_solvers_tpu as ost
from optimization_solvers_tpu.core import problems

n = 32
f = problems.rosenbrock()
x0 = jnp.tile(jnp.asarray([-1.2, 1.0]), n // 2)[None, :]
res = ost.minimize(f, x0, method="newton_cg", bounds=(-2.0, 2.0), tol=1e-8,
                   factr=0.0, max_iter=300, cg_max=48)

one = jax.tree.map(lambda a: a[0], res)
report("newton_cg", one, f)
check(one, jnp.ones(n), x_tol=1e-5, f_tol=1e-10)
# terminal quadratic convergence: f lands at exactly 0 in f64, not 1e-10ish
assert float(one.f) < 1e-16
