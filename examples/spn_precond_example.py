"""Spectral projected Newton with the Newton-metric BB pair
(``SpectralProjectedNewton(precond_bb=True)``) — a capability extension
over the reference's SPN (``/root/reference/src/newton/spn.rs:139-148``),
whose gradient-metric BB scalar freezes at the inverse Rayleigh quotient
of the Newton ray on quadratics (see PARITY.md L3; the stall is
identical in f64).

The Newton-metric pair ``lambda = s.s / s.(H^{-1}y)`` is exactly 1 on a
quadratic, recovering the projected-Newton step: the same problem
converges in a handful of iterations.
"""
from common import *

import numpy as np

n = 16
d = jnp.asarray(np.linspace(1.0, 40.0, n))
f = lambda x: 0.5 * jnp.sum(d * x * x)
bounds = (jnp.full(n, -1.5), jnp.full(n, 2.5))
x0 = jnp.asarray(np.random.RandomState(0).uniform(-1.4, 2.4, n))

res_ref = solvers.minimize(
    solvers.SpectralProjectedNewton(grad_tol=1e-8), ls.BackTrackingB(),
    make_oracle(f, with_hessian=True), x0, bounds=bounds, max_iter=300)
res_pbb = solvers.minimize(
    solvers.SpectralProjectedNewton(grad_tol=1e-8, precond_bb=True),
    ls.BackTrackingB(),
    make_oracle(f, with_hessian=True), x0, bounds=bounds, max_iter=300)

report("spn_reference", res_ref, f)
report("spn_precond_bb", res_pbb, f)
check(res_pbb, jnp.zeros(n))
assert int(res_pbb.iterations) <= 10 < int(res_ref.iterations), (
    int(res_pbb.iterations), int(res_ref.iterations))
