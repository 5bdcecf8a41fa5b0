"""Reference accuracy anchors, run through the lockstep batched driver.

The reference crate's correctness anchors are f64 CPU runs asserting
``|f(x_final) - f*| < 1e-6`` (``examples/quadratic.rs:43``,
``src/steepest_descent/gradient_descent.rs:86-179``).  This tool runs the
same anchor problems through this framework's batched drivers on whatever
device JAX sees — in f32 by default (the GPU's working precision), or in
f64 on the CPU with ``--cpu`` — and checks each anchor's ``|f - f*|``
against its stated tolerance.

    python tools/accuracy_anchors.py          # f32 on the default device
    python tools/accuracy_anchors.py --cpu    # f64 on the CPU

Prints one JSON line per anchor and exits non-zero if any anchor misses
its tolerance.  ``chip_smoke.py`` phase 4 runs the f32 set on the card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# The reference's assert threshold (quadratic.rs:43), held in f32 too: the
# anchors minimize to f* = 0 or an exactly representable constant at
# well-scaled minimizers, so the f32 error of the VALUE near the minimum
# is absolute and far below 1e-6 once the iterate is within ~1e-4 of x*;
# f32's precision wall shows in the certifiable gradient, not in f.
REF_TOL = 1e-6


def build_anchors(jnp, solvers, ls):
    """The reference anchor set: every examples/*.rs objective plus the
    gradient_descent.rs gamma-90 test pair.  Each entry: (name, f, x0,
    bounds, f*, method, search, max_iter); every anchor is held to
    :data:`REF_TOL`."""
    e = jnp.exp

    def gamma90(x):
        return 0.5 * (x[0] ** 2 + 90.0 * x[1] ** 2)

    def expbowl(x):
        return x[0] ** 2 + x[1] ** 2 + e(x[0] ** 2 + x[1] ** 2)

    def rosen(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1.0 - x[:-1]) ** 2)

    A = [
        # gradient_descent.rs:86-179 test pair (tol 1e-12 in the reference;
        # grad_tol here is the f32-feasible equivalent)
        ("gd_bt_gamma90", gamma90, [180.0, 152.0], None, 0.0,
         solvers.GradientDescent(grad_tol=1e-6), ls.BackTracking(c1=1e-4),
         2000),
        ("gd_mt_gamma90", gamma90, [180.0, 152.0], None, 0.0,
         solvers.GradientDescent(grad_tol=1e-6), ls.MoreThuente(), 2000),
        # examples/*.rs anchors
        ("gradient_descent", lambda x: x[0] ** 2 + 2.0 * x[1] ** 2,
         [10.0, -10.0], None, 0.0,
         solvers.GradientDescent(grad_tol=1e-6),
         ls.BackTracking(c1=1e-4), 500),
        ("coordinate_descent",
         lambda x: x[0] ** 2 + 2.0 * x[1] ** 2 + 3.0 * x[2] ** 2,
         [10.0, -5.0, 4.0], None, 0.0,
         solvers.CoordinateDescent(grad_tol=1e-6), ls.BackTracking(), 4000),
        ("pnorm_descent", lambda x: x[0] ** 2 + 4.0 * x[1] ** 2,
         [15.0, -7.0], None, 0.0,
         solvers.PnormDescent(
             grad_tol=1e-6,
             inverse_p=jnp.linalg.inv(
                 jnp.array([[2.0, 0.0], [0.0, 8.0]]))),
         ls.BackTracking(), 500),
        ("newton_exp", expbowl, [1.0, 1.5], None, 1.0,
         solvers.Newton(tol=1e-6), ls.MoreThuente(), 200),
        ("bfgs",
         lambda x: (x[0] ** 2 + 2.0 * x[1] ** 2 + 3.0 * x[2] ** 2
                    + x[0] * x[1] + x[1] * x[2]),
         [10.0, -8.0, 6.0], None, 0.0,
         solvers.BFGS(tol=1e-6), ls.MoreThuente(), 300),
        ("dfp", lambda x: x[0] ** 2 + 5.0 * x[1] ** 2 + x[0] * x[1],
         [5.0, -5.0], None, 0.0,
         solvers.DFP(tol=1e-6), ls.MoreThuente(), 400),
        ("broyden", lambda x: x[0] ** 2 + 3.0 * x[1] ** 2 + 2.0 * x[0] * x[1],
         [4.0, 3.0], None, 0.0,
         solvers.Broyden(tol=1e-6), ls.MoreThuente(), 400),
        ("quadratic_M90", lambda x: x @ (jnp.array(
            [[1.0, 0.0], [0.0, 90.0]]) @ x),
         [180.0, 152.0], None, 0.0,
         solvers.BFGS(tol=1e-6), ls.MoreThuente(), 300),
        ("projected_gradient",
         lambda x: (x[0] - 2.0) ** 2 + (x[1] - 3.0) ** 2,
         [5.0, 5.0], ([0.0, 0.0], [1.0, 1.0]), 5.0,
         solvers.ProjectedGradientDescent(grad_tol=1e-6),
         ls.BackTrackingB(), 1000),
        ("spg_expbowl", expbowl, [0.9, -0.8],
         ([-1.0, -1.0], [1.0, 1.0]), 1.0,
         solvers.SpectralProjectedGradient(grad_tol=1e-6),
         ls.GLLQuadratic(c1=1e-4, m=10), 1500),
        ("spn_expbowl", expbowl, [0.9, -0.8],
         ([-1.0, -1.0], [1.0, 1.0]), 1.0,
         solvers.SpectralProjectedNewton(grad_tol=1e-6),
         ls.BackTrackingB(), 1500),
        # the opt-in Newton-metric BB pair (PARITY.md L3): same anchor,
        # shows the lambda-freeze fix also certifies the f32 stop
        ("spn_expbowl_pbb", expbowl, [0.9, -0.8],
         ([-1.0, -1.0], [1.0, 1.0]), 1.0,
         solvers.SpectralProjectedNewton(grad_tol=1e-6, precond_bb=True),
         ls.BackTrackingB(), 1500),
        ("bfgs_bounded",
         lambda x: x[0] ** 2 + 2.0 * x[1] ** 2 + x[0] * x[1],
         [1.5, 1.5], ([0.0, 0.0], [2.0, 2.0]), 0.0,
         solvers.BFGSB(tol=1e-6), ls.MoreThuenteB(), 800),
        ("sr1_bounded",
         lambda x: x[0] ** 2 + 3.0 * x[1] ** 2 + x[0] * x[1],
         [0.9, 0.9], ([-1.0, -1.0], [1.0, 1.0]), 0.0,
         solvers.SR1B(tol=1e-6), ls.MoreThuenteB(), 800),
        ("dfp_bounded",
         lambda x: x[0] ** 2 + 4.0 * x[1] ** 2 + x[0] * x[1],
         [1.2, 1.2], ([0.0, 0.0], [1.5, 1.5]), 0.0,
         solvers.DFPB(tol=1e-6), ls.MoreThuenteB(), 800),
        ("broyden_bounded",
         lambda x: x[0] ** 2 + 2.0 * x[1] ** 2 + x[0] * x[1],
         [0.8, 0.8], ([0.0, 0.0], [1.0, 1.0]), 0.0,
         solvers.BroydenB(tol=1e-6), ls.MoreThuenteB(), 800),
        ("lbfgs_rosen16", rosen, [-1.2] * 16, None, 0.0,
         solvers.LBFGS(tol=1e-6, m=5), ls.HagerZhang(), 2000),
    ]
    return A


def _record(name, method, search, res, f_star, compile_s, wall_s):
    import numpy as np

    from optimization_solvers_tpu.core.types import Status

    f0 = float(np.asarray(res.f).reshape(-1)[0])
    return dict(
        name=name, method=method, search=search,
        status=Status(int(np.asarray(res.status).reshape(-1)[0])).name,
        iterations=int(np.asarray(res.iterations).reshape(-1)[0]),
        f_err=abs(f0 - f_star), tol=REF_TOL,
        pg_norm=float(np.asarray(res.pg_norm).reshape(-1)[0]),
        compile_s=compile_s, wall_s=wall_s)


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(compiled(*args))
    return res, compile_s, time.perf_counter() - t0


def run_anchors(dtype, lanes: int = 8) -> list:
    """Run every anchor in ``dtype`` on ``lanes`` identical lanes of the
    lockstep batched driver, plus the L-BFGS-B anchor through
    ``lbfgsb_batch_minimize``.  Returns one record per anchor with the
    achieved ``f_err = |f - f*|``, its tolerance, status, iterations and
    compile and wall seconds."""
    import jax.numpy as jnp

    from optimization_solvers_tpu import linesearch as ls, solvers
    from optimization_solvers_tpu.core.oracle import make_oracle
    from optimization_solvers_tpu.solvers.driver import batch_minimize
    from optimization_solvers_tpu.solvers.lbfgsb import (
        LbfgsbConfig, lbfgsb_batch_minimize)

    records = []
    anchors = build_anchors(jnp, solvers, ls)
    for (name, f, x0l, bounds, f_star, method, search,
         max_iter) in anchors:
        x0 = jnp.asarray(x0l, dtype)
        xb = jnp.broadcast_to(x0, (lanes, x0.shape[0]))
        b = None
        if bounds is not None:
            b = (jnp.asarray(bounds[0], dtype), jnp.asarray(bounds[1], dtype))
        oracle = make_oracle(
            f, with_hessian=getattr(method, "needs_hessian", False))

        def solve(x, b=b, oracle=oracle, method=method, search=search,
                  max_iter=max_iter):
            return batch_minimize(method, search, oracle, x, bounds=b,
                                  max_iter=max_iter)

        res, compile_s, wall_s = _timed(solve, xb)
        records.append(_record(name, type(method).__name__,
                               type(search).__name__, res, f_star,
                               compile_s, wall_s))

    # L-BFGS-B anchor (the reference's Fortran-FFI solver)
    rosen = anchors[-1][1]
    n = 25
    x0 = jnp.full((lanes, n), -1.2, dtype)
    lo = jnp.full((n,), -2.0, dtype)
    hi = jnp.full((n,), 2.0, dtype)
    cfg = LbfgsbConfig(m=10, pgtol=1e-6, factr=10.0, max_iter=1000)
    res, compile_s, wall_s = _timed(
        lambda x: lbfgsb_batch_minimize(make_oracle(rosen), x, lo, hi, cfg),
        x0)
    records.append(_record("lbfgsb_rosen25", "Lbfgsb", "dcsrch", res, 0.0,
                           compile_s, wall_s))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run in f64 on the CPU instead of f32 on the "
                         "default device")
    args = ap.parse_args(argv)
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from optimization_solvers_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    recs = run_anchors(jnp.float64 if args.cpu else jnp.float32)
    for rec in recs:
        print(json.dumps(dict(rec, platform=dev.platform,
                              device_kind=dev.device_kind)))
    missed = [r["name"] for r in recs if r["f_err"] > r["tol"]]
    print(f"{len(recs) - len(missed)}/{len(recs)} anchors within tolerance"
          + (f"; missed {missed}" if missed else ""))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
