"""Browser demo: the batched-JAX counterpart of the reference's JS⇄WASM demo
(``/root/reference/wasm/demo/index.html``, bindings
``/root/reference/src/wasm.rs:6-269``).

The reference compiles its Rust crate to WASM and evaluates user-written JS
objectives (which must hand-code gradients and Hessians) in the browser.
Here a stdlib HTTP server exposes the same three solvers — Gradient Descent,
BFGS, Newton — through :class:`optimization_solvers_tpu.api.OptimizationSolver`
(the ``wasm.rs``-shaped facade) and objectives are ``jax.numpy`` expressions
differentiated by autodiff, so the user writes only ``f(x)``.

Endpoints:
  GET  /            the demo page (demo/index.html)
  POST /api/solve   {"solver", "x0", "tolerance", "max_iterations",
                     "expression"} -> result + per-iteration trace (+ a
                     value-field grid for the 2-D contour view)

Trust model: the expression is evaluated with a math-only namespace on the
user's OWN machine — the same model as the reference demo, which ``eval``s
user JS in the user's own browser.  Do not expose this server publicly.

Run:  python demo/server.py [port]   (default 8642), then open
      http://localhost:<port>/
"""

from __future__ import annotations

import json
import math
import os
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_DEMO_DIR = os.path.dirname(os.path.abspath(__file__))


def _jax():
    """Import-on-first-use so the module can be imported (e.g. by tests)
    without initializing a backend; the demo's home is CPU x64."""
    import jax

    if not jax.config.jax_enable_x64:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    return jax


def make_objective(expression: str):
    """Compile a ``jax.numpy`` expression of ``x`` into a scalar objective.

    The namespace is math-only (no builtins): ``x``, ``jnp``, and the usual
    scalar helpers.  Counterpart of the reference demo's user-JS
    ``objective(x)`` protocol (``index.html`` function templates) minus the
    hand-written derivatives — autodiff supplies those.
    """
    _jax()
    import jax.numpy as jnp

    code = compile(expression, "<objective>", "eval")
    ns = {
        "jnp": jnp, "np": jnp, "sum": jnp.sum, "dot": jnp.dot,
        "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan, "exp": jnp.exp,
        "log": jnp.log, "sqrt": jnp.sqrt, "abs": jnp.abs, "cosh": jnp.cosh,
        "sinh": jnp.sinh, "tanh": jnp.tanh, "pi": math.pi, "e": math.e,
        "__builtins__": {},
    }

    def f(x):
        return jnp.asarray(eval(code, ns, {"x": x}))  # noqa: S307 (see module docstring)

    return f


def solve_request(payload: dict) -> dict:
    """Run one demo solve; returns a JSON-ready dict.

    Mirrors the WASM call surface: ``solver`` picks the same
    (method, line-search) pairings as ``wasm.rs:73-268`` via the
    :class:`OptimizationSolver` facade; a second pass with a callback
    records the per-iteration trace the reference page prints to its log.
    """
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np

    from optimization_solvers_tpu import linesearch as ls, solvers
    from optimization_solvers_tpu.api import OptimizationSolver
    from optimization_solvers_tpu.core.oracle import make_oracle

    solver = payload.get("solver", "gradient_descent")
    x0 = [float(v) for v in payload.get("x0", [2.0, 1.0])]
    tol = float(payload.get("tolerance", 1e-6))
    max_iter = int(payload.get("max_iterations", 100))
    expression = payload.get("expression", "x[0]**2 + 2*x[1]**2")

    f = make_objective(expression)
    float(f(jnp.asarray(x0, jnp.float64)))  # validate before solving

    front = OptimizationSolver(tolerance=tol, max_iterations=max_iter)
    run = {
        "gradient_descent": front.solve_gradient_descent,
        "bfgs": front.solve_bfgs,
        "newton": front.solve_newton,
    }[solver]
    result = run(x0, f)

    # trajectory pass: same configs as the facade (wasm.rs pairings)
    method, search, hess = {
        "gradient_descent": (solvers.GradientDescent(grad_tol=tol),
                             ls.BackTracking(c1=1e-4, beta=0.5), False),
        "bfgs": (solvers.BFGS(tol=tol), ls.MoreThuente(), False),
        "newton": (solvers.Newton(tol=tol),
                   ls.BackTracking(c1=1e-4, beta=0.5), True),
    }[solver]
    trace: list = []

    def cb(k, x, fv):
        # the driver's callback k is already the 1-based completed count
        trace.append({"k": int(k),
                      "x": [float(v) for v in np.asarray(x)],
                      "f": float(fv)})

    oracle = make_oracle(f, with_hessian=hess)
    x0_arr = jnp.asarray(x0, jnp.float64)
    solvers.minimize(method, search, oracle, x0_arr,
                     max_iter=max_iter, callback=cb)
    trace.sort(key=lambda r: r["k"])
    trace = trace[: int(result.iterations)]

    out = {
        "x": result.x,
        "f_value": result.f_value,
        "gradient_norm": result.gradient_norm,
        "iterations": result.iterations,
        "success": result.success,
        "error_message": result.error_message,
        "trace": [{"k": 0, "x": x0, "f": float(f(x0_arr))}] + trace,
    }

    if len(x0) == 2:  # value field for the contour view
        pts = np.asarray([t["x"] for t in out["trace"]], float)
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        pad = np.maximum(0.35 * (hi - lo), 0.75)
        lo, hi = lo - pad, hi + pad
        m = 72
        gx = np.linspace(lo[0], hi[0], m)
        gy = np.linspace(lo[1], hi[1], m)
        xx, yy = np.meshgrid(gx, gy)
        grid_pts = jnp.asarray(np.stack([xx.ravel(), yy.ravel()], 1))
        vals = np.asarray(jax.vmap(f)(grid_pts)).reshape(m, m)
        out["field"] = {
            "x": [float(lo[0]), float(hi[0])],
            "y": [float(lo[1]), float(hi[1])],
            "values": [[float(v) for v in row] for row in vals],
        }
    return out


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path in ("/", "/index.html"):
            with open(os.path.join(_DEMO_DIR, "index.html"), "rb") as fh:
                self._send(200, fh.read(), "text/html; charset=utf-8")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):  # noqa: N802
        if self.path != "/api/solve":
            self._send(404, b"not found", "text/plain")
            return
        length = int(self.headers.get("Content-Length", 0))
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
            out = solve_request(payload)
            self._send(200, json.dumps(out).encode(), "application/json")
        except Exception as exc:  # surface as the demo's error banner
            self._send(400, json.dumps({"error": str(exc)}).encode(),
                       "application/json")

    def log_message(self, fmt, *args):  # quiet
        pass


def serve(port: int = 8642) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    return httpd


if __name__ == "__main__":
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8642
    httpd = serve(port)
    print(f"demo at http://localhost:{port}/  (ctrl-c to stop)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
