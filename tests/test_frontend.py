"""One-call front end (optimization_solvers_tpu.minimize) — scipy-style
method-by-name entry over the same driver/kernels."""

import jax.numpy as jnp
import numpy as np
import pytest

import optimization_solvers_tpu as ost


def _rosen(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def test_single_instance_default_and_named_methods():
    res = ost.minimize(lambda x: jnp.sum((x - 2.0) ** 2), jnp.zeros(4),
                       method="bfgs")
    assert int(res.status) == 1 and abs(float(res.f)) < 1e-10
    res = ost.minimize(_rosen, jnp.full(8, -1.2), method="newton_cg")
    assert int(res.status) == 1
    res = ost.minimize(_rosen, jnp.full(8, -1.2), method="lbfgs", tol=1e-8)
    assert int(res.status) == 1 and float(res.f) < 1e-12


def test_batched_lbfgsb_with_options():
    x0 = jnp.asarray(np.random.RandomState(0).uniform(-2, 2, (8, 10)))
    res = ost.minimize(_rosen, x0, method="lbfgsb", bounds=(-5.0, 5.0),
                       tol=1e-6, m=7)
    assert (np.asarray(res.status) == 1).all()
    # lanes reach either the global minimum or Rosenbrock's local one
    f = np.asarray(res.f)
    assert ((f < 1e-8) | (np.abs(f - 3.9866) < 1e-2)).all(), f


def test_option_passthrough_and_bounds():
    d = jnp.linspace(1.0, 20.0, 6)

    def quad(x):
        return 0.5 * jnp.sum(d * x * x)

    res = ost.minimize(quad, jnp.full(6, 1.2), method="spn",
                       bounds=(-2.0, 2.0), precond_bb=True)
    assert int(res.status) == 1 and int(res.iterations) <= 10
    res = ost.minimize(lambda x, dd: 0.5 * jnp.sum(dd * x * x),
                       jnp.ones((4, 6)), method="spg", bounds=(-1.0, 2.0),
                       data=(d,))
    assert (np.asarray(res.status) == 1).all()


def test_frontend_errors():
    q = lambda x: jnp.sum(x * x)
    with pytest.raises(ValueError, match="unknown method"):
        ost.minimize(q, jnp.ones(3), method="nope")
    with pytest.raises(ValueError, match="unconstrained"):
        ost.minimize(q, jnp.ones(3), method="bfgs", bounds=(-1, 1))
    with pytest.raises(ValueError, match="requires bounds"):
        ost.minimize(q, jnp.ones(3), method="pgd")


def test_frontend_pnorm():
    inv_p = jnp.linalg.inv(jnp.array([[2.0, 0.0], [0.0, 8.0]]))
    res = ost.minimize(lambda x: x[0] ** 2 + 4.0 * x[1] ** 2,
                       jnp.array([15.0, -7.0]), method="pnorm",
                       inverse_p=inv_p)
    assert int(res.status) == 1 and float(res.f) < 1e-10


def test_frontend_rejects_unknown_options():
    q = lambda x: jnp.sum(x * x)
    with pytest.raises(TypeError, match="unknown option"):
        ost.minimize(q, jnp.ones(3), method="bfgs", emm=3)
    with pytest.raises(TypeError, match="unknown lbfgsb option"):
        ost.minimize(q, jnp.ones(3), method="lbfgsb", emm=3)


def test_frontend_pnorm_requires_inverse_p():
    with pytest.raises(ValueError, match="inverse_p"):
        ost.minimize(lambda x: jnp.sum(x * x), jnp.ones(3), method="pnorm")


def test_frontend_honors_max_iter_ls():
    # explicit budget is honored verbatim (round-3 review finding): with a
    # single backtracking trial the stiff direction cannot be damped enough
    # and GD stalls at MAX_ITER; the default budget converges
    d = jnp.asarray([1.0, 40.0])

    def quad(x):
        return 0.5 * jnp.sum(d * x * x)

    r1 = ost.minimize(quad, jnp.array([1.0, 1.0]), method="gd",
                      max_iter=500, max_iter_ls=1)
    r2 = ost.minimize(quad, jnp.array([1.0, 1.0]), method="gd", max_iter=500)
    assert int(r1.status) != 1
    assert int(r2.status) == 1


def test_frontend_tracing_toggle_not_stale(monkeypatch, caplog):
    """Round-3 review finding: the lockstep jit cache must miss when
    OST_LOG toggles (the tracing callbacks are baked at trace time)."""
    import logging

    from optimization_solvers_tpu import linesearch as ls, solvers
    from optimization_solvers_tpu.core.oracle import make_oracle
    import jax

    oracle = make_oracle(lambda x: jnp.sum(x * x))
    x0 = jnp.ones((4, 3))
    kw = dict(max_iter=20)
    monkeypatch.delenv("OST_LOG", raising=False)
    logging.getLogger("optimization_solvers_tpu").setLevel(logging.INFO)
    solvers.batch_minimize(solvers.GradientDescent(grad_tol=1e-6),
                           ls.BackTracking(), oracle, x0, **kw)
    monkeypatch.setenv("OST_LOG", "debug")
    with caplog.at_level(logging.DEBUG, logger="optimization_solvers_tpu"):
        solvers.batch_minimize(solvers.GradientDescent(grad_tol=1e-6),
                               ls.BackTracking(), oracle, x0, **kw)
        jax.effects_barrier()
    assert [r for r in caplog.records if "solver.GradientDescent" in r.name
            or "linesearch" in r.name], "tracing stayed stale after toggle"


def test_frontend_dtype_aware_default_tol():
    """VERDICT round-3 item 4: the default stationarity tolerance is
    dtype-aware (1e-6 for f64, 1e-4 for f32 — the factr treatment at
    frontend.py).  The exp-bowl anchor (tools/accuracy_anchors.py) is the
    motivating geometry: its minimum VALUE is 1, so f32 value-based
    acceptance freezes pg at ~1e-5 and a 1e-6 certificate burns the whole
    budget; the f32 default converges, an explicit tol always wins."""

    def expbowl(x):
        return x[0] ** 2 + x[1] ** 2 + jnp.exp(x[0] ** 2 + x[1] ** 2)

    x0_32 = jnp.asarray([0.9, -0.8], jnp.float32)
    # f32 + default tol: certifiable -> CONVERGED inside the budget
    res = ost.minimize(expbowl, x0_32, method="spn", bounds=(-1.0, 1.0),
                       max_iter=1500)
    assert int(res.status) == 1, int(res.status)
    assert abs(float(res.f) - 1.0) < 1e-6
    # the f64-strength tolerance, explicitly requested, is honored (and is
    # exactly the MAX_ITER freeze the dtype-aware default exists to avoid)
    res_tight = ost.minimize(expbowl, x0_32, method="spn",
                             bounds=(-1.0, 1.0), max_iter=1500, tol=1e-6)
    assert int(res_tight.status) == 2, int(res_tight.status)
    # f64 keeps the reference default: certified to 1e-6 at exit
    res64 = ost.minimize(expbowl, jnp.asarray([0.9, -0.8], jnp.float64),
                         method="spn", bounds=(-1.0, 1.0), max_iter=1500)
    assert int(res64.status) == 1
    assert float(res64.pg_norm) <= 1e-6


def test_frontend_per_lane_bounds_batched_lbfgsb():
    """(B, n) bounds through the one-call front end: each lane gets its own
    box (batch-axis capability beyond the single-instance reference),
    through the single-instance solve vmapped over the batch."""
    d = jnp.linspace(1.0, 6.0, 5)

    def quad(x, dd):
        return 0.5 * jnp.sum(dd * (x - 1.5) ** 2)

    B, n = 3, 5
    rng = np.random.RandomState(2)
    lo = jnp.asarray(rng.uniform(-2.0, -1.0, (B, n)))
    hi = jnp.asarray(rng.uniform(0.2, 3.0, (B, n)))
    x0 = jnp.asarray(rng.uniform(-0.5, 0.1, (B, n)))
    res = ost.minimize(quad, x0, method="lbfgsb", bounds=(lo, hi),
                       data=(d,), pgtol=1e-9, factr=10.0)
    assert (np.asarray(res.status) == 1).all()
    np.testing.assert_allclose(
        np.asarray(res.x), np.clip(1.5, np.asarray(lo), np.asarray(hi)),
        atol=1e-7)


def test_frontend_mixed_dtype_data_cast_to_x0_dtype():
    """f32 x0 with f64 problem data must solve in f32 (round-5 fix): the
    promotion would otherwise surface as a while-loop carry dtype error
    inside dcsrch (f64 f/g vs f32 stp) rather than anything actionable."""
    def fq(x, d, c):
        return jnp.sum(d * (x - c) ** 2)

    d = jnp.linspace(1.0, 3.0, 8)            # f64 under the x64 conftest
    c = jnp.linspace(-1.0, 1.0, 8)
    x0 = jnp.zeros((4, 8), jnp.float32)
    res = ost.minimize(fq, x0, method="lbfgsb", data=(d, c),
                       bounds=(-5.0, 5.0), tol=1e-5)
    assert res.x.dtype == jnp.float32
    assert np.isin(np.asarray(res.status), (1, 6)).all()
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(c)[None, :]
                               * np.ones((4, 1)), atol=1e-3)
    # integer data passes through untouched (indices must stay indices)
    def fsel(x, idx):
        return jnp.sum(x[idx] ** 2) + jnp.sum((x - 1.0) ** 2) * 0.0
    r2 = ost.minimize(lambda x, i: jnp.sum(x ** 2) + 0.0 * jnp.sum(i),
                      x0[0], method="gd", data=(jnp.arange(3),), tol=1e-4)
    assert int(r2.status) == 1


def test_frontend_policy_routing(monkeypatch):
    """policy="fast" (the frontend default) must select the measured-better
    update variants; "reference" must keep reference-exact defaults; an
    explicit option or search object always wins (round-5 VERDICT item 2)."""
    from optimization_solvers_tpu import solvers, linesearch as ls

    seen = {}

    def spy(m, s, oracle, x0, **kw):
        seen["m"], seen["s"] = m, s
        return solvers.minimize.__wrapped__(m, s, oracle, x0, **kw) \
            if hasattr(solvers.minimize, "__wrapped__") else _orig(
                m, s, oracle, x0, **kw)

    _orig = solvers.minimize
    monkeypatch.setattr(solvers, "minimize", spy)

    def quad(x):
        return jnp.sum((x - 1.0) ** 2)

    x32 = jnp.asarray([0.0, 0.0], jnp.float32)
    x64 = jnp.asarray([0.0, 0.0], jnp.float64)

    ost.minimize(quad, x32, method="spg", bounds=(-2.0, 2.0), max_iter=50)
    assert seen["m"].bb_variant == "alternate"
    ost.minimize(quad, x32, method="spg", bounds=(-2.0, 2.0), max_iter=50,
                 policy="reference")
    assert seen["m"].bb_variant == "bb1"
    ost.minimize(quad, x32, method="spg", bounds=(-2.0, 2.0), max_iter=50,
                 bb_variant="bb1")                    # explicit option wins
    assert seen["m"].bb_variant == "bb1"

    ost.minimize(quad, x32, method="spn", bounds=(-2.0, 2.0), max_iter=50)
    assert seen["m"].precond_bb is True
    ost.minimize(quad, x32, method="spn", bounds=(-2.0, 2.0), max_iter=50,
                 policy="reference")
    assert seen["m"].precond_bb is False

    # f32 More-Thuente default gains approx-Wolfe; f64 keeps reference MT;
    # an explicit search object is never modified
    ost.minimize(quad, x32, method="bfgs", max_iter=50)
    assert seen["s"].approx_wolfe is True
    ost.minimize(quad, x64, method="bfgs", max_iter=50)
    assert seen["s"].approx_wolfe is False
    mt = ls.MoreThuente()
    ost.minimize(quad, x32, method="bfgs", max_iter=50, search=mt)
    assert seen["s"] is mt

    with pytest.raises(ValueError, match="policy"):
        ost.minimize(quad, x32, method="gd", policy="turbo")


def test_frontend_lbfgsb_policy_independent():
    """Batched lbfgsb has one backend (the lockstep dcsrch path), so the
    policy knob leaves it alone: both policies give the same lanes, and the
    removed kernel-only options are rejected as unknown."""
    def quad(x):
        return jnp.sum((x - 0.2) ** 2)

    x0 = jnp.asarray(np.random.RandomState(4).uniform(-1, 1, (4, 8)),
                     jnp.float32)
    r_fast = ost.minimize(quad, x0, method="lbfgsb", policy="fast", tol=1e-5)
    r_ref = ost.minimize(quad, x0, method="lbfgsb", policy="reference",
                         tol=1e-5)
    np.testing.assert_array_equal(np.asarray(r_fast.x), np.asarray(r_ref.x))
    np.testing.assert_array_equal(np.asarray(r_fast.iterations),
                                  np.asarray(r_ref.iterations))
    for opt in ("tall_line_search", "tile"):
        with pytest.raises(TypeError, match=opt):
            ost.minimize(quad, x0, method="lbfgsb", **{opt: 1})
