"""chip_smoke.py on the CPU: each phase at a tiny size, the comparison
rules, and the refusal to run without a GPU (no ``ok`` line, non-zero
exit)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_main_four_cards_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--four-cards"])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_agreement_rule():
    f_ref = np.array([0.0, 3.9866, 1.0, 100.0])
    assert chip_smoke._agreement(f_ref + 5e-4, f_ref) == 1.0
    assert chip_smoke._agreement(f_ref + [2e-3, 0, 0, 0], f_ref) == 0.75
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke._check_agreement("cpu", "t", f_ref + [2e-3, 0, 0, 0],
                                    f_ref)
    # a lane in the other basin agrees only under the basin rule
    f_dev = np.array([3.9866, 3.9866, 1.0, 100.0])
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke._check_agreement("cpu", "t", f_dev, f_ref)
    assert chip_smoke._check_agreement("cpu", "t", f_dev, f_ref,
                                       basins=True) == 1.0


def test_numpy_references_match_jax():
    x = np.random.RandomState(0).uniform(-2, 2, 12)
    p = np.random.RandomState(1).randn(12)
    g = jax.grad(chip_smoke._rosen)(x)
    hp = jax.jvp(jax.grad(chip_smoke._rosen), (x,), (p,))[1]
    assert chip_smoke.rosen_np(x) == pytest.approx(
        float(chip_smoke._rosen(x)), rel=1e-12)
    np.testing.assert_allclose(chip_smoke.rosen_grad_np(x), g, rtol=1e-12)
    np.testing.assert_allclose(chip_smoke.rosen_hessp_np(x, p), hp,
                               rtol=1e-10, atol=1e-10)
    A, b = chip_smoke._lse_data(30, 7, seed=2)
    A, b = A.astype(np.float64), b.astype(np.float64)
    xx = np.resize(x, 30)
    f, g = chip_smoke.lse_fg_np(xx, A, b)
    assert f == pytest.approx(float(chip_smoke._lse(xx, A, b)), rel=1e-12)
    np.testing.assert_allclose(
        g, jax.grad(chip_smoke._lse)(xx, A, b), rtol=1e-10)


def test_phase_headline_tiny():
    r = chip_smoke.phase_headline("cpu", batch=16, n=10, sample=16)
    assert r["agreement"] >= chip_smoke.AGREE_FRACTION
    assert r["converged_fraction"] == 1.0
    assert r["activity"] is None          # no GPU plane in a CPU trace
    assert 0.0 <= r["kkt_fraction"] <= 1.0


def test_phase_bfgs_tiny():
    r = chip_smoke.phase_bfgs("cpu", batch=8, n=10, sample=8)
    assert r["agreement"] >= chip_smoke.AGREE_FRACTION
    assert r["success_fraction"] == 1.0


def test_phase_spg_tiny():
    r = chip_smoke.phase_spg("cpu", batch=16, n=16, sample=8)
    assert r["agreement"] == 1.0
    assert r["converged_fraction"] == 1.0


def test_phase_newton_cg_tiny():
    r = chip_smoke.phase_newton_cg("cpu", batch=8, n=10, sample=8)
    assert r["agreement"] >= chip_smoke.AGREE_FRACTION


def test_phase_large_n_tiny():
    r = chip_smoke.phase_large_n("cpu", batch=4, n=256, rows=32, sample=2)
    assert r["agreement"] == 1.0
    assert r["converged_fraction"] == 1.0


def test_phase_anchors():
    # in-process the suite runs with x64 on, where anchors that close over
    # f64 constants would promote an f32 solve; f32 is covered below
    r = chip_smoke.phase_anchors("cpu", dtype="float64")
    assert r["anchors"] == 20


def test_accuracy_anchors_cli_f32():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "tools/accuracy_anchors.py"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == \
        "20/20 anchors within tolerance"


@pytest.mark.gpu
def test_headline_phase_on_card(gpu_devices):
    """On a card: the headline phase at a reduced batch compiles, agrees
    with scipy, and its profiler trace finds the solve's kernels on the
    GPU plane."""
    r = chip_smoke.phase_headline(gpu_devices[0].device_kind, batch=1024)
    assert r["agreement"] >= chip_smoke.AGREE_FRACTION
    assert r["activity"] is not None and r["activity"]["kernels"] > 0
    assert 0.0 <= r["activity"]["idle_share"] < 1.0
