"""Process set-up helpers (utils/runtime.py) and the profiler-trace
reduction (utils.device_activity)."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest

from optimization_solvers_tpu.utils import device_activity, runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import jax, jax.numpy as jnp
    from optimization_solvers_tpu.utils.runtime import enable_compile_cache
    import os
    path = enable_compile_cache()
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.jit(lambda x: jnp.sin(x) * 2.0)(jnp.ones(8)).block_until_ready()
    print(path)
    print(jax.config.jax_compilation_cache_dir)
""")


def _probe(env):
    env = dict(env, JAX_PLATFORMS="cpu",
               # cache even this tiny program
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_compile_cache_honours_env_var(tmp_path):
    cache = tmp_path / "cache"
    path, config_dir = _probe(dict(os.environ,
                                   JAX_COMPILATION_CACHE_DIR=str(cache)))
    assert path == config_dir == str(cache)
    assert any(cache.iterdir()), "no cache entry landed in the env dir"


def test_compile_cache_defaults_to_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    path, config_dir = _probe(env)
    assert path == config_dir == os.path.join(REPO, ".jax_cache")


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()


def test_gpu_name_and_power_limit_reads_nvidia_smi(tmp_path, monkeypatch):
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    assert runtime.gpu_name_and_power_limit() == \
        "NVIDIA H100 80GB HBM3, 700.00 W"
    rec = runtime.device_record(jax.devices())
    assert rec["platform"] == "cpu" and rec["device_count"] == len(
        jax.devices())
    assert rec["nvidia_smi"].startswith("NVIDIA H100")


_XSPACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines { id: 1 name: "Stream #13(Compute)" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000 }
    events { metadata_id: 2 offset_ps: 1000000 duration_ps: 2000000 }
    events { metadata_id: 2 offset_ps: 6000000 duration_ps: 1000000 } }
  lines { id: 2 name: "Stream #14(MemcpyD2H)" timestamp_ns: 1000
    events { metadata_id: 3 offset_ps: 8000000 duration_ps: 2000000 } }
  lines { id: 3 name: "XLA Ops" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 20000000 } }
  event_metadata { key: 1 value { id: 1 name: "fusion.1" } }
  event_metadata { key: 2 value { id: 2 name: "loop_reduce" } }
  event_metadata { key: 3 value { id: 3 name: "memcpy" } }
}
planes { id: 2 name: "/host:CPU" }
"""


def test_device_activity_merges_stream_kernels():
    from jax.profiler import ProfileData

    act = device_activity(ProfileData.from_text_proto(_XSPACE))
    assert list(act) == ["/device:GPU:0"]
    a = act["/device:GPU:0"]
    # kernels [0,2) and [1,3) overlap -> 3 us; [6,7) -> 1; [8,10) -> 2;
    # the derived "XLA Ops" line is not counted
    assert a["kernels"] == 4
    assert a["busy_ns"] == pytest.approx(6000.0)
    assert a["window_ns"] == pytest.approx(10000.0)
    assert a["idle_share"] == pytest.approx(0.4)
    assert a["lines"] == ["Stream #13(Compute)", "Stream #14(MemcpyD2H)"]


def test_device_activity_cpu_trace_has_no_gpu_plane(tmp_path):
    f = jax.jit(lambda a: jnp.tanh(a @ a).sum())
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    f(x).block_until_ready()
    jax.profiler.stop_trace()
    assert device_activity(str(tmp_path)) == {}
    with pytest.raises(FileNotFoundError):
        device_activity(str(tmp_path / "empty"))
