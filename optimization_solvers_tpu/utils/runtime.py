"""Process set-up shared by the repo's scripts (``chip_smoke.py``,
``bench.py``, ``__graft_entry__.py``, ``tools/``): the persistent compile
cache and the accelerator check."""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``$JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing is set in code.  Otherwise the cache lives in ``.jax_cache`` at
    the root of the checkout (listed in ``.gitignore``), a fixed path so a
    later run of the same checkout hits it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> list:
    """Return ``jax.devices()`` if they are GPUs; otherwise raise
    ``SystemExit`` naming what was found.  Measurement scripts call this
    first: a run that finds no card fails instead of timing the CPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found platform {devices[0].platform!r} "
            f"({devices[0].device_kind}); this script measures the card "
            "and has no CPU fallback")
    return devices


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the visible cards,
    one ``name, limit`` line per card, e.g. ``NVIDIA H100 80GB HBM3,
    700.00 W``.  A card may be capped below its maximum power and then runs
    slower under load, so every recorded time carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def device_record(devices) -> dict:
    """The device fields every measurement record carries."""
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "nvidia_smi": gpu_name_and_power_limit(),
    }
