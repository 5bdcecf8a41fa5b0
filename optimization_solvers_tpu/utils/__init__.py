"""Observability and front-end helpers (reference L5/L6)."""

from optimization_solvers_tpu.utils.telemetry import (
    LogFormat,
    Tracer,
    get_logger,
    log_progress,
    summarize,
)
from optimization_solvers_tpu.utils.plotting import Plotter3d
from optimization_solvers_tpu.utils.checkpoint import (
    load_state,
    load_state_orbax,
    save_state,
    save_state_orbax,
)
from optimization_solvers_tpu.utils.profiling import (
    device_activity,
    op_profile,
    trace,
    wall_timer,
)

__all__ = [
    "LogFormat",
    "Tracer",
    "get_logger",
    "log_progress",
    "summarize",
    "Plotter3d",
    "save_state",
    "load_state",
    "save_state_orbax",
    "load_state_orbax",
    "trace",
    "wall_timer",
    "op_profile",
    "device_activity",
]
