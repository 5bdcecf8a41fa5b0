"""Profiling hooks (SURVEY.md §5: the reference has no timing/profiling
instrumentation at all; here it is ``jax.profiler`` traces).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/ost_profile"):
    """Capture a ``jax.profiler`` trace of the enclosed solves (view in
    TensorBoard / Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def op_profile(fn, *args, top: int = 20, trace_dir: str = "/tmp/ost_opprof"):
    """Run ``fn(*args)`` under a profiler trace and return the op-level
    self-time table as a list of dicts, most expensive first.

    Subtractive ablations are confounded by data-dependent trip counts, so
    an op table is the reliable attribution (it parses the raw xplane
    protobufs from ``jax.profiler.trace``; no TensorBoard needed).
    Requires the optional ``xprof`` package and raises ImportError without
    it; nothing on the solver path imports this function.

    Example::

        rows = op_profile(jax.jit(solve), x0)
        for r in rows[:10]:
            print(r["self_us"], r["occurrences"], r["name"])
    """
    import glob
    import json as _json
    import os
    import shutil

    try:
        from xprof.convert import raw_to_tool_data
    except ImportError as exc:
        raise ImportError(
            "op_profile needs the `xprof` package (pip install xprof)"
        ) from exc

    shutil.rmtree(trace_dir, ignore_errors=True)
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn(*args))
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    data, _ = raw_to_tool_data.xspace_to_tool_data(
        paths, "framework_op_stats", {"tqx": "out:json;"})
    table = _json.loads(data if isinstance(data, str) else data.decode())[0]
    cols = [c["label"] for c in table["cols"]]
    idx = {label: i for i, label in enumerate(cols)}

    def cell(row, label):
        return row["c"][idx[label]].get("v")

    rows = []
    for r in table["rows"]:
        rows.append({
            "host_or_device": cell(r, "Host/device"),
            "type": cell(r, "Operation Type"),
            "name": cell(r, "Operation Name"),
            "occurrences": int(cell(r, "#Occurrences") or 0),
            "total_us": float(cell(r, "Total time (us)") or 0.0),
            "self_us": float(cell(r, "Total self-time (us)") or 0.0),
            "bound_by": cell(r, "Bound by"),
        })
    rows.sort(key=lambda d: -d["self_us"])
    return rows[:top]


# lines of a GPU plane that XLA derives from the stream lines (module, op
# and scope views of the same kernels); counting them would double the
# busy time
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "XLA TraceMe", "Steps",
                  "Framework Name Scope", "Framework Ops", "Source code",
                  "Launch Stats")


def device_activity(trace) -> dict:
    """Device busy and idle time from a ``jax.profiler`` trace, read with
    ``jax.profiler.ProfileData`` alone.

    ``trace`` is a trace directory (the newest ``*.xplane.pb`` under it is
    read) or a ``ProfileData``.  For each GPU plane (``/device:GPU:<i>``)
    the kernels are the events on its stream lines; busy is the union of
    their intervals and the window runs from the first kernel's start to
    the last one's end, so ``idle_share = 1 - busy / window`` is the share
    of the device's active span in which no kernel ran.  Returns
    ``{plane name: {"kernels", "busy_ns", "window_ns", "idle_share",
    "lines"}}``; empty when the trace holds no GPU plane."""
    import glob
    import os

    from jax.profiler import ProfileData

    if isinstance(trace, str):
        paths = glob.glob(os.path.join(trace, "**", "*.xplane.pb"),
                          recursive=True)
        if not paths:
            raise FileNotFoundError(f"no *.xplane.pb under {trace}")
        trace = ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = {}
    for plane in trace.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        if not lines:
            lines = [ln for ln in plane.lines
                     if ln.name not in _DERIVED_LINES]
        spans = sorted((e.start_ns, e.end_ns)
                       for ln in lines for e in ln.events)
        busy = 0.0
        cur_start = cur_end = None
        for start, end in spans:
            if cur_end is None or start > cur_end:
                if cur_end is not None:
                    busy += cur_end - cur_start
                cur_start, cur_end = start, end
            else:
                cur_end = max(cur_end, end)
        if cur_end is not None:
            busy += cur_end - cur_start
        window = (max(e for _, e in spans) - spans[0][0]) if spans else 0.0
        out[plane.name] = {
            "kernels": len(spans),
            "busy_ns": busy,
            "window_ns": window,
            "idle_share": 1.0 - busy / window if window else None,
            "lines": sorted({ln.name for ln in lines}),
        }
    return out


@contextlib.contextmanager
def wall_timer(result: dict, key: str = "seconds", fence=None):
    """Wall-clock a block; pass ``fence`` (an array or pytree) to wait for
    the device to finish computing it (``jax.block_until_ready``) before
    stopping the clock — JAX dispatch is asynchronous."""
    t0 = time.perf_counter()
    yield
    if fence is not None:
        jax.block_until_ready(fence)
    result[key] = time.perf_counter() - t0
