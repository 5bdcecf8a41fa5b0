"""Sharded batched solves over a device mesh (SURVEY.md §2.5: the
parallelism dimension the single-process reference lacks entirely).

Data-parallel solves are embarrassingly parallel: each instance owns its
convergence test, so the right decomposition is ``shard_map`` over the
batch axis with each device running its shard's solver loop *independently*
— a device whose lanes all converged goes idle instead of lock-stepping
with the slowest device (which is what a GSPMD-sharded global ``vmap``
while-loop would do: its condition becomes a cross-device reduction every
iteration, for no benefit).

Collectives appear only in the optional telemetry reduction
(:func:`sharded_summary`) and in coordinate-sharded ("tp") oracles, where
XLA inserts psum/all-gather for the contractions (see
``__graft_entry__.dryrun_multichip`` part 2).
"""

from __future__ import annotations

import functools
import time
from typing import Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from optimization_solvers_tpu.core.types import SolveResult, Status
from optimization_solvers_tpu.solvers.driver import batch_minimize


def _result_specs(axis: str):
    # x_lo (the optional f32x2 SolveResult field) is a batch-axis leaf
    # when the wrapped path produces it; a P spec on a None subtree is
    # accepted (prefix pytree), but None on an ARRAY leaf is not — so spec
    # it like its siblings
    return SolveResult(
        x=P(axis, None), f=P(axis), g=P(axis, None),
        iterations=P(axis), status=P(axis), pg_norm=P(axis),
        x_lo=P(axis, None),
    )


def sharded_batch_minimize(
    method,
    line_search,
    oracle,
    x0: jax.Array,
    *,
    mesh: Mesh,
    axis: str = "dp",
    bounds=None,
    **kwargs,
) -> SolveResult:
    """Solve a (B, n) batch sharded over ``axis`` of ``mesh``; each device
    runs the lockstep batched loop over its local shard to completion
    independently (within-shard lanes advance together; no cross-device
    lockstep).  ``bounds`` (if given) are replicated."""

    bounds_spec = (P(None), P(None)) if bounds is not None else None

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), bounds_spec),
        out_specs=_result_specs(axis),
        check_vma=False,
    )
    def solve_shard(x0_local, bounds_local):
        return batch_minimize(
            method, line_search, oracle, x0_local, bounds=bounds_local,
            **kwargs,
        )

    x0 = jax.device_put(x0, NamedSharding(mesh, P(axis, None)))
    return jax.jit(solve_shard)(x0, bounds)


def sharded_lbfgsb_minimize(
    oracle,
    x0: jax.Array,
    lower: jax.Array,
    upper: jax.Array,
    config,
    *,
    mesh: Mesh,
    axis: str = "dp",
) -> SolveResult:
    """Data-parallel L-BFGS-B over the mesh (the BASELINE.json headline
    workload at multi-chip scale).  Each device runs the lockstep batched
    loop over its local shard — within-shard lanes advance together,
    shards finish independently (no cross-device lockstep)."""
    from optimization_solvers_tpu.solvers.lbfgsb import lbfgsb_batch_minimize

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(None), P(None)),
        out_specs=_result_specs(axis),
        check_vma=False,
    )
    def solve_shard(x0_local, lo, up):
        return lbfgsb_batch_minimize(oracle, x0_local, lo, up, config)

    x0 = jax.device_put(x0, NamedSharding(mesh, P(axis, None)))
    return jax.jit(solve_shard)(x0, lower, upper)


@jax.jit
def _summary_reduce(status, iterations):
    return (
        jnp.sum(status == Status.CONVERGED),
        jnp.sum(iterations),
        jnp.max(iterations),
    )


def sharded_summary(result: SolveResult, mesh: Mesh, axis: str = "dp") -> dict:
    """Global convergence telemetry reduced ON DEVICE: the jitted reduction
    runs over the sharded result arrays, so XLA lowers the sums to
    all-reduce collectives on real multi-device hardware (SURVEY.md
    §5 device-side convergence telemetry); only the three scalars cross to
    the host."""
    converged, total_iters, max_iters = _summary_reduce(
        result.status, result.iterations
    )
    return {
        "instances": int(result.status.shape[0]),
        "converged": int(converged),
        "total_iterations": int(total_iters),
        "max_iterations": int(max_iters),
    }


def scaling_report(
    solve_fn,
    batch: int,
    device_counts: Sequence[int],
    *,
    axis_names=("dp",),
    warmup: bool = True,
) -> list[dict]:
    """Measure iterations/s scaling efficiency across mesh sizes
    (BASELINE.md: 'iterations/s scaling efficiency >= 80% at 2+ hosts').

    ``solve_fn(mesh) -> SolveResult`` builds + runs the sharded solve on the
    given mesh over the same total workload.  Returns one record per mesh
    size with throughput and efficiency relative to the single-device run.
    """
    records = []
    base = None
    for nd in device_counts:
        mesh = Mesh(jax.devices()[:nd], axis_names)
        if warmup:
            jax.block_until_ready(solve_fn(mesh))
        t0 = time.perf_counter()
        res = solve_fn(mesh)
        jax.block_until_ready(res)
        dt = time.perf_counter() - t0
        iters = int(jnp.sum(res.iterations))
        rec = {
            "devices": nd,
            "seconds": dt,
            "iters_per_sec": iters / dt,
            "solves_per_sec": batch / dt,
        }
        if base is None:
            base = rec
            rec["efficiency"] = 1.0
        else:
            # BASELINE.md metric: iterations/s scaling efficiency relative
            # to linear scaling of the single-device run.
            ideal = base["iters_per_sec"] * nd / base["devices"]
            rec["efficiency"] = rec["iters_per_sec"] / ideal
        records.append(rec)
    return records

def coordinate_sharded_minimize(
    method,
    line_search,
    oracle,
    x0: jax.Array,
    *,
    mesh: Mesh,
    axis: str = "tp",
    bounds=None,
    **kwargs,
) -> SolveResult:
    """Tensor-parallel solve of ONE big instance: the coordinate axis of
    ``x0`` (and of the bounds, gradient, and solver history pytree) is
    block-partitioned over ``axis`` of ``mesh`` (SURVEY.md §2.5
    "model/tensor parallel": the reference has no counterpart).

    The solve is the ordinary :func:`solvers.minimize` loop jitted under
    GSPMD: dot products inside the direction/line-search math contract over
    the sharded coordinate axis, so XLA inserts ``psum``/``all_gather``
    collectives (NCCL on GPUs) — no hand-written
    communication.  Results match the replicated solve to reduction-order
    tolerance (tested to convergence in ``tests/test_parallel.py``).

    ``x0`` may also carry a leading batch axis (replicated or dp-sharded by
    the caller); the coordinate axis is always the last one.
    """
    from optimization_solvers_tpu.solvers.driver import batch_minimize, minimize

    spec = P(*([None] * (x0.ndim - 1) + [axis]))
    x0 = jax.device_put(x0, NamedSharding(mesh, spec))
    if bounds is not None:
        bspec = NamedSharding(mesh, P(axis))
        bounds = tuple(
            jax.device_put(jnp.asarray(b), bspec) for b in bounds)
    solve = minimize if x0.ndim == 1 else batch_minimize
    fn = jax.jit(lambda x, b: solve(
        method, line_search, oracle, x, bounds=b, **kwargs))
    return fn(x0, bounds)


def coordinate_sharded_lbfgsb_minimize(
    oracle,
    x0: jax.Array,
    lower: jax.Array,
    upper: jax.Array,
    config,
    *,
    mesh: Mesh,
    axis: str = "tp",
) -> SolveResult:
    """Tensor-parallel L-BFGS-B on one big bounded instance (BASELINE
    config 4: the 10k-dim bounded log-sum-exp with the gradient
    block-partitioned across devices).  The (m, n) history pairs shard on
    their coordinate axis alongside x/g; the two-loop/compact-representation
    dot products become psum-reduced contractions."""
    from optimization_solvers_tpu.solvers.lbfgsb import lbfgsb_minimize

    vec = NamedSharding(mesh, P(axis))
    spec = P(*([None] * (x0.ndim - 1) + [axis]))
    x0 = jax.device_put(x0, NamedSharding(mesh, spec))
    lower = jax.device_put(jnp.asarray(lower), vec)
    upper = jax.device_put(jnp.asarray(upper), vec)

    def solve(x, lo, up):
        if x.ndim == 1:
            return lbfgsb_minimize(oracle, x, lo, up, config)
        return jax.vmap(lambda xi: lbfgsb_minimize(oracle, xi, lo, up, config))(x)

    return jax.jit(solve)(x0, lower, upper)
