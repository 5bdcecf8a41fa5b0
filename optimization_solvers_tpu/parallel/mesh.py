"""Device-mesh helpers for sharded batched solves.

The reference is single-threaded and single-instance
(``/root/reference/src/ls_solver.rs:78-108``); here batches of problem
instances shard over a device mesh.  Data-parallel solves are embarrassingly
parallel (per-instance convergence), so the batch axis shards with *zero*
collectives on the hot path; coordinate-sharded large-n solves (axis
``"tp"``) let XLA insert psum/all-gather for the dot products.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Sequence[int] = None, axis_names: Sequence[str] = ("dp", "tp")):
    """Build a mesh over all visible devices; defaults to all devices on the
    data-parallel axis."""
    devices = jax.devices()
    if shape is None:
        shape = (len(devices), 1)
    assert int(np.prod(shape)) == len(devices), (
        f"mesh shape {shape} != {len(devices)} devices"
    )
    return jax.make_mesh(tuple(shape), tuple(axis_names))


def batch_sharding(mesh: Mesh, batch_axis: str = "dp") -> NamedSharding:
    """Sharding for a (B, n) batch of instances: batch over ``batch_axis``,
    coordinates replicated."""
    return NamedSharding(mesh, P(batch_axis, None))
