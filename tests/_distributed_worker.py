"""Worker for the 2-process jax.distributed CPU test (SURVEY.md §4(c):
multi-host logic tested without a pod).  Each process owns 2 virtual CPU
devices; the 4-device global mesh runs the DP and TP solve paths on global
arrays, and every process checks its addressable shards against a local
replicated reference solve.

Invoked by tests/test_distributed.py as:
    python _distributed_worker.py <coordinator_port> <process_id>
"""

import os
import sys

port, pid = sys.argv[1], int(sys.argv[2])

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=8", "")
    + " --xla_force_host_platform_device_count=2"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from optimization_solvers_tpu import linesearch as ls, solvers  # noqa: E402
from optimization_solvers_tpu.core import problems  # noqa: E402
from optimization_solvers_tpu.core.oracle import make_oracle  # noqa: E402

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, len(jax.devices())

devices = np.asarray(jax.devices())

# ---- DP path: batch axis sharded across both processes --------------------
mesh = Mesh(devices, ("dp",))
B, n = 16, 2
oracle = make_oracle(problems.quadratic_2d(90.0))
method = solvers.GradientDescent(grad_tol=1e-8)
x0_np = np.random.RandomState(0).uniform(-5, 5, (B, n))

sharding = NamedSharding(mesh, P("dp", None))
x0 = jax.make_array_from_callback((B, n), sharding, lambda idx: x0_np[idx])


@jax.jit
def dp_solve(x):
    return solvers.batch_minimize(
        method, ls.BackTracking(), oracle, x, max_iter=2000)


r = dp_solve(x0)
ref = solvers.batch_minimize(
    method, ls.BackTracking(), oracle, jnp.asarray(x0_np), max_iter=2000)

for shard, ref_shard in zip(
        r.x.addressable_shards,
        [np.asarray(ref.x)[s.index] for s in r.x.addressable_shards]):
    np.testing.assert_allclose(np.asarray(shard.data), ref_shard, atol=1e-10)
st = np.concatenate(
    [np.atleast_1d(np.asarray(s.data)) for s in r.status.addressable_shards])
assert (st == 1).all(), st

# ---- TP path: one instance, coordinate axis sharded across processes ------
tp_mesh = Mesh(devices.reshape(1, 4), ("dp", "tp"))
n_big = 32
key = jax.random.PRNGKey(0)
A = jax.random.normal(key, (16, n_big), jnp.float64) / np.sqrt(n_big)
b = jnp.linspace(-1.0, 1.0, 16).astype(jnp.float64)
lse = problems.log_sum_exp(A, b)
f_big = lambda x: lse(x) + 0.005 * jnp.sum(x * x)
oracle_big = make_oracle(f_big)

xv_np = np.full((n_big,), 0.25)
vec_sharding = NamedSharding(tp_mesh, P("tp"))
xv = jax.make_array_from_callback(
    (n_big,), vec_sharding, lambda idx: xv_np[idx])


@jax.jit
def tp_solve(x):
    return solvers.minimize(
        method, ls.BackTracking(), oracle_big, x, max_iter=2000)


r2 = tp_solve(xv)
ref2 = jax.jit(lambda x: solvers.minimize(
    method, ls.BackTracking(), oracle_big, x, max_iter=2000))(
        jnp.asarray(xv_np))

for shard in r2.x.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(shard.data), np.asarray(ref2.x)[shard.index], atol=1e-8)

print(f"DIST_OK process={pid}", flush=True)
