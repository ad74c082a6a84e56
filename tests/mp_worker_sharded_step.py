"""Worker process for the multi-process (fake multi-host) sharded-solver test.

Launched by tests/test_multiprocess.py with `jax.distributed` coordinates on
the CLI. Each process contributes 2 virtual CPU devices; together the
processes form one global mesh over which the factor tables are sharded
exactly as they would be across GPU hosts (SURVEY.md §4: "multi-host tests
using multi-process JAX on CPU as the fake backend"). The full LM step runs
with Gloo collectives standing in for NCCL all-reduces; each process
writes scalar checksums of the (replicated) result for the parent to compare
against the single-process answer.
"""

import json
import os
import sys


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    out_path = sys.argv[4]

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax.numpy as jnp
    import numpy as np

    from obvi_slam_tpu import parallel as par
    from obvi_slam_tpu.synthetic import synthetic_problem

    assert jax.process_count() == nproc
    state0, _, cams, tables, plan, free, weights, huber = synthetic_problem(
        n_poses=12, n_points=64, n_objects=4, obs_per_point=4, obs_per_object=6,
        dtype=np.float64,
    )

    mesh = par.make_mesh(jax.devices())
    tables = par.shard_tables(tables, mesh)
    plan = par.shard_plan(plan, mesh)
    weights = par.shard_weights(weights, mesh)
    state0 = par.replicate(state0, mesh)
    cams = par.replicate(cams, mesh)
    free = par.replicate(free, mesh)

    step = par.sharded_compute_step(mesh)
    radius = jnp.asarray(1e4, jnp.float64)
    delta, model_change, grad_max = step(
        state0, cams, tables, plan, free, weights, radius, huber
    )
    result = {
        "process_id": pid,
        "n_global_devices": len(jax.devices()),
        "delta_pose_sum": float(jnp.sum(delta.poses)),
        "delta_point_sum": float(jnp.sum(delta.points)),
        "delta_obj_sum": float(jnp.sum(delta.objects)),
        "model_change": float(model_change),
        "grad_max": float(grad_max),
    }
    with open(out_path, "w") as f:
        json.dump(result, f)
    print(f"worker {pid} ok", flush=True)


if __name__ == "__main__":
    main()
