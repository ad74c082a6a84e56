"""Multi-process (fake multi-host) distributed solver test.

The reference is single-process (SURVEY.md §2.11); this build's multi-host
story is jax.distributed + a global mesh (parallel/distributed.py). This test
actually runs it: two OS processes, each with 2 virtual CPU devices, form a
4-device global mesh; the factor-sharded LM step executes with Gloo
collectives standing in for NCCL, and the result must match the
single-process solver bit-for-bit-ish (f64, same program order per shard).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "mp_worker_sharded_step.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_step_matches_single_process(tmp_path):
    port = _free_port()
    nproc = 2
    procs = []
    outs = []
    for pid in range(nproc):
        out = tmp_path / f"result_{pid}.json"
        outs.append(out)
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # worker sets its own device count
        env.pop("JAX_PLATFORMS", None)
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER, str(pid), str(nproc), str(port), str(out)],
                env=env,
                cwd=REPO,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
        )
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=280)
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    results = [json.loads(o.read_text()) for o in outs]
    assert all(r["n_global_devices"] == 4 for r in results)
    # Both processes hold the same replicated answer.
    for key in ("delta_pose_sum", "delta_point_sum", "delta_obj_sum",
                "model_change", "grad_max"):
        assert results[0][key] == pytest.approx(results[1][key], rel=1e-12), key

    # Single-process reference on the same problem.
    import jax.numpy as jnp

    from obvi_slam_tpu.solver import schur as schur_mod
    from obvi_slam_tpu.synthetic import synthetic_problem

    state0, _, cams, tables, plan, free, weights, huber = synthetic_problem(
        n_poses=12, n_points=64, n_objects=4, obs_per_point=4, obs_per_object=6,
        dtype=np.float64,
    )
    delta, model_change, grad_max = schur_mod.compute_step(
        state0, cams, tables, plan, free, weights,
        jnp.asarray(1e4, jnp.float64), huber,
    )
    assert results[0]["delta_pose_sum"] == pytest.approx(
        float(jnp.sum(delta.poses)), rel=1e-8, abs=1e-12
    )
    assert results[0]["delta_point_sum"] == pytest.approx(
        float(jnp.sum(delta.points)), rel=1e-8, abs=1e-12
    )
    assert results[0]["delta_obj_sum"] == pytest.approx(
        float(jnp.sum(delta.objects)), rel=1e-8, abs=1e-12
    )
    assert results[0]["model_change"] == pytest.approx(
        float(model_change), rel=1e-8
    )
