"""Benchmark: global-BA LM iteration throughput on one GPU, with
speed-of-light accounting against the device's published peaks.

Primary metric — one full damped-Gauss-Newton iteration (all residuals +
Jacobians + Huber weighting + Schur landmark elimination + reduced-camera
solve + back-substitution + cost evaluation) on a representative global-BA
problem (256 poses, 4096 points, 32 objects, ~24k reprojection + ~380 bbox
factors), f32, run as the fused on-device trust-region loop (one dispatch per
solve).

Extra fields:
  sol         — per-phase FLOPs and speed-of-light times at the device's
                float32 peak (flops.PEAKS, keyed by device_kind) and the
                measured iteration's speed-of-light fraction.
  step_check  — one f32 compute_step against the same step in float64 on the
                device (relative error of the pose delta).
  scale_1024  — the reference-scale (UT-campus) 1,024-pose problem, where the
                block-tridiagonal + Woodbury reduced solve engages.

Every JSON line names the platform, device kind, device count and the card's
power limit. There is no CPU fallback: without a GPU the bench exits.

Usage: python bench.py
"""

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from obvi_slam_tpu import synthetic as syn  # noqa: E402
from obvi_slam_tpu.card import card_line, require_gpu  # noqa: E402


def build(dtype):
    return syn.synthetic_problem(
        n_poses=256, n_points=4096, n_objects=32, obs_per_point=6,
        obs_per_object=12, dtype=dtype,
    )


def time_iters(device, problem, n_iters, reps=3):
    """Fused on-device LM at a fixed iteration count: iterations/s."""
    import jax

    from obvi_slam_tpu.solver import lm_fused
    from obvi_slam_tpu.solver.lm import LMParams

    state0, _, cams, tables, plan, free, weights, huber = syn.put_problem(
        problem, device)
    compiled, args = lm_fused.compile_solve_fused(
        state0, cams, tables, plan, free, weights,
        LMParams.fixed_iterations(n_iters), huber,
    )
    jax.block_until_ready(compiled(*args))  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        final, _ = compiled(*args)
        jax.block_until_ready(final)
    dt = time.perf_counter() - t0
    return reps * int(final.it) / dt, float(final.cost)


def speed_of_light(problem, device_kind, measured_iter_s):
    from obvi_slam_tpu import flops

    _, _, _, tables, plan, _, _, _ = problem
    phases = flops.lm_iteration_flops(tables, plan, 256, 4096, 32)
    return flops.speed_of_light_table(phases, device_kind, measured_iter_s)


def step_check(device):
    import jax
    import numpy as np

    dp32, _ = syn.step_pose_delta(build(np.float32), device)
    with jax.enable_x64(True):
        dp64, _ = syn.step_pose_delta(build(np.float64), device)
        dp64 = np.asarray(dp64)
    return {"step_rel_err_vs_f64": syn.rel_err(dp32, dp64)}


def scale_1024(device):
    import numpy as np

    from obvi_slam_tpu.solver import schur

    p = syn.synthetic_problem(**syn.GLOBAL_BA_1024, dtype=np.float32)
    layout, band_solve = schur.band_engagement(p[4], 1024)
    ips, _ = time_iters(device, p, n_iters=10)
    return {"iters_per_s": ips, "per_iter_ms": 1e3 / ips,
            "band_layout": layout, "band_solve": band_solve}


def main():
    card = card_line()
    dev = require_gpu("bench")

    import jax
    import numpy as np

    from obvi_slam_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    ident = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }
    problem = build(np.float32)
    ips, _ = time_iters(dev, problem, n_iters=20)
    record = {
        "metric": "global_ba_lm_iters_per_s",
        "value": ips,
        "unit": "iter/s",
        "per_iter_ms": 1e3 / ips,
        **ident,
    }
    print(json.dumps(record), flush=True)
    record["sol"] = speed_of_light(problem, dev.device_kind, 1.0 / ips)
    record["step_check"] = step_check(dev)
    record["scale_1024"] = scale_1024(dev)
    record["checks_ok"] = (
        record["step_check"]["step_rel_err_vs_f64"] < syn.F32_STEP_REL_ERR
    )
    print(json.dumps(record), flush=True)
    return 0 if record["checks_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
