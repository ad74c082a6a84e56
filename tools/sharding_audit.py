"""Sharded-HLO collective audit + scaling model for multi-chip global BA.

Compiles the factor-sharded banded global-BA step on an N-device CPU mesh
(xla_force_host_platform_device_count), extracts every collective op and its
shape from the optimized HLO, and derives the per-iteration communication
volume vs per-device compute — the evidence behind a multi-device
scaling-efficiency claim (SURVEY §2.11).

Model: factor-axis data parallelism reduces per-device FLOPs ~1/N while the
replicated H_ll/H_oo/b and reduced-system contributions are combined with
all-reduce; ring all-reduce moves 2(N-1)/N x payload per device. Projected
efficiency at device count N:

    eff(N) = t_comp(1) / N / (t_comp(1)/N + t_comm(N))
    t_comm(N) = 2(N-1)/N * ar_bytes / link_bw

with link_bw the per-device interconnect bandwidth (H100 NVLink, 4.5e11 B/s
per direction from NVIDIA's data sheet; assumptions are printed, not
hidden). Without --measured_iter_ms the compute time is the FLOP model at
the H100's float32 peak (flops.PEAKS).

Usage:
    python tools/sharding_audit.py [--poses 256 1024] [--devices 8]
        [--json_out PATH]
"""

import argparse
import json
import os
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

# The modelled deployment: H100 SXM cards joined by NVLink (450 GB/s each
# way per card, NVIDIA data sheet).
_KIND = "NVIDIA H100 80GB HBM3"
_NVLINK_BW = 4.5e11


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--poses", type=int, nargs="+", default=[256, 1024])
    parser.add_argument(
        "--measured_iter_ms", type=float, nargs="*", default=[],
        help="measured single-card per-iteration time for each --poses "
        "entry (bench.py numbers); the efficiency model then uses real "
        "compute time instead of the speed-of-light FLOP bound",
    )
    parser.add_argument("--devices", type=int, default=4)
    parser.add_argument("--json_out", default="")
    args = parser.parse_args(argv)

    # The CPU-mesh environment must be set before jax is imported.
    os.environ["JAX_PLATFORMS"] = "cpu"
    xf = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xf:
        os.environ["XLA_FLAGS"] = (
            xf + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from obvi_slam_tpu import flops as flops_mod
    from obvi_slam_tpu import parallel as par
    from obvi_slam_tpu.synthetic import synthetic_problem

    mesh = par.make_mesh()
    n_dev = mesh.devices.size
    out = {"devices": n_dev, "tiers": []}

    for n_pose in args.poses:
        n_points = n_pose * 16
        n_obj = max(n_pose // 16, 8)
        p = synthetic_problem(
            n_poses=n_pose, n_points=n_points, n_objects=n_obj,
            obs_per_point=6, obs_per_object=12, dtype=np.float32,
        )
        state, _, cams, tables, plan, free, weights, huber = p
        tables = par.shard_tables(tables, mesh)
        weights = par.shard_weights(weights, mesh)
        plan_s = par.shard_plan(plan, mesh)
        state = par.replicate(state, mesh)
        cams = par.replicate(cams, mesh)
        free = par.replicate(free, mesh)
        radius = jnp.asarray(1e4, jnp.float32)

        step = par.sharded_compute_step(mesh)
        lowered = step.lower(
            state, cams, tables, plan_s, free, weights, radius, huber
        )
        compiled = lowered.compile()
        hlo = compiled.as_text()

        from obvi_slam_tpu.parallel.audit import (
            all_reduce_bytes,
            collect_collectives,
        )

        by_op = collect_collectives(hlo)
        ar_bytes = all_reduce_bytes(by_op)

        total_flops = sum(
            flops_mod.lm_iteration_flops(
                p[3], plan, n_pose, n_points, n_obj
            ).values()
        )
        peak = flops_mod.device_peaks(_KIND)["f32_flops"]

        idx = args.poses.index(n_pose)
        measured_ms = (
            args.measured_iter_ms[idx]
            if idx < len(args.measured_iter_ms)
            else None
        )

        ag_bytes = by_op.get("all-gather", {}).get("bytes", 0)
        # r5: the trajectory-domain band solve replaces the replicated CR
        # path's tile-batch all-gathers with point-to-point halo exchanges
        # (collective-permute) and small all-to-alls — count them at 1x
        # payload per link (they move each byte once, unlike ring
        # all-reduce's 2(N-1)/N).
        cp_bytes = by_op.get("collective-permute", {}).get("bytes", 0)
        a2a_bytes = by_op.get("all-to-all", {}).get("bytes", 0)

        def eff(n, link_bw):
            # Measured single-card iteration time when provided (the FLOP
            # bound understates compute and so overstates the comm share);
            # speed of light at the f32 peak otherwise.
            t1 = measured_ms / 1e3 if measured_ms else total_flops / peak
            t_comm = (
                2 * (n - 1) / n * ar_bytes
                + (n - 1) / n * ag_bytes
                + cp_bytes
                + a2a_bytes
            ) / link_bw
            return t1 / n / (t1 / n + t_comm)

        tier = {
            "n_pose": n_pose,
            "n_points": n_points,
            "n_objects": n_obj,
            "collectives": by_op,
            "all_reduce_bytes_per_iter": ar_bytes,
            "all_gather_bytes_per_iter": ag_bytes,
            "permute_bytes_per_iter": cp_bytes,
            "all_to_all_bytes_per_iter": a2a_bytes,
            "iter_flops": total_flops,
            "flops_per_device": total_flops / n_dev,
            "measured_iter_ms": measured_ms,
            "projected_eff": {
                "nvlink_2dev": round(eff(2, _NVLINK_BW), 3),
                "nvlink_4dev": round(eff(4, _NVLINK_BW), 3),
            },
            "assumptions": {
                "device_kind": _KIND,
                "peak_f32_flops_per_s": peak,
                "nvlink_bw_bytes_per_s": _NVLINK_BW,
                "all_reduce_model": "ring 2(N-1)/N",
            },
        }
        out["tiers"].append(tier)
        print(json.dumps({k: v for k, v in tier.items() if k != "collectives"}))
        for op, rec in by_op.items():
            print(f"  {op}: n={rec['count']} bytes={rec['bytes']/1e6:.2f}MB "
                  f"e.g. {rec['shapes'][:4]}")

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
