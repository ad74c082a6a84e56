"""Dump the collective ops of the DD-sharded banded step at 512 poses on
the 8-device CPU mesh (fast iteration on the trajectory-domain sharding).
Usage: env JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python tools/dd_hlo_probe.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")
import os
if os.environ.get("PROBE_X64"):
    jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from obvi_slam_tpu import parallel as par
from obvi_slam_tpu.parallel.audit import collect_collectives
from obvi_slam_tpu.solver import schur as schur_mod
from obvi_slam_tpu.synthetic import synthetic_problem

schur_mod._BAND_SOLVE_MIN_POSES = 256

mesh = par.make_mesh()
print("devices:", mesh.devices.size)
p = synthetic_problem(
    n_poses=int(os.environ.get("PROBE_POSES", "512")), n_points=int(os.environ.get("PROBE_POSES", "512"))*8, n_objects=int(os.environ.get("PROBE_OBJS", "16")),
    obs_per_point=6, obs_per_object=12, dtype=np.float32,
)
state, _, cams, tables, plan, free, weights, huber = p
radius = jnp.asarray(1e4, jnp.float32)
step = par.sharded_compute_step(mesh)
hlo = step.lower(
    par.replicate(state, mesh),
    par.replicate(cams, mesh),
    par.shard_tables(tables, mesh),
    par.shard_plan(plan, mesh),
    par.replicate(free, mesh),
    par.shard_weights(weights, mesh),
    radius,
    huber,
).compile().as_text()
by_op = collect_collectives(hlo)
import re as _re
# Top all-gathers by size with their op_name metadata.
entries = []
for line in hlo.splitlines():
    if "all-gather" in line and "= " in line and "get-tuple-element" not in line:
        lhs = line.split(" all-gather")[0]
        tot = 0
        for sm in _re.finditer(r"(f32|bf16|s32|pred|u32|f64)\[([0-9,]*)\]", lhs):
            dims = [int(x) for x in sm.group(2).split(",") if x] or [1]
            tot += int(np.prod(dims)) * {"f32":4,"s32":4,"u32":4,"bf16":2,"pred":1,"f64":8}[sm.group(1)]
        nm = _re.search(r'op_name="([^"]*)"', line)
        entries.append((tot, lhs.strip()[:90], nm.group(1)[:160] if nm else "?"))
entries.sort(reverse=True)
print("TOP ALL-GATHERS:")
for tot, lhs, nm in entries[:10]:
    print(f"  {tot/1e6:7.2f} MB  {lhs}")
    print(f"           {nm}")
for op, d in sorted(by_op.items()):
    print(f"{op}: count={d['count']}")
    from collections import Counter

    for s, c in Counter(d["shapes"]).most_common():
        m = __import__("re").match(r"\w+\[([0-9,]*)\]", s)
        dims = [int(x) for x in m.group(1).split(",") if x] if m else []
        nbytes = (int(np.prod(dims)) if dims else 0) * (
            4 if not s.startswith("pred") else 1
        )
        print(f"   {s} x{c}  ({nbytes/1e6:.2f} MB each)")
