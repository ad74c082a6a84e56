"""CPU f64 reference LM step on the bench problem -> /tmp/precision_ref.npz.

Run with: JAX_PLATFORMS=cpu python tools/precision_f64_ref.py
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
import pathlib; sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from obvi_slam_tpu.synthetic import synthetic_problem
from obvi_slam_tpu.solver import schur as schur_mod

state0, _, cams, tables, plan, free, weights, huber = synthetic_problem(
    n_poses=256, n_points=4096, n_objects=32,
    obs_per_point=6, obs_per_object=12, dtype=np.float64,
)
radius = np.float64(1e4)
delta, mcc, gmax = schur_mod.compute_step(
    state0, cams, tables, plan, free, weights, radius, huber
)
np.savez(
    "/tmp/precision_ref.npz",
    poses=np.asarray(delta.poses, np.float64),
    points=np.asarray(delta.points, np.float64),
    objects=np.asarray(delta.objects, np.float64),
    mcc=float(mcc),
)
print("f64 reference saved; |dp|=", float(np.linalg.norm(delta.poses)))
