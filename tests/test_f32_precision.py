"""f32 (device-dtype) solver-step accuracy vs the f64 reference path.

The device runs the solver in f32 while the reference (Ceres) is f64. Two
mechanisms in ``schur.compute_step`` close most of that gap:
- precision=HIGHEST on the dense-U Schur contraction (a GPU may otherwise
  run f32 products in TF32; on CPU this is a no-op, so this test guards the
  refinement logic and overall f32 pipeline), and
- one step of iterative refinement on the reduced-camera Cholesky solve.

The test computes one LM step on the same synthetic problem in f64 and in
f32 and requires the f32 step to track the f64 step to f32-roundoff-level
relative error.
"""

import numpy as np
import jax.numpy as jnp

import obvi_slam_tpu.solver.schur as schur_mod
from obvi_slam_tpu.synthetic import synthetic_problem
from obvi_slam_tpu.types import BAState


def _step(dtype, dense_schur):
    state0, _, cams, tables, plan, free, weights, huber = synthetic_problem(
        n_poses=24, n_points=160, n_objects=4, seed=3, dtype=dtype
    )
    delta, model_change, grad_max = schur_mod.compute_step(
        state0,
        cams,
        tables,
        plan,
        free,
        weights,
        jnp.asarray(1e4, dtype=state0.poses.dtype),
        huber,
        dense_schur=dense_schur,
    )
    return delta, float(model_change)


def _rel_err(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    denom = np.linalg.norm(b.ravel()) + 1e-30
    return np.linalg.norm((a - b).ravel()) / denom


def test_f32_step_tracks_f64_dense_u():
    d64, mc64 = _step(np.float64, dense_schur=True)
    d32, mc32 = _step(np.float32, dense_schur=True)
    assert _rel_err(d32.poses, d64.poses) < 5e-3
    assert _rel_err(d32.points, d64.points) < 5e-3
    assert abs(mc32 - mc64) / (abs(mc64) + 1e-30) < 5e-3


def test_f32_step_tracks_f64_pair_path():
    d64, _ = _step(np.float64, dense_schur=False)
    d32, _ = _step(np.float32, dense_schur=False)
    assert _rel_err(d32.poses, d64.poses) < 5e-3
    assert _rel_err(d32.points, d64.points) < 5e-3


def test_dense_and_pair_paths_agree_f64():
    da, _ = _step(np.float64, dense_schur=True)
    db, _ = _step(np.float64, dense_schur=False)
    assert _rel_err(da.poses, db.poses) < 1e-10
    assert _rel_err(da.points, db.points) < 1e-10
