"""Fused two-phase optimization support: outlier selection + factor
re-selection ON DEVICE.

The reference's two-phase outlier rejection
(``offline_problem_runner.h:544-894``) solves, ranks per-factor residuals on
host, REBUILDS the Ceres problem without the worst
``feature_outlier_percentage`` of reprojection/bbox blocks, reverts values,
and solves again. Keeping the ranking + re-selection on host costs one
residual readback + weight re-upload per window, fences that can cost more
than the solves. With this module
the whole window iteration fuses into ONE XLA program
(``lm_fused.solve_two_phase_fused``):

  solve_1 (fused LM)  ->  per-factor squared residuals at the phase-1
  optimum  ->  stable-rank top-N outlier selection (bit-identical to the
  host's np.argsort ranking: both sorts are stable over the same f32 keys)
  ->  the factor-selection cascade of ``problem.compute_inclusion_weights``
  re-evaluated with segment-sums over the factor tables  ->  solve_2 from
  the ORIGINAL input state (the reference's revert-then-reoptimize
  semantics — the pre-solve state is simply the program's input).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from obvi_slam_tpu.solver import schur as schur_mod


class TwoPhaseConfig(NamedTuple):
    """Static factor-selection parameters (hashable; jit static arg).

    Mirrors the Scope/iteration fields the host cascade reads
    (solver/problem.py compute_inclusion_weights)."""

    feature_outlier_percentage: float
    min_low_level_feature_observations: int
    min_low_level_feature_observations_per_frame: int
    min_object_observations: int
    include_visual_factors: bool
    include_object_factors: bool
    include_shape_priors: bool
    fix_objects: bool
    fix_ltm_objects: bool
    force_include_ltm_objs: bool


class TwoPhaseAux(NamedTuple):
    """Per-problem device arrays the re-selection needs (built by
    build_problem alongside the tables, synced with them)."""

    is_ltm_obj: jnp.ndarray  # (n_obj,) bool — object row is an LTM object
    shape_live: jnp.ndarray  # (S,) bool — shape row not a merge tombstone


def _outlier_mask(sq, live, pct):
    """Worst-``pct`` live rows by squared residual, host-identical:
    stable argsort of -sq over live rows, exclude ranks < floor(n_live*pct).
    The host pass (runner.py) mirrors BOTH conventions — kind='stable'
    argsort over the same f32 keys and the same f32 floor(n_live*pct)
    count — so the selected sets match exactly, ties and near-integer
    products included."""
    neg = jnp.where(live, sq, -jnp.inf)
    order = jnp.argsort(-neg, stable=True)
    rank = jnp.zeros_like(order).at[order].set(
        jnp.arange(order.shape[0], dtype=order.dtype)
    )
    # Pin the count product to f32 regardless of the ambient dtype: the
    # host pass (runner.py) computes int(floor(f32(n_live) * f32(pct))),
    # and under x64 an f64 product here could floor differently for
    # near-integer n_live * pct.
    n_out = jnp.floor(
        jnp.sum(live).astype(jnp.float32) * jnp.float32(pct)
    ).astype(jnp.int32)
    return live & (rank < n_out)


def reweight_on_device(
    tables, w1, res_reproj, res_bbox, aux: TwoPhaseAux, cfg: TwoPhaseConfig,
    n_pose: int, n_point: int,
):
    """Phase-2 FactorWeights from phase-1 weights + phase-1-optimum
    residuals — compute_inclusion_weights' phase-2 call as segment-sums.

    Outlier RANKING pools only rows live under the phase-1 weights (the
    host's ``live = w > 0``); factor CANDIDACY then restarts from all table
    rows minus the outliers, exactly like the host cascade (rows dead in
    phase 1 through the min-observation rules are candidates again and
    re-die through the same rules)."""
    dtype = w1.reproj.dtype
    rp, bb, sh, rl, lt = (
        tables.reproj, tables.bbox, tables.shape, tables.relpose, tables.ltm
    )
    n_obj = aux.is_ltm_obj.shape[0]
    pct = cfg.feature_outlier_percentage

    rp_live = rp.mask & (w1.reproj > 0)
    bb_live = bb.mask & (w1.bbox > 0)
    rp_sq = jnp.sum(res_reproj * res_reproj, axis=1)
    bb_sq = jnp.sum(res_bbox * res_bbox, axis=1)
    rp_keep = rp.mask & ~_outlier_mask(rp_sq, rp_live, pct)
    bb_keep = bb.mask & ~_outlier_mask(bb_sq, bb_live, pct)

    # Reproj: min live observations per feature.
    feat_count = jax.ops.segment_sum(
        rp_keep.astype(dtype), rp.point_idx, num_segments=n_point
    )
    rp_keep = rp_keep & (
        feat_count[rp.point_idx] >= cfg.min_low_level_feature_observations
    )
    if not cfg.include_visual_factors:
        rp_keep = jnp.zeros_like(rp_keep)

    # Relpose: only for feature-starved frames (pose row == window frame).
    if (
        cfg.min_low_level_feature_observations_per_frame > 0
        and cfg.include_visual_factors
    ):
        frame_obs = jax.ops.segment_sum(
            rp_keep.astype(dtype), rp.pose_idx, num_segments=n_pose
        )
        starved = frame_obs < cfg.min_low_level_feature_observations_per_frame
        rl_keep = rl.mask & (starved[rl.before_idx] | starved[rl.after_idx])
    else:
        rl_keep = jnp.zeros_like(rl.mask)

    # Objects: min live observations or LTM membership (and >=1 live obs).
    obj_count = jax.ops.segment_sum(
        bb_keep.astype(dtype), bb.obj_idx, num_segments=n_obj
    )
    obj_included = (
        (obj_count >= cfg.min_object_observations) | aux.is_ltm_obj
    ) & (obj_count > 0)
    bb_keep = bb_keep & obj_included[bb.obj_idx]
    if not cfg.include_object_factors:
        bb_keep = jnp.zeros_like(bb_keep)
        obj_included = jnp.zeros_like(obj_included)

    # Object-only factors (shape priors / LTM priors) for included objects.
    use_object_only = cfg.include_object_factors and not cfg.fix_objects
    fix_ltm = cfg.fix_objects or cfg.fix_ltm_objects
    if use_object_only:
        if fix_ltm:
            objs_oo = obj_included & ~aux.is_ltm_obj
        else:
            objs_oo = obj_included
            if cfg.force_include_ltm_objs:
                objs_oo = objs_oo | aux.is_ltm_obj
    else:
        objs_oo = jnp.zeros_like(obj_included)
    if cfg.include_shape_priors:
        sh_keep = sh.mask & aux.shape_live & objs_oo[sh.obj_idx]
    else:
        sh_keep = jnp.zeros_like(sh.mask)
    lt_keep = lt.mask & objs_oo[lt.obj_idx]

    return schur_mod.FactorWeights(
        reproj=rp_keep.astype(dtype),
        bbox=bb_keep.astype(dtype),
        shape=sh_keep.astype(dtype),
        relpose=rl_keep.astype(dtype),
        ltm=lt_keep.astype(dtype),
    )
