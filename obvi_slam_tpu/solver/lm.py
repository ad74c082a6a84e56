"""Levenberg-Marquardt trust-region driver with Ceres semantics.

Replicates the solver behavior the reference gets from
``ceres::Solve`` with LM + SPARSE_SCHUR (object_pose_graph_optimizer.h:634-707,
params in optimization_solver_params.h:17-23):

  - LM damping H + diag(clamp(diag(H), 1e-6, 1e32)) / radius
  - step acceptance on relative decrease rho = actual/model > 1e-3
  - accepted:  radius /= max(1/3, 1 - (2 rho - 1)^3); decrease_factor = 2
    rejected:  radius /= decrease_factor; decrease_factor *= 2
  - convergence on function/gradient/parameter tolerance or max iterations
  - optional non-monotonic steps (allow_non_monotonic_steps)

The per-iteration heavy work (residuals, Jacobians, Schur solve) is one jitted
device computation (``schur.compute_step``); the scalar accept/reject logic
runs on host exactly once per iteration, mirroring Ceres' minimizer loop.
Iteration records match the reference's per-iteration CSV schema
(optimization_logger.h:29-92: cost, cost_change, step_norm, success).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from obvi_slam_tpu import factors as fac
from obvi_slam_tpu.solver import schur as schur_mod
from obvi_slam_tpu.types import BAState


@dataclass(frozen=True)
class LMParams:
    """Mirror of OptimizationSolverParams (optimization_solver_params.h:17-23)."""

    max_num_iterations: int = 100
    allow_non_monotonic_steps: bool = False
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    max_consecutive_nonmonotonic_steps: int = 5

    @classmethod
    def fixed_iterations(cls, n: int) -> "LMParams":
        """``n`` iterations with every convergence tolerance off, so the
        iteration count never depends on the values (benchmarks, checks)."""
        return cls(max_num_iterations=n, function_tolerance=0.0,
                   gradient_tolerance=0.0, parameter_tolerance=0.0)


class IterationRecord(NamedTuple):
    iteration: int
    cost: float
    cost_change: float
    step_norm: float
    radius: float
    accepted: bool


@dataclass
class LMSummary:
    initial_cost: float = 0.0
    final_cost: float = 0.0
    num_iterations: int = 0
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    termination: str = "NO_CONVERGENCE"
    iterations: List[IterationRecord] = field(default_factory=list)


@functools.partial(jax.jit, static_argnames=("huber", "shard_mesh"))
def _jit_step(state, cams, tables, plan, free, weights, radius, huber,
              shard_mesh=None):
    return schur_mod.compute_step(
        state, cams, tables, plan, free, weights, radius, huber,
        shard_mesh=shard_mesh,
    )


@functools.partial(jax.jit, static_argnames=("huber", "shard_mesh"))
def _jit_iteration(state, cams, tables, plan, free, weights, radius, huber,
                   shard_mesh=None):
    """One full LM trial in ONE dispatch: step + candidate state + new cost +
    norms. The host loop then needs a single device round-trip per iteration
    (the accept/reject/radius logic stays on host, matching Ceres)."""
    delta, model_change, grad_max = schur_mod.compute_step(
        state, cams, tables, plan, free, weights, radius, huber,
        shard_mesh=shard_mesh,
    )
    new_state = BAState(
        poses=state.poses + delta.poses * free.poses[:, None],
        points=state.points + delta.points * free.points[:, None],
        objects=state.objects + delta.objects * free.objects[:, None],
    )
    new_cost = fac.total_cost(
        new_state,
        cams,
        tables,
        huber_reproj=huber.reproj,
        huber_bbox=huber.bbox,
        huber_shape=huber.shape,
        huber_relpose=huber.relpose,
        huber_ltm=huber.ltm,
        invalid_error=huber.invalid_ellipse_error,
        reproj_weight=weights.reproj,
        bbox_weight=weights.bbox,
        shape_weight=weights.shape,
        relpose_weight=weights.relpose,
        ltm_weight=weights.ltm,
    )
    step2 = (
        jnp.sum(delta.poses**2) + jnp.sum(delta.points**2) + jnp.sum(delta.objects**2)
    )
    x2 = jnp.sum(state.poses**2) + jnp.sum(state.points**2) + jnp.sum(state.objects**2)
    scalars = jnp.stack(
        [
            model_change.astype(state.poses.dtype),
            grad_max.astype(state.poses.dtype),
            new_cost.astype(state.poses.dtype),
            jnp.sqrt(step2),
            jnp.sqrt(x2),
        ]
    )
    return new_state, scalars


@functools.partial(jax.jit, static_argnames=("huber",))
def _jit_cost(state, cams, tables, weights, huber):
    return fac.total_cost(
        state,
        cams,
        tables,
        huber_reproj=huber.reproj,
        huber_bbox=huber.bbox,
        huber_shape=huber.shape,
        huber_relpose=huber.relpose,
        huber_ltm=huber.ltm,
        invalid_error=huber.invalid_ellipse_error,
        reproj_weight=weights.reproj,
        bbox_weight=weights.bbox,
        shape_weight=weights.shape,
        relpose_weight=weights.relpose,
        ltm_weight=weights.ltm,
    )


def solve(
    state: BAState,
    cams,
    tables,
    plan,
    free,
    weights=None,
    params: LMParams = LMParams(),
    huber: schur_mod.HuberParams = schur_mod.HuberParams(),
    iteration_callback=None,
    shard_mesh=None,
):
    """Run LM to convergence. Returns (state, LMSummary)."""
    if weights is None:
        weights = schur_mod.ones_weights(tables, dtype=state.poses.dtype)

    summary = LMSummary()
    cost = float(_jit_cost(state, cams, tables, weights, huber))
    summary.initial_cost = cost
    radius = params.initial_trust_region_radius
    decrease_factor = 2.0

    # Non-monotonic bookkeeping (Ceres TrustRegionMinimizer).
    candidate_cost = cost
    accumulated_candidate_changes = 0.0
    accumulated_reference_changes = 0.0
    reference_cost = cost
    num_consecutive_nonmonotonic = 0

    if params.max_num_iterations == 0:
        summary.final_cost = cost
        summary.termination = "MAX_ITERATIONS"
        return state, summary

    for it in range(params.max_num_iterations):
        new_state, scalars = _jit_iteration(
            state, cams, tables, plan, free, weights,
            jnp.asarray(radius, state.poses.dtype), huber, shard_mesh=shard_mesh
        )
        # ONE device->host readback per iteration.
        model_change, grad_max, new_cost, step_norm, x_norm = map(
            float, np.asarray(scalars)
        )

        if grad_max <= params.gradient_tolerance:
            summary.termination = "GRADIENT_TOLERANCE"
            break

        accepted = False
        cost_change = 0.0
        if model_change > 0:
            cost_change = cost - new_cost
            rho = cost_change / model_change
            relative_decrease = rho
            if params.allow_non_monotonic_steps:
                # Ceres: compare against historical reference cost too.
                hist_change = reference_cost - new_cost
                relative_decrease = max(rho, hist_change / model_change)
            if relative_decrease > params.min_relative_decrease:
                accepted = True
                rho_clamped = 2.0 * rho - 1.0
                radius = radius / max(1.0 / 3.0, 1.0 - rho_clamped**3)
                radius = min(radius, params.max_trust_region_radius)
                decrease_factor = 2.0
            else:
                radius = radius / decrease_factor
                decrease_factor *= 2.0
        else:
            # Invalid / null step.
            radius = radius / decrease_factor
            decrease_factor *= 2.0

        rec = IterationRecord(it, cost, cost_change, step_norm if accepted else 0.0, radius, accepted)
        summary.iterations.append(rec)
        if iteration_callback is not None:
            iteration_callback(rec)

        if accepted:
            summary.num_successful_steps += 1
            state = new_state
            # Non-monotonic candidate bookkeeping.
            if params.allow_non_monotonic_steps:
                new_cost_val = cost - cost_change
                accumulated_candidate_changes += cost_change
                accumulated_reference_changes += cost_change
                if new_cost_val < candidate_cost:
                    candidate_cost = new_cost_val
                    accumulated_candidate_changes = 0.0
                if cost_change >= 0:
                    num_consecutive_nonmonotonic = 0
                    reference_cost = cost - cost_change
                    accumulated_reference_changes = 0.0
                else:
                    num_consecutive_nonmonotonic += 1
                    if (
                        num_consecutive_nonmonotonic
                        >= params.max_consecutive_nonmonotonic_steps
                    ):
                        reference_cost = candidate_cost
                        accumulated_reference_changes = accumulated_candidate_changes
            new_cost = cost - cost_change
            # Ceres convergence checks (on accepted steps).
            if abs(cost_change) <= params.function_tolerance * cost:
                cost = new_cost
                summary.termination = "FUNCTION_TOLERANCE"
                break
            if step_norm <= params.parameter_tolerance * (
                x_norm + params.parameter_tolerance
            ):
                cost = new_cost
                summary.termination = "PARAMETER_TOLERANCE"
                break
            cost = new_cost
        else:
            summary.num_unsuccessful_steps += 1
            if radius < params.min_trust_region_radius:
                summary.termination = "MIN_TRUST_REGION"
                break

    summary.num_iterations = len(summary.iterations)
    summary.final_cost = cost
    if summary.termination == "NO_CONVERGENCE":
        summary.termination = "MAX_ITERATIONS"
    return state, summary
