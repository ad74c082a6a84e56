"""Fully on-device Levenberg-Marquardt: the whole trust-region loop as one
XLA computation (``lax.while_loop``).

Same Ceres semantics as ``solver.lm`` (accept/reject on relative decrease,
radius update, function/gradient/parameter tolerances, non-monotonic steps)
but with ZERO host round-trips per iteration — one dispatch per solve. On an
accelerator this removes the per-iteration host<->device latency that
dominates the host-loop variant; per-iteration records are returned as fixed-size arrays
for IterationLogger parity.

Termination codes: 0 = running, 1 = FUNCTION_TOLERANCE, 2 = GRADIENT_TOLERANCE,
3 = PARAMETER_TOLERANCE, 4 = MIN_TRUST_REGION, 5 = MAX_ITERATIONS.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from obvi_slam_tpu import factors as fac
from obvi_slam_tpu.solver import schur as schur_mod
from obvi_slam_tpu.solver.lm import IterationRecord, LMParams, LMSummary
from obvi_slam_tpu.types import BAState

TERMINATION_NAMES = {
    1: "FUNCTION_TOLERANCE",
    2: "GRADIENT_TOLERANCE",
    3: "PARAMETER_TOLERANCE",
    4: "MIN_TRUST_REGION",
    5: "MAX_ITERATIONS",
}


class _Carry(NamedTuple):
    state: BAState
    cost: jnp.ndarray
    radius: jnp.ndarray
    decrease_factor: jnp.ndarray
    it: jnp.ndarray
    term: jnp.ndarray  # 0 = running
    num_success: jnp.ndarray
    num_fail: jnp.ndarray
    # Non-monotonic bookkeeping (Ceres TrustRegionMinimizer).
    candidate_cost: jnp.ndarray
    reference_cost: jnp.ndarray
    acc_candidate_changes: jnp.ndarray
    acc_reference_changes: jnp.ndarray
    num_consecutive_nonmonotonic: jnp.ndarray
    # Per-iteration records.
    rec_cost: jnp.ndarray
    rec_change: jnp.ndarray
    rec_step_norm: jnp.ndarray
    rec_radius: jnp.ndarray
    rec_accepted: jnp.ndarray


class _StaticParams(NamedTuple):
    """The LMParams bits that must stay in the jit signature: the
    non-monotonic branch is Python control flow, and the per-iteration
    record arrays are sized by rec_cap (= max_num_iterations when records
    are on, else 1)."""

    allow_non_monotonic_steps: bool
    rec_cap: int


# Packing order of the dynamic-parameter vector (see _split_params).
_DYN_ORDER = (
    "max_num_iterations",
    "function_tolerance",
    "gradient_tolerance",
    "parameter_tolerance",
    "initial_trust_region_radius",
    "max_trust_region_radius",
    "min_trust_region_radius",
    "min_relative_decrease",
    "max_consecutive_nonmonotonic_steps",
)


@functools.lru_cache(maxsize=256)
def _split_params(params: LMParams, dtype_name: str, with_records: bool):
    """LMParams -> (device dyn vector, static part).

    Numeric fields ride as ONE cached device operand instead of jit static
    args: distinct solver-parameter sets (local/global/final/PGO phases)
    then share a single compiled program per problem signature — every
    avoided signature is an avoided compile (ints stay exact in f32 up to 2^24; iteration counts are ≤ O(100))."""
    import numpy as np

    vec = np.array(
        [float(getattr(params, f)) for f in _DYN_ORDER],
        dtype=np.dtype(dtype_name),
    )
    statics = _StaticParams(
        allow_non_monotonic_steps=bool(params.allow_non_monotonic_steps),
        rec_cap=max(int(params.max_num_iterations), 1) if with_records else 1,
    )
    return jnp.asarray(vec), statics


def _cost_fn(state, cams, tables, weights, huber):
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


def mesh_all(pred, mesh):
    """``pred`` AND-ed over every device's own copy of it, the same on all.

    A sharded solve computes its replicated values (the reduced system, the
    step, the termination test) once per device, and nothing makes those
    copies agree bit for bit. Where a loop exit taken from them differs
    between devices, the device that leaves the loop first waits in the next
    collective for devices that are still iterating, and the program hangs:
    the ``--shard_devices 4`` session did so on four GPUs without this vote,
    with or without the CLI's background LTM compile, and ran through with
    it. Every device votes with its rank, so the all-reduce sees a value
    that varies across the mesh and the compiler cannot drop it as a no-op
    on replicated data."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    n = int(mesh.devices.size)

    def vote(p):
        rank = jax.lax.axis_index(axis) + 1
        return jax.lax.psum(jnp.where(p, rank, 0), axis) == n * (n + 1) // 2

    return shard_map(
        vote, mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False
    )(pred)


def _run_lm(
    state, cams, tables, plan, free, weights, dyn, statics: _StaticParams,
    huber, dense_schur=None, with_records=False, shard_mesh=None,
):
    """The fused trust-region loop as a traceable function (shared by
    solve_fused_jit and the fused two-phase program). ``dyn`` is the
    _DYN_ORDER parameter vector (a device operand, NOT a static arg — see
    _split_params); ``statics`` carries the branch/shape bits."""
    dtype = state.poses.dtype
    max_it = dyn[0].astype(jnp.int32)
    func_tol, grad_tol, param_tol = dyn[1], dyn[2], dyn[3]
    max_radius, min_radius = dyn[5], dyn[6]
    min_rel_decrease = dyn[7]
    max_consec_nm = dyn[8].astype(jnp.int32)

    def zero_records():
        # Static off-switch: the per-iteration record writes cost real time
        # in the while body; carry length-1 dummies when nobody reads them.
        n = statics.rec_cap if with_records else 1
        z = jnp.zeros((n,), dtype=dtype)
        return z, z, z, z, jnp.zeros((n,), dtype=bool)

    init_cost = _cost_fn(state, cams, tables, weights, huber)
    rc, rch, rsn, rr, ra = zero_records()
    carry = _Carry(
        state=state,
        cost=init_cost,
        radius=dyn[4].astype(dtype),
        decrease_factor=jnp.asarray(2.0, dtype),
        it=jnp.asarray(0, jnp.int32),
        term=jnp.asarray(0, jnp.int32),
        num_success=jnp.asarray(0, jnp.int32),
        num_fail=jnp.asarray(0, jnp.int32),
        candidate_cost=init_cost,
        reference_cost=init_cost,
        acc_candidate_changes=jnp.asarray(0.0, dtype),
        acc_reference_changes=jnp.asarray(0.0, dtype),
        num_consecutive_nonmonotonic=jnp.asarray(0, jnp.int32),
        rec_cost=rc,
        rec_change=rch,
        rec_step_norm=rsn,
        rec_radius=rr,
        rec_accepted=ra,
    )

    def cond(c: _Carry):
        go = (c.term == 0) & (c.it < max_it)
        return go if shard_mesh is None else mesh_all(go, shard_mesh)

    def body(c: _Carry):
        delta, model_change, grad_max = schur_mod.compute_step(
            c.state, cams, tables, plan, free, weights, c.radius, huber,
            dense_schur=dense_schur, shard_mesh=shard_mesh,
        )
        new_state = BAState(
            poses=c.state.poses + delta.poses * free.poses[:, None],
            points=c.state.points + delta.points * free.points[:, None],
            objects=c.state.objects + delta.objects * free.objects[:, None],
        )
        new_cost = _cost_fn(new_state, cams, tables, weights, huber)
        step2 = (
            jnp.sum(delta.poses**2)
            + jnp.sum(delta.points**2)
            + jnp.sum(delta.objects**2)
        )
        x2 = (
            jnp.sum(c.state.poses**2)
            + jnp.sum(c.state.points**2)
            + jnp.sum(c.state.objects**2)
        )
        step_norm = jnp.sqrt(step2)
        x_norm = jnp.sqrt(x2)

        cost_change = c.cost - new_cost
        valid_model = model_change > 0
        rho = jnp.where(valid_model, cost_change / jnp.maximum(model_change, 1e-300), -1.0)
        if statics.allow_non_monotonic_steps:
            hist_rho = (c.reference_cost - new_cost) / jnp.maximum(model_change, 1e-300)
            relative_decrease = jnp.maximum(rho, hist_rho)
        else:
            relative_decrease = rho
        accepted = valid_model & (relative_decrease > min_rel_decrease)

        # Radius update.
        shrink = c.radius / c.decrease_factor
        grow = jnp.minimum(
            c.radius / jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
            max_radius,
        )
        new_radius = jnp.where(accepted, grow, shrink)
        new_decrease = jnp.where(accepted, 2.0, c.decrease_factor * 2.0)

        # Termination checks.
        grad_conv = grad_max <= grad_tol
        func_conv = accepted & (jnp.abs(cost_change) <= func_tol * c.cost)
        param_conv = accepted & (
            step_norm <= param_tol * (x_norm + param_tol)
        )
        radius_conv = (~accepted) & (new_radius < min_radius)
        term = jnp.where(
            grad_conv,
            2,
            jnp.where(
                func_conv, 1, jnp.where(param_conv, 3, jnp.where(radius_conv, 4, 0))
            ),
        ).astype(jnp.int32)

        # Non-monotonic bookkeeping on accepted steps.
        if statics.allow_non_monotonic_steps:
            acc_cand = c.acc_candidate_changes + cost_change
            acc_ref = c.acc_reference_changes + cost_change
            better_candidate = new_cost < c.candidate_cost
            cand_cost = jnp.where(better_candidate, new_cost, c.candidate_cost)
            acc_cand = jnp.where(better_candidate, 0.0, acc_cand)
            monotonic = cost_change >= 0
            n_nm = jnp.where(monotonic, 0, c.num_consecutive_nonmonotonic + 1)
            hit_limit = n_nm >= max_consec_nm
            ref_cost = jnp.where(
                monotonic, new_cost, jnp.where(hit_limit, cand_cost, c.reference_cost)
            )
            acc_ref = jnp.where(
                monotonic, 0.0, jnp.where(hit_limit, acc_cand, acc_ref)
            )
            cand_cost = jnp.where(accepted, cand_cost, c.candidate_cost)
            ref_cost = jnp.where(accepted, ref_cost, c.reference_cost)
            acc_cand = jnp.where(accepted, acc_cand, c.acc_candidate_changes)
            acc_ref = jnp.where(accepted, acc_ref, c.acc_reference_changes)
            n_nm = jnp.where(accepted, n_nm, c.num_consecutive_nonmonotonic)
        else:
            cand_cost = c.candidate_cost
            ref_cost = c.reference_cost
            acc_cand = c.acc_candidate_changes
            acc_ref = c.acc_reference_changes
            n_nm = c.num_consecutive_nonmonotonic

        sel = lambda a, b: jax.tree_util.tree_map(
            lambda x, y: jnp.where(accepted, x, y), a, b
        )
        out_state = sel(new_state, c.state)
        out_cost = jnp.where(accepted, new_cost, c.cost)

        i = c.it
        return _Carry(
            state=out_state,
            cost=out_cost,
            radius=new_radius,
            decrease_factor=new_decrease,
            it=i + 1,
            term=term,
            num_success=c.num_success + accepted.astype(jnp.int32),
            num_fail=c.num_fail + (~accepted).astype(jnp.int32),
            candidate_cost=cand_cost,
            reference_cost=ref_cost,
            acc_candidate_changes=acc_cand,
            acc_reference_changes=acc_ref,
            num_consecutive_nonmonotonic=n_nm,
            rec_cost=(
                c.rec_cost.at[i].set(c.cost) if with_records else c.rec_cost
            ),
            rec_change=(
                c.rec_change.at[i].set(jnp.where(accepted, cost_change, 0.0))
                if with_records
                else c.rec_change
            ),
            rec_step_norm=(
                c.rec_step_norm.at[i].set(jnp.where(accepted, step_norm, 0.0))
                if with_records
                else c.rec_step_norm
            ),
            rec_radius=(
                c.rec_radius.at[i].set(new_radius)
                if with_records
                else c.rec_radius
            ),
            rec_accepted=(
                c.rec_accepted.at[i].set(accepted)
                if with_records
                else c.rec_accepted
            ),
        )

    final = jax.lax.while_loop(cond, body, carry)
    term = jnp.where(final.term == 0, 5, final.term)
    return final._replace(term=term), init_cost


@functools.partial(
    jax.jit,
    static_argnames=(
        "statics", "huber", "dense_schur", "with_records", "shard_mesh"
    ),
)
def _solve_fused_core(
    state, cams, tables, plan, free, weights, dyn, statics, huber,
    dense_schur=None, with_records=False, shard_mesh=None,
):
    return _run_lm(
        state, cams, tables, plan, free, weights, dyn, statics, huber,
        dense_schur=dense_schur, with_records=with_records,
        shard_mesh=shard_mesh,
    )


def solve_fused_jit(
    state, cams, tables, plan, free, weights, params: LMParams, huber,
    dense_schur=None, with_records=False, shard_mesh=None,
):
    """Jit-cached fused solve. The numeric LMParams fields ride as a device
    operand (_split_params), so distinct solver-parameter sets share one
    compiled program per problem signature."""
    dyn, statics = _split_params(
        params, str(state.poses.dtype), with_records
    )
    return _solve_fused_core(
        state, cams, tables, plan, free, weights, dyn, statics, huber,
        dense_schur=dense_schur, with_records=with_records,
        shard_mesh=shard_mesh,
    )


def compile_solve_fused(
    state, cams, tables, plan, free, weights, params: LMParams, huber,
    dense_schur=None, with_records=False, shard_mesh=None,
):
    """solve_fused_jit's program, lowered and compiled ahead of time (for its
    ``memory_analysis()`` and for timings without the compile). Returns
    ``(compiled, args)``; ``compiled(*args)`` gives (final carry, initial
    cost)."""
    dyn, statics = _split_params(
        params, str(state.poses.dtype), with_records
    )
    args = (state, cams, tables, plan, free, weights, dyn)
    lowered = _solve_fused_core.lower(
        *args, statics=statics, huber=huber, dense_schur=dense_schur,
        with_records=with_records, shard_mesh=shard_mesh,
    )
    return lowered.compile(), args


@functools.partial(
    jax.jit,
    static_argnames=(
        "statics1", "statics2", "huber", "tp_cfg", "dense_schur",
        "with_records", "shard_mesh"
    ),
)
def _solve_two_phase_core(
    state, cams, tables, plan, free, weights, aux,
    dyn1, statics1, dyn2, statics2, huber, tp_cfg,
    dense_schur=None, with_records=False, shard_mesh=None,
):
    """The reference's whole two-phase window iteration as ONE XLA program:
    phase-1 fused LM -> residual ranking + factor re-selection at the
    phase-1 optimum (solver/two_phase.py, host-identical semantics) ->
    phase-2 fused LM restarted from the INPUT state (the reference's
    revert-then-reoptimize, offline_problem_runner.h:544-894). Removes the
    per-window residual readback + weight re-upload + extra dispatch
    fences."""
    from obvi_slam_tpu.solver import two_phase as tp_mod

    final1, init_cost1 = _run_lm(
        state, cams, tables, plan, free, weights, dyn1, statics1, huber,
        dense_schur=dense_schur, with_records=with_records,
        shard_mesh=shard_mesh,
    )
    res = fac.all_residuals(
        final1.state, cams, tables, huber.invalid_ellipse_error
    )
    weights2 = tp_mod.reweight_on_device(
        tables, weights, res["reproj"], res["bbox"], aux, tp_cfg,
        n_pose=state.poses.shape[0], n_point=state.points.shape[0],
    )
    final2, init_cost2 = _run_lm(
        state, cams, tables, plan, free, weights2, dyn2, statics2, huber,
        dense_schur=dense_schur, with_records=with_records,
        shard_mesh=shard_mesh,
    )
    return final1, init_cost1, final2, init_cost2


def solve_two_phase_jit(
    state, cams, tables, plan, free, weights, aux,
    params1: LMParams, params2: LMParams, huber, tp_cfg,
    dense_schur=None, with_records=False, shard_mesh=None,
):
    dtype = str(state.poses.dtype)
    dyn1, statics1 = _split_params(params1, dtype, with_records)
    dyn2, statics2 = _split_params(params2, dtype, with_records)
    return _solve_two_phase_core(
        state, cams, tables, plan, free, weights, aux,
        dyn1, statics1, dyn2, statics2, huber, tp_cfg,
        dense_schur=dense_schur, with_records=with_records,
        shard_mesh=shard_mesh,
    )


def solve_two_phase_fused(
    state, cams, tables, plan, free, weights, aux,
    params1: LMParams, params2: LMParams,
    huber: schur_mod.HuberParams, tp_cfg,
    with_records: bool = False, shard_mesh=None,
):
    """Host wrapper: returns (final_state, summary1, summary2) with ONE
    batched device->host readback for both phases' summaries."""
    final1, ic1, final2, ic2 = solve_two_phase_jit(
        state, cams, tables, plan, free, weights, aux,
        params1, params2, huber, tp_cfg,
        with_records=with_records, shard_mesh=shard_mesh,
    )
    reads = []
    for final, ic in ((final1, ic1), (final2, ic2)):
        reads.extend([
            ic, final.cost, final.it, final.num_success, final.num_fail,
            final.term, final.rec_cost, final.rec_change,
            final.rec_step_norm, final.rec_radius, final.rec_accepted,
        ])
    host = jax.device_get(tuple(reads))
    summaries = []
    for k in range(2):
        (ic_h, fc_h, it_h, ns_h, nf_h, term_h, rc_h, rch_h, rsn_h, rr_h,
         ra_h) = host[k * 11:(k + 1) * 11]
        summary = LMSummary()
        summary.initial_cost = float(ic_h)
        summary.final_cost = float(fc_h)
        summary.num_iterations = int(it_h)
        summary.num_successful_steps = int(ns_h)
        summary.num_unsuccessful_steps = int(nf_h)
        summary.termination = TERMINATION_NAMES[int(term_h)]
        if with_records:
            n = int(it_h)
            summary.iterations = [
                IterationRecord(
                    i, float(rc_h[i]), float(rch_h[i]), float(rsn_h[i]),
                    float(rr_h[i]), bool(ra_h[i]),
                )
                for i in range(n)
            ]
        summaries.append(summary)
    return final2.state, summaries[0], summaries[1]


def solve_fused(
    state,
    cams,
    tables,
    plan,
    free,
    weights=None,
    params: LMParams = LMParams(),
    huber: schur_mod.HuberParams = schur_mod.HuberParams(),
    with_records: bool = False,
    shard_mesh=None,
):
    """Drop-in replacement for solver.lm.solve with one device dispatch."""
    if weights is None:
        weights = schur_mod.ones_weights(tables, dtype=state.poses.dtype)
    if params.max_num_iterations == 0:
        init_cost = float(
            jax.jit(_cost_fn, static_argnames=("huber",))(
                state, cams, tables, weights, huber
            )
        )
        s = LMSummary()
        s.initial_cost = init_cost
        s.final_cost = init_cost
        s.termination = "MAX_ITERATIONS"
        return state, s

    final, init_cost = solve_fused_jit(
        state, cams, tables, plan, free, weights, params, huber,
        with_records=with_records, shard_mesh=shard_mesh,
    )
    # ONE batched device->host transfer for every scalar/record the summary
    # needs: per-field float()/int() reads are separate round trips.
    (ic_h, fc_h, it_h, ns_h, nf_h, term_h, rc_h, rch_h, rsn_h, rr_h, ra_h) = (
        jax.device_get((
            init_cost, final.cost, final.it, final.num_success,
            final.num_fail, final.term, final.rec_cost, final.rec_change,
            final.rec_step_norm, final.rec_radius, final.rec_accepted,
        ))
    )
    summary = LMSummary()
    summary.initial_cost = float(ic_h)
    summary.final_cost = float(fc_h)
    summary.num_iterations = int(it_h)
    summary.num_successful_steps = int(ns_h)
    summary.num_unsuccessful_steps = int(nf_h)
    summary.termination = TERMINATION_NAMES[int(term_h)]
    if with_records:
        n = int(it_h)
        rec_cost = rc_h[:n]
        rec_change = rch_h[:n]
        rec_sn = rsn_h[:n]
        rec_r = rr_h[:n]
        rec_a = ra_h[:n]
        summary.iterations = [
            IterationRecord(
                i,
                float(rec_cost[i]),
                float(rec_change[i]),
                float(rec_sn[i]),
                float(rec_r[i]),
                bool(rec_a[i]),
            )
            for i in range(n)
        ]
    return final.state, summary
