"""Analytic FLOP accounting for the LM iteration — speed-of-light reporting.

The reference measures per-phase wall time with RAII cumulative timers
(``include/analysis/cumulative_timer_constants.h:11-107``) but publishes no
FLOP/efficiency numbers. Per-phase device arithmetic is statically known from
the problem shapes (capacity-padded factor tables and the Schur plan), so the
bench reports, per phase of the solve, the float32 FLOPs (mults+adds, padded
shapes — exactly what the device executes) and the speed-of-light time at the
device's published float32 peak.

Every product in ``compute_step`` runs at ``Precision.HIGHEST`` (full float32,
no TF32), so the float32 rate outside the tensor cores is the bound for every
phase; the TF32 and bf16 rates are kept in the table for kernels that use them.
"""

from __future__ import annotations

from typing import Dict

# Published dense peaks per device, keyed by ``jax.devices()[0].device_kind``.
# NVIDIA H100 SXM5 data sheet (dense, no sparsity, at the 700 W limit):
# 67 TFLOP/s float32 without tensor cores, 495 TFLOP/s TF32, 989 TFLOP/s bf16,
# 3.35 TB/s HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense",
    },
}


def device_peaks(device_kind: str) -> Dict:
    """Peak table entry for ``device_kind``; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def lm_iteration_flops(tables, plan, n_pose, n_point, n_obj) -> Dict[str, float]:
    """Per-phase float32 FLOP model of one compute_step + cost evaluation.

    Returns {phase: flops} with phases named after the computation stages
    inside the reference's ``*_solve_opt`` timers (the whole table IS the
    solve phase).
    """
    F_rp = int(tables.reproj.capacity)
    F_bb = int(tables.bbox.capacity)
    F_sh = int(tables.shape.capacity)
    F_rl = int(tables.relpose.capacity)
    F_lt = int(tables.ltm.capacity)
    Lp, Cp = (int(s) for s in plan.pt_slot_gather.shape)
    Lo, Co = (int(s) for s in plan.ob_slot_gather.shape)
    d6 = 6 * n_pose

    # Residual + Jacobian evaluation: per-factor op counts from the analytic
    # chains (reproj_fast.py / factors/residuals.py); conservative estimates.
    resjac = 560 * F_rp + 2400 * F_bb + 60 * F_sh + 700 * F_rl + 120 * F_lt

    # Block H/b accumulation (outer products + segment sums).
    hb = F_rp * (2 * (36 + 9 + 18) + 18) + F_bb * (2 * (36 + 49 + 42) + 22) \
        + F_sh * 2 * 49 + F_rl * 2 * (2 * 36 + 36) + F_lt * 2 * 49

    # One-hot z build. The banded layout shrinks the point one-hot to the
    # 128-wide local window.
    banded = getattr(plan, "pt_band_local_pose", None) is not None
    pt_width = 2 * 64 if banded else n_pose
    z_build = 2.0 * Lp * Cp * pt_width * 18 + 2.0 * Lo * Co * n_pose * 42

    # Schur grams: the dominant products (S assembly). With the band layout
    # the point gram runs as G batched (768, Lg*3, 768) group grams instead
    # of one (6P, 3Lp, 6P).
    pt_gram_width = 6 * pt_width
    rel_banded = getattr(plan, "rel_band_local_pose", None) is not None
    rel_gram_width = 6 * (2 * 64) if (banded and rel_banded) else d6
    gram = (
        2.0 * pt_gram_width * pt_gram_width * (Lp * 3)  # point gram
        + 2.0 * d6 * d6 * (Lo * 7)      # object gram
        + 2.0 * rel_gram_width * rel_gram_width * (6 * (F_rl + n_pose))
    )

    return {
        "residual_jacobian_eval": float(resjac),
        "hessian_block_accumulation": float(hb),
        "landmark_block_inverses": float(
            n_point * 120 + n_obj * 1000 + n_pose * 600
        ),
        "schur_z_build": z_build,
        "schur_gram": gram,
        # Reduced RHS + back-substitution coupling contractions.
        "reduced_rhs_backsub": 2.0 * (Lp * 3 * pt_gram_width + Lo * 7 * d6) * 2,
        # Dense Cholesky of S + two triangular solves + refinement matvec.
        "reduced_cholesky_solve": d6**3 / 3.0 + 6.0 * d6 * d6,
        # Cost evaluation of the stepped state (residuals only).
        "cost_evaluation": 0.35 * resjac,
    }


def speed_of_light_table(
    phases: Dict[str, float], device_kind: str, measured_iter_s: float = None
) -> Dict:
    """Speed-of-light time of each phase at the device's float32 peak and,
    if measured, the iteration's speed-of-light fraction."""
    peak = device_peaks(device_kind)["f32_flops"]
    out = {
        "device_kind": device_kind,
        "peak_f32_flops": peak,
        "phases": {
            name: {"flops_f32": f, "sol_us": f / peak * 1e6}
            for name, f in phases.items()
        },
    }
    total = sum(phases.values())
    out["total_flops_f32"] = total
    out["total_sol_us"] = total / peak * 1e6
    if measured_iter_s is not None and measured_iter_s > 0:
        out["measured_iter_us"] = measured_iter_s * 1e6
        out["sol_fraction"] = total / peak / measured_iter_s
    return out
