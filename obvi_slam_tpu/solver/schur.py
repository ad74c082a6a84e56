"""On-device Schur-complement normal equations for object-visual BA.

Device-side replacement for Ceres' SPARSE_SCHUR linear solver
(``object_pose_graph_optimizer.h:652-666`` selects
``ceres::SPARSE_SCHUR`` + LM): landmarks (3-D feature points) and objects
(7-dof ellipsoids) are eliminated via batched small-block inverses, and the
reduced camera (pose) system is materialized DENSE — pose counts are
10^2–10^3, so the reduced system maps onto dense matrix products instead
of the reference's CPU sparse factorization.

Data-dependent structure (which pose observes which landmark) is precomputed
on the host into a ``SchurPlan`` of gather/scatter index arrays; the on-device
computation is then a fixed-shape pipeline of vmapped block ops, segment-sums
and scatter-adds that XLA fuses:

  residuals+J (vmapped jacfwd) -> Huber row-weights -> block H/b accumulation
  -> batched 3x3/7x7 inverses -> cross-pair outer products -> dense S
  -> Cholesky/LU solve -> back-substitution.

The plan depends only on factor *indices* (not values), so it is rebuilt on
host only when the window's factor set changes, and padded to bucketed
capacities to keep jit signatures stable.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from obvi_slam_tpu import factors as fac
from obvi_slam_tpu import geometry as geo
from obvi_slam_tpu.factors.reproj_fast import reproj_residuals_and_jac_fast
from obvi_slam_tpu.solver import band_solve as band_solve_mod
from obvi_slam_tpu.types import BAState, CameraBundle, FactorTables, FreeMasks
from obvi_slam_tpu.types import asarray as _t_asarray


class FactorWeights(NamedTuple):
    """Per-residual-block external weights (1 = keep, 0 = excluded).

    Implements the two-phase outlier exclusion
    (offline_problem_runner.h:670-801) AND the scope-dependent
    inclusion rules (min-observation thresholds, feature-starved relpose
    gating — object_pose_graph_optimizer.h:234-405) without rebuilding the
    problem: a dropped factor keeps its table row but contributes nothing, so
    phase-1/phase-2 solves share one jit signature.
    """

    reproj: jnp.ndarray  # (F,)
    bbox: jnp.ndarray  # (B,)
    shape: jnp.ndarray  # (S,)
    relpose: jnp.ndarray  # (R,)
    ltm: jnp.ndarray  # (L,)


def ones_weights(tables: FactorTables, dtype=jnp.float64):
    return FactorWeights(
        reproj=jnp.ones(tables.reproj.capacity, dtype=dtype),
        bbox=jnp.ones(tables.bbox.capacity, dtype=dtype),
        shape=jnp.ones(tables.shape.capacity, dtype=dtype),
        relpose=jnp.ones(tables.relpose.capacity, dtype=dtype),
        ltm=jnp.ones(tables.ltm.capacity, dtype=dtype),
    )


class HuberParams(NamedTuple):
    """Loss scale per family (config residual params; base7a values)."""

    reproj: float = 1.0
    bbox: float = 0.5
    shape: float = 10.0
    relpose: float = 1.0
    ltm: float = 1.0
    invalid_ellipse_error: float = 1e6


class SchurPlan(NamedTuple):
    """Host-precomputed sparsity plan. All arrays padded; masks mark live rows.

    "Pairs" are unique (pose, landmark) combinations with at least one factor;
    "cross" rows enumerate ordered pairs (a, b) of pair-rows sharing a
    landmark — each contributes the -W_a Hll^-1 W_b^T block of the Schur
    complement at S[pose_a, pose_b].
    """

    # Feature points (from reprojection factors).
    rp_factor_pair: jnp.ndarray  # (F,) factor row -> point-pair row
    pt_pair_pose: jnp.ndarray  # (Np,)
    pt_pair_point: jnp.ndarray  # (Np,)
    pt_pair_mask: jnp.ndarray  # (Np,)
    pt_cross_a: jnp.ndarray  # (Ncp,) sorted by destination segment
    pt_cross_b: jnp.ndarray  # (Ncp,)
    pt_cross_mask: jnp.ndarray  # (Ncp,)
    pt_cross_dest: jnp.ndarray  # (Ncp,) cross row -> destination row
    pt_dest_a: jnp.ndarray  # (Nd,) unique destination (pose_a, pose_b)
    pt_dest_b: jnp.ndarray  # (Nd,)
    pt_dest_mask: jnp.ndarray  # (Nd,)
    # Slot layout: pair rows regrouped per landmark — row l of the 2-D slot
    # grid lists the (pose, landmark_l) pairs of one OBSERVED landmark (the
    # landmark axis is compacted to observed landmarks + padding). Lets the
    # dense-Schur path build U with a one-hot contraction instead of an
    # element scatter (column order within U is free under the U U^T gram).
    pt_slot_gather: jnp.ndarray  # (Lp, Cp) -> point-pair row
    pt_slot_pose: jnp.ndarray  # (Lp, Cp)
    pt_slot_mask: jnp.ndarray  # (Lp, Cp)
    pt_slot_land: jnp.ndarray  # (Lp,) point index per slot row
    # Objects (from bounding-box factors).
    bb_factor_pair: jnp.ndarray  # (B,) factor row -> object-pair row
    ob_pair_pose: jnp.ndarray  # (No,)
    ob_pair_obj: jnp.ndarray  # (No,)
    ob_pair_mask: jnp.ndarray  # (No,)
    ob_cross_a: jnp.ndarray  # (Nco,)
    ob_cross_b: jnp.ndarray  # (Nco,)
    ob_cross_mask: jnp.ndarray  # (Nco,)
    ob_cross_dest: jnp.ndarray  # (Nco,)
    ob_dest_a: jnp.ndarray  # (Ndo,)
    ob_dest_b: jnp.ndarray  # (Ndo,)
    ob_dest_mask: jnp.ndarray  # (Ndo,)
    ob_slot_gather: jnp.ndarray  # (Lo, Co) -> object-pair row
    ob_slot_pose: jnp.ndarray  # (Lo, Co)
    ob_slot_mask: jnp.ndarray  # (Lo, Co)
    ob_slot_land: jnp.ndarray  # (Lo,) object index per slot row
    # Banded point-gram layout (present only when every observed point's
    # pose span fits a 2-tile local window, _band_layout): the pt_slot_*
    # arrays above are then ROW-REORDERED by 64-pose "home tile" into
    # ceil(P/64) groups of Lg rows each, and this (G, Lg, Cp) array holds
    # each slot's pose index RELATIVE to its group's first pose (in
    # [0, 128)). Feature tracks span a handful of consecutive frames, so
    # the Schur point subtraction only couples near-diagonal pose pairs —
    # the gram then runs as G batched (768, Lg*3, 768) grams instead of one
    # (6P, 3L, 6P): 4x fewer gram FLOPs at P=256, growing as (P/128)^2.
    # None -> dense gram (wide spans after loop closures, tiny windows).
    pt_band_local_pose: jnp.ndarray = None  # (G, Lg, Cp) or None
    # Banded relpose+pose-diagonal gram layout (same group structure):
    # "landmark" rows are relpose factors (2 slots: before-pose J_bᵀ,
    # after-pose J_aᵀ) followed by one single-slot row per pose for its
    # damped-diagonal Cholesky factor. Row r's slots gather into the
    # runtime concat [J_bᵀ (R rows), J_aᵀ (R), L_diag (P)]. Present only
    # when every live relpose factor's pose pair fits the 2-tile window
    # (consecutive-frame factors do; PGO loop closures fall back to the
    # dense v_rel gram).
    rel_band_gather: jnp.ndarray = None  # (L2, 2) -> stacked block row
    rel_band_mask: jnp.ndarray = None  # (L2, 2)
    rel_band_local_pose: jnp.ndarray = None  # (G, Lg2, 2)
    # Inverse of factor->pair when it is injective (the common case: each
    # (pose, landmark) is observed by exactly one factor). The W pair
    # blocks then assemble as a GATHER of the per-factor outer products
    # instead of a segment_sum (a scatter-add over ~24k 18-wide rows on the
    # 256-pose bench problem). None when
    # some pair has 2+ contributing factors (duplicate observations).
    pt_pair_factor: jnp.ndarray = None  # (Np,) factor row per pair, or None
    ob_pair_factor: jnp.ndarray = None  # (No,) or None


def _round_up(n, bucket=64):
    """Next capacity from the {2^k, 1.5*2^k} geometric grid (>= bucket).

    Plan capacities must bucket coarsely like the factor-table capacities:
    with linear 64-step rounding nearly every sliding window produced a fresh
    jit signature, recompiling the whole fused solver per frame. The 1.5*2^k
    midpoints bound padding waste at 33% (plain powers of two waste up to 2x
    on the pair tables, which carry most of the per-iteration work)."""
    n = max(int(n), bucket)
    p = 1 << (n - 1).bit_length()  # next power of two
    mid = p // 2 + p // 4  # 1.5 * previous power of two
    return mid if n <= mid else p


def _slot_layout(pair_block, pair_land, n_pairs, land_cap=None, cmax_cap=None):
    """Regroup pair rows by landmark into a (land, slot) grid.

    Returns (slot_gather, slot_pose, slot_mask, slot_land): the first three
    (L, C) — row l lists the pair-row indices of the l-th OBSERVED landmark
    (axis compacted + padded to L = land_cap), column count C padded to
    cmax_cap >= max pairs/landmark — plus the (L,) landmark index of each row.
    Dead slots carry gather=0 / pose=0 / mask=False; consumers must zero them
    via the mask (the dense-Schur one-hot does)."""
    pair_block = np.asarray(pair_block)[:n_pairs]
    pair_land = np.asarray(pair_land)[:n_pairs]
    if n_pairs:
        uniq_land, inv = np.unique(pair_land, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=len(uniq_land))
        c_max = int(counts.max())
        starts = np.zeros(len(uniq_land), dtype=np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        rows = inv[order]
        slot = np.arange(n_pairs, dtype=np.int64) - starts[rows]
        n_land = len(uniq_land)
    else:
        order = rows = slot = np.zeros(0, dtype=np.int64)
        c_max = 0
        n_land = 0
    land_cap = max(land_cap or 0, _round_up(n_land))
    cmax_cap = max(cmax_cap or 0, _round_up(c_max, bucket=4))
    gather = np.zeros((land_cap, cmax_cap), dtype=np.int32)
    pose = np.zeros((land_cap, cmax_cap), dtype=np.int32)
    mask = np.zeros((land_cap, cmax_cap), dtype=bool)
    land = np.zeros(land_cap, dtype=np.int32)
    gather[rows, slot] = order.astype(np.int32)
    pose[rows, slot] = pair_block[order].astype(np.int32)
    mask[rows, slot] = True
    land[:n_land] = uniq_land.astype(np.int32) if n_land else land[:0]
    return gather, pose, mask, land


# Poses per band group; each group's local pose window is 2*_BAND_TP wide,
# so a landmark fits iff max_pose < 64*(min_pose//64) + 128 (always true for
# feature tracks up to 65 consecutive frames; loop-closure re-observations
# fall back to the dense gram).
_BAND_TP = 64


def _band_layout(slot_gather, slot_pose, slot_mask, slot_land, n_pose,
                 lg_cap=None):
    """Regroup slot-grid rows by 64-pose home tile for the banded gram.

    Returns None when banding does not apply (pose count too small to
    benefit, no live rows, or some live landmark's pose span exceeds the
    2-tile window); otherwise (gather, pose, mask, land, local_pose) — the
    reordered slot grid (rows of group g occupy [g*Lg, g*Lg+count_g)) plus
    the (G, Lg, C) per-slot LOCAL pose array whose shape carries (G, Lg).

    Reordering the slot rows is free for every consumer: the row order of
    the slot grid is arbitrary (column order under the gram is free, and
    RHS/backsub address landmarks through slot_land)."""
    if n_pose is None or n_pose < 3 * _BAND_TP:
        return None
    slot_pose = np.asarray(slot_pose)
    slot_mask = np.asarray(slot_mask)
    live_row = slot_mask.any(axis=1)
    if not live_row.any():
        return None
    min_p = np.where(slot_mask, slot_pose, np.iinfo(np.int32).max).min(axis=1)
    max_p = np.where(slot_mask, slot_pose, -1).max(axis=1)
    n_group = -(-int(n_pose) // _BAND_TP)
    home = np.clip(
        np.where(live_row, min_p // _BAND_TP, 0), 0, n_group - 1
    ).astype(np.int64)
    if np.any(live_row & (max_p - home * _BAND_TP >= 2 * _BAND_TP)):
        return None
    counts = np.bincount(home[live_row], minlength=n_group)
    # Lg buckets at 128-row steps, NOT the coarse {2^k, 1.5*2^k} capacity
    # grid: the group gram's contraction depth is 3*Lg, so geometric
    # bucketing wasted up to 33% of the dominant gram phase (bench problem:
    # max group 1276 -> Lg 1536, 17% padding). 128-step rounding keeps
    # 3*Lg a multiple of 384 with <10% padding; jit
    # signature stability in pipeline code still comes from the session
    # high-water lg_cap, exactly as before.
    lg = max(lg_cap or 0, -(-int(counts.max()) // 128) * 128)
    L, C = slot_mask.shape
    rows = np.nonzero(live_row)[0]
    order = rows[np.argsort(home[rows], kind="stable")]
    within = np.arange(len(order)) - np.concatenate(
        ([0], np.cumsum(counts)[:-1])
    )[home[order]]
    dest = home[order] * lg + within
    gather = np.zeros((n_group * lg, C), dtype=np.int32)
    pose = np.zeros((n_group * lg, C), dtype=np.int32)
    mask = np.zeros((n_group * lg, C), dtype=bool)
    land = np.zeros(n_group * lg, dtype=np.int32)
    local = np.zeros((n_group * lg, C), dtype=np.int32)
    gather[dest] = np.asarray(slot_gather)[order]
    pose[dest] = slot_pose[order]
    mask[dest] = slot_mask[order]
    land[dest] = np.asarray(slot_land)[order]
    local[dest] = np.where(
        slot_mask[order],
        slot_pose[order] - (home[order] * _BAND_TP)[:, None],
        0,
    )
    return gather, pose, mask, land, local.reshape(n_group, lg, C)


def _rel_band_layout(rl_before, rl_after, rl_cap, n_pose, lg_cap=None):
    """Band layout for the relpose + pose-diagonal gram (see SchurPlan
    docstring): rows = rl_cap relpose factors (2 slots gathering J_bᵀ at
    index k and J_aᵀ at rl_cap + k of the runtime block stack) + one
    single-slot diagonal row per pose (gathering 2*rl_cap + p). Returns
    (gather, mask, local_pose) or None when banding does not apply."""
    if n_pose is None or n_pose < 3 * _BAND_TP:
        return None
    rl_before = np.asarray(rl_before, dtype=np.int64)
    rl_after = np.asarray(rl_after, dtype=np.int64)
    n_live = len(rl_before)
    n_rows = rl_cap + n_pose
    gather = np.zeros((n_rows, 2), np.int32)
    pose = np.zeros((n_rows, 2), np.int32)
    mask = np.zeros((n_rows, 2), bool)
    gather[:rl_cap, 0] = np.arange(rl_cap)
    gather[:rl_cap, 1] = rl_cap + np.arange(rl_cap)
    pose[:n_live, 0] = rl_before
    pose[:n_live, 1] = rl_after
    mask[:n_live, :] = True
    gather[rl_cap:, 0] = 2 * rl_cap + np.arange(n_pose)
    pose[rl_cap:, 0] = np.arange(n_pose)
    mask[rl_cap:, 0] = True
    out = _band_layout(
        gather, pose, mask, np.zeros(n_rows, np.int32), n_pose, lg_cap
    )
    if out is None:
        return None
    g2, _, m2, _, local = out
    return g2, m2, local


def _build_pairs(
    block_idx, land_idx, mask, pair_cap=None, cross_cap=None,
    land_cap=None, cmax_cap=None, dest_cap=None,
):
    """Unique (pose, landmark) pairs and the per-landmark ordered cross pairs.

    Uses the native C++ builder (obvi_slam_tpu/native) when built — identical
    outputs, ~10x faster on large windows — with this numpy path as fallback."""
    from obvi_slam_tpu import native as native_mod

    native = native_mod.build_pair_plan_native(block_idx, land_idx, mask)
    if native is not None:
        (
            factor_pair,
            pair_block,
            pair_land,
            cross_a,
            cross_b,
            cross_dest,
            dest_a,
            dest_b,
        ) = native
        n_pairs = len(pair_block)
        n_dest = len(dest_a)
        # Pinned caps are MINIMUMS (callers pass session high-water marks for
        # jit-signature stability); actual needs always win.
        pair_cap = max(pair_cap or 0, _round_up(n_pairs))
        cross_cap = max(cross_cap or 0, _round_up(len(cross_a)))
        dest_cap = max(dest_cap or 0, _round_up(n_dest))

        def pad_i(x, cap, fill=0):
            out = np.full(cap, fill, dtype=np.int32)
            out[: len(x)] = x
            return out

        pair_mask = np.zeros(pair_cap, dtype=bool)
        pair_mask[:n_pairs] = True
        cross_mask = np.zeros(cross_cap, dtype=bool)
        cross_mask[: len(cross_a)] = True
        dest_mask = np.zeros(dest_cap, dtype=bool)
        dest_mask[:n_dest] = True
        return (
            factor_pair,
            pad_i(pair_block, pair_cap),
            pad_i(pair_land, pair_cap),
            pair_mask,
            pad_i(cross_a, cross_cap),
            pad_i(cross_b, cross_cap),
            cross_mask,
            pad_i(cross_dest, cross_cap, fill=min(n_dest, dest_cap - 1)),
            pad_i(dest_a, dest_cap),
            pad_i(dest_b, dest_cap),
            dest_mask,
        ) + _slot_layout(pair_block, pair_land, n_pairs, land_cap, cmax_cap)

    live = np.nonzero(mask)[0]
    keys = np.stack([block_idx[live], land_idx[live]], axis=1)
    if len(live) == 0:
        uniq = np.zeros((0, 2), dtype=np.int64)
        inv = np.zeros((0,), dtype=np.int64)
    else:
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    n_pairs = len(uniq)
    factor_pair = np.zeros(len(block_idx), dtype=np.int32)
    factor_pair[live] = inv.astype(np.int32)

    # Ordered cross pairs per landmark.
    cross_a, cross_b = [], []
    if n_pairs:
        order = np.argsort(uniq[:, 1], kind="stable")
        sorted_land = uniq[order, 1]
        boundaries = np.nonzero(np.diff(sorted_land))[0] + 1
        groups = np.split(order, boundaries)
        for g in groups:
            # all ordered pairs within the landmark's observing-pose set
            a, b = np.meshgrid(g, g, indexing="ij")
            cross_a.append(a.ravel())
            cross_b.append(b.ravel())
    cross_a = np.concatenate(cross_a) if cross_a else np.zeros(0, dtype=np.int64)
    cross_b = np.concatenate(cross_b) if cross_b else np.zeros(0, dtype=np.int64)

    # Destination dedup: many cross rows target the same (pose_a, pose_b)
    # block of S (every shared landmark of a pose pair). Group them so the
    # device combines with a SORTED segment_sum and scatters only unique
    # destinations (conflict-free-ish) instead of 10-100x more rows.
    if n_pairs and len(cross_a):
        dest_keys = np.stack(
            [uniq[cross_a, 0].astype(np.int64), uniq[cross_b, 0].astype(np.int64)],
            axis=1,
        )
        dest_uniq, dest_inv = np.unique(dest_keys, axis=0, return_inverse=True)
        order = np.argsort(dest_inv, kind="stable")
        cross_a = cross_a[order]
        cross_b = cross_b[order]
        cross_dest = dest_inv[order]
    else:
        dest_uniq = np.zeros((0, 2), dtype=np.int64)
        cross_dest = np.zeros(0, dtype=np.int64)
    n_dest = len(dest_uniq)

    pair_cap = max(pair_cap or 0, _round_up(n_pairs))
    cross_cap = max(cross_cap or 0, _round_up(len(cross_a)))
    dest_cap = max(dest_cap or 0, _round_up(n_dest))

    def pad_i(x, cap, fill=0):
        out = np.full(cap, fill, dtype=np.int32)
        out[: len(x)] = x
        return out

    pair_mask = np.zeros(pair_cap, dtype=bool)
    pair_mask[:n_pairs] = True
    cross_mask = np.zeros(cross_cap, dtype=bool)
    cross_mask[: len(cross_a)] = True
    dest_mask = np.zeros(dest_cap, dtype=bool)
    dest_mask[:n_dest] = True
    # Padding cross rows point at a padding destination (n_dest) so they
    # never contaminate a live destination; padding dest rows scatter a zero
    # block at (0, 0) which is harmless.
    cross_dest_padded = pad_i(cross_dest, cross_cap, fill=min(n_dest, dest_cap - 1))
    return (
        factor_pair,
        pad_i(uniq[:, 0] if n_pairs else [], pair_cap),
        pad_i(uniq[:, 1] if n_pairs else [], pair_cap),
        pair_mask,
        pad_i(cross_a, cross_cap),
        pad_i(cross_b, cross_cap),
        cross_mask,
        cross_dest_padded,
        pad_i(dest_uniq[:, 0] if n_dest else [], dest_cap),
        pad_i(dest_uniq[:, 1] if n_dest else [], dest_cap),
        dest_mask,
    ) + _slot_layout(
        uniq[:, 0] if n_pairs else np.zeros(0, np.int64),
        uniq[:, 1] if n_pairs else np.zeros(0, np.int64),
        n_pairs,
        land_cap,
        cmax_cap,
    )


def build_schur_plan_host(
    rp_pose, rp_point, rp_cap, bb_pose, bb_obj, bb_cap, caps=None,
    n_pose=None, rl_before=None, rl_after=None, rl_cap=0,
) -> SchurPlan:
    """Plan construction from HOST (numpy/list) index arrays.

    Prefer this over ``build_schur_plan`` in pipeline code: reading index
    columns back off a device table costs a device->host transfer per plan
    build.

    ``rp_pose``/``rp_point``: live reprojection (pose, point) rows;
    ``rp_cap``: the reprojection table capacity (same for bb_*)."""

    def padded(vals, cap):
        out = np.zeros(cap, dtype=np.int32)
        out[: len(vals)] = np.asarray(vals, dtype=np.int32)
        mask = np.zeros(cap, dtype=bool)
        mask[: len(vals)] = True
        return out, mask

    rp_pose_a, rp_mask = padded(rp_pose, rp_cap)
    rp_point_a, _ = padded(rp_point, rp_cap)
    bb_pose_a, bb_mask = padded(bb_pose, bb_cap)
    bb_obj_a, _ = padded(bb_obj, bb_cap)

    class _HostTable:
        def __init__(self, pose_idx, land_idx, mask):
            self.pose_idx = pose_idx
            self.mask = mask
            self.point_idx = land_idx
            self.obj_idx = land_idx

    class _HostTables:
        pass

    t = _HostTables()
    t.reproj = _HostTable(rp_pose_a, rp_point_a, rp_mask)
    t.bbox = _HostTable(bb_pose_a, bb_obj_a, bb_mask)
    return build_schur_plan(
        t, caps, n_pose=n_pose, rl_before=rl_before, rl_after=rl_after,
        rl_cap=rl_cap,
    )


def _pair_factor_gather(factor_pair, factor_mask, pair_cap):
    """Inverse of the factor->pair map when injective: (pair_cap,) int32
    factor row per pair row (0 for padding, masked downstream), or None when
    any pair has 2+ contributing factors (then the segment_sum path runs)."""
    live = np.nonzero(np.asarray(factor_mask))[0]
    fp = np.asarray(factor_pair)[live]
    if len(fp) and len(np.unique(fp)) != len(fp):
        return None
    out = np.zeros(pair_cap, dtype=np.int32)
    out[fp] = live.astype(np.int32)
    return out


def build_schur_plan(
    tables: FactorTables, caps=None, n_pose=None,
    rl_before=None, rl_after=None, rl_cap=0,
) -> SchurPlan:
    """Host-side plan construction from (numpy views of) the factor tables.

    NOTE: if the tables hold device arrays this reads the index columns back
    to host — use ``build_schur_plan_host`` in pipeline code.

    ``caps``: optional dict with keys pt_pair/pt_cross/ob_pair/ob_cross to pin
    capacities (for jit-signature bucketing)."""
    caps = caps or {}
    rp = tables.reproj
    (
        rp_factor_pair,
        pt_pair_pose,
        pt_pair_point,
        pt_pair_mask,
        pt_cross_a,
        pt_cross_b,
        pt_cross_mask,
        pt_cross_dest,
        pt_dest_a,
        pt_dest_b,
        pt_dest_mask,
        pt_slot_gather,
        pt_slot_pose,
        pt_slot_mask,
        pt_slot_land,
    ) = _build_pairs(
        np.asarray(rp.pose_idx),
        np.asarray(rp.point_idx),
        np.asarray(rp.mask),
        caps.get("pt_pair"),
        caps.get("pt_cross"),
        caps.get("pt_slot_land"),
        caps.get("pt_slot_c"),
        caps.get("pt_dest"),
    )
    bb = tables.bbox
    (
        bb_factor_pair,
        ob_pair_pose,
        ob_pair_obj,
        ob_pair_mask,
        ob_cross_a,
        ob_cross_b,
        ob_cross_mask,
        ob_cross_dest,
        ob_dest_a,
        ob_dest_b,
        ob_dest_mask,
        ob_slot_gather,
        ob_slot_pose,
        ob_slot_mask,
        ob_slot_land,
    ) = _build_pairs(
        np.asarray(bb.pose_idx),
        np.asarray(bb.obj_idx),
        np.asarray(bb.mask),
        caps.get("ob_pair"),
        caps.get("ob_cross"),
        caps.get("ob_slot_land"),
        caps.get("ob_slot_c"),
        caps.get("ob_dest"),
    )
    pt_band_local_pose = None
    band = _band_layout(
        pt_slot_gather, pt_slot_pose, pt_slot_mask, pt_slot_land,
        n_pose, caps.get("pt_band_lg"),
    )
    if band is not None:
        (
            pt_slot_gather,
            pt_slot_pose,
            pt_slot_mask,
            pt_slot_land,
            pt_band_local_pose,
        ) = band
        pt_band_local_pose = _t_asarray(pt_band_local_pose)
    rel_band_gather = rel_band_mask = rel_band_local_pose = None
    if rl_before is not None and rl_cap:
        rel_band = _rel_band_layout(
            rl_before, rl_after, int(rl_cap), n_pose,
            caps.get("rel_band_lg"),
        )
        if rel_band is not None:
            rel_band_gather = _t_asarray(rel_band[0])
            rel_band_mask = _t_asarray(rel_band[1])
            rel_band_local_pose = _t_asarray(rel_band[2])
    pt_pair_factor = _pair_factor_gather(
        rp_factor_pair, rp.mask, len(pt_pair_pose)
    )
    ob_pair_factor = _pair_factor_gather(
        bb_factor_pair, bb.mask, len(ob_pair_pose)
    )
    return SchurPlan(
        pt_band_local_pose=pt_band_local_pose,
        rel_band_gather=rel_band_gather,
        rel_band_mask=rel_band_mask,
        rel_band_local_pose=rel_band_local_pose,
        pt_pair_factor=(
            None if pt_pair_factor is None else _t_asarray(pt_pair_factor)
        ),
        ob_pair_factor=(
            None if ob_pair_factor is None else _t_asarray(ob_pair_factor)
        ),
        rp_factor_pair=_t_asarray(rp_factor_pair),
        pt_pair_pose=_t_asarray(pt_pair_pose),
        pt_pair_point=_t_asarray(pt_pair_point),
        pt_pair_mask=_t_asarray(pt_pair_mask),
        pt_cross_a=_t_asarray(pt_cross_a),
        pt_cross_b=_t_asarray(pt_cross_b),
        pt_cross_mask=_t_asarray(pt_cross_mask),
        pt_cross_dest=_t_asarray(pt_cross_dest),
        pt_dest_a=_t_asarray(pt_dest_a),
        pt_dest_b=_t_asarray(pt_dest_b),
        pt_dest_mask=_t_asarray(pt_dest_mask),
        pt_slot_gather=_t_asarray(pt_slot_gather),
        pt_slot_pose=_t_asarray(pt_slot_pose),
        pt_slot_mask=_t_asarray(pt_slot_mask),
        pt_slot_land=_t_asarray(pt_slot_land),
        bb_factor_pair=_t_asarray(bb_factor_pair),
        ob_pair_pose=_t_asarray(ob_pair_pose),
        ob_pair_obj=_t_asarray(ob_pair_obj),
        ob_pair_mask=_t_asarray(ob_pair_mask),
        ob_cross_a=_t_asarray(ob_cross_a),
        ob_cross_b=_t_asarray(ob_cross_b),
        ob_cross_mask=_t_asarray(ob_cross_mask),
        ob_cross_dest=_t_asarray(ob_cross_dest),
        ob_dest_a=_t_asarray(ob_dest_a),
        ob_dest_b=_t_asarray(ob_dest_b),
        ob_dest_mask=_t_asarray(ob_dest_mask),
        ob_slot_gather=_t_asarray(ob_slot_gather),
        ob_slot_pose=_t_asarray(ob_slot_pose),
        ob_slot_mask=_t_asarray(ob_slot_mask),
        ob_slot_land=_t_asarray(ob_slot_land),
    )


# ---------------------------------------------------------------------------
# Assembly + solve (fully on device, jit-able).
# ---------------------------------------------------------------------------

# Ceres LevenbergMarquardtStrategy diagonal clamping.
_MIN_DIAG = 1e-6
_MAX_DIAG = 1e32

# Precision of the Schur grams (contraction dim 3*landmarks — the largest
# accumulation in the solver). HIGHEST keeps full float32 products: on the
# GPU a float32 dot at DEFAULT precision may run in TF32 (~10 mantissa bits),
# which the damped normal equations amplify into step errors far above the
# f32-vs-f64 bound tests/test_f32_precision checks.
_GRAM_PRECISION = jax.lax.Precision.HIGHEST


# Block-tridiagonal + Woodbury reduced solve: "auto" engages it on banded
# problems with >= OBVI_BAND_SOLVE_MIN_POSES poses (where the dense O(P^3)
# Cholesky dominates); "on"/"off" force (structure permitting — see
# band_solve_on in compute_step).
_BAND_SOLVE = os.environ.get("OBVI_BAND_SOLVE", "auto")
_BAND_SOLVE_MIN_POSES = int(os.environ.get("OBVI_BAND_SOLVE_MIN_POSES", "512"))


def _use_band_solve(n_pose) -> bool:
    if _BAND_SOLVE == "off":
        return False
    if _BAND_SOLVE == "on":
        return True
    return n_pose is not None and n_pose >= _BAND_SOLVE_MIN_POSES


def band_engagement(plan, n_pose):
    """(band layout, block-tridiagonal + Woodbury solve): the plan-level
    conditions compute_step checks before it takes each banded path."""
    layout = (plan.pt_band_local_pose is not None
              and plan.rel_band_local_pose is not None)
    return layout, layout and _use_band_solve(n_pose)


# Trajectory-domain decomposition of the band solve on a device mesh
# (band_solve.dd_woodbury_band_solve): "auto" = one contiguous tile range
# per mesh device when the tile count divides; "off" forces the replicated
# CR path.
_BAND_DD = os.environ.get("OBVI_BAND_DD", "auto")


def _dd_domains(shard_mesh, nb: int) -> int:
    """Domain count for the decomposed band solve: the largest power-of-two
    h <= mesh size dividing nb with >= 2 tiles per domain; 1 = replicated."""
    if _BAND_DD == "off" or shard_mesh is None:
        return 1
    h = int(shard_mesh.devices.size)
    while h > 1 and (nb % h != 0 or nb // h < 2):
        h //= 2
    return max(h, 1)


# Small block einsums (W G, G^T b, per-factor outer products) must never run
# in TF32 — they carry solver values.
_P_HI = jax.lax.Precision.HIGHEST



def _outer_rr(a, b):
    """(F, r, i), (F, r, j) -> (F, i, j) = sum_r a b, as elementwise math
    (see geometry.bmv: tiny-contraction einsums otherwise become batched
    matrix products)."""
    return (a[:, :, :, None] * b[:, :, None, :]).sum(1)


def _jtr(j, r):
    """(F, r, i), (F, r) -> (F, i) = J^T r per factor, elementwise."""
    return (j * r[:, :, None]).sum(1)


def _cholesky_unrolled(a, n):
    """Batched Cholesky of SPD (B, n, n) blocks as fully unrolled component
    math (statically unrolled over n).

    Pure elementwise ops that fuse into one kernel, instead of the
    batched-solver custom calls jnp.linalg.inv/cholesky lower to, which
    cost a launch each for thousands of tiny blocks. Inputs here are damped
    information blocks, SPD by construction."""
    col = [[None] * n for _ in range(n)]
    for j in range(n):
        d = a[:, j, j]
        for k in range(j):
            d = d - col[j][k] * col[j][k]
        ljj = jnp.sqrt(jnp.maximum(d, 1e-30))
        col[j][j] = ljj
        for i in range(j + 1, n):
            s = a[:, i, j]
            for k in range(j):
                s = s - col[i][k] * col[j][k]
            col[i][j] = s / ljj
    z = jnp.zeros_like(a[:, 0, 0])
    rows = [
        jnp.stack([col[i][j] if j <= i else z for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def _tril_inverse_unrolled(l, n):
    """Batched inverse of lower-triangular (B, n, n) blocks by unrolled
    forward substitution (columns of the identity)."""
    inv = [[None] * n for _ in range(n)]
    for j in range(n):
        for i in range(n):
            if i < j:
                inv[i][j] = jnp.zeros_like(l[:, 0, 0])
            elif i == j:
                inv[i][j] = 1.0 / l[:, i, i]
            else:
                s = jnp.zeros_like(l[:, 0, 0])
                for k in range(j, i):
                    s = s + l[:, i, k] * inv[k][j]
                inv[i][j] = -s / l[:, i, i]
    rows = [jnp.stack(inv[i], axis=-1) for i in range(n)]
    return jnp.stack(rows, axis=-2)


def _spd_inverse_and_factor(a, n):
    """Batched SPD inverse of (B, n, n) blocks plus the factor G with
    A^-1 = G G^T (G = L^-T from A = L L^T). Unrolled component math."""
    l = _cholesky_unrolled(a, n)
    l_inv = _tril_inverse_unrolled(l, n)
    g = jnp.swapaxes(l_inv, -1, -2)
    a_inv = (g[:, :, None, :] * g[:, None, :, :]).sum(-1)
    return a_inv, g


def _block_weight(r, delta, ext_weight, mask):
    """sqrt(rho') * external weight * mask — row scale for r and J."""
    s = jnp.sum(r * r, axis=-1)
    w = fac.huber_sqrt_weight(s, delta)
    return w * ext_weight * mask


def _weighted(r, j_list, w):
    rw = r * w[:, None]
    jw = [j * w[:, None, None] for j in j_list]
    return rw, jw


@fac.highest_matmul
def compute_step(
    state: BAState,
    cams: CameraBundle,
    tables: FactorTables,
    plan: SchurPlan,
    free: FreeMasks,
    weights: FactorWeights,
    radius,
    huber: HuberParams = HuberParams(),
    dense_schur: bool = None,
    _profile_stop: str = None,
    shard_mesh=None,
    shard_axis: str = "factors",
):
    """One damped Gauss-Newton (LM) step.

    Returns (delta_state: BAState, model_cost_change, grad_max).
    The trust-region radius enters as Ceres' LM damping
    H + diag(clamp(diag(H))) / radius.

    ``dense_schur``: materialize U = (6P, 3M) block-sparse pose-point coupling
    densely and compute the Schur subtraction as ONE matrix product
    (U Hll^-1) U^T instead of enumerating per-landmark pose pairs. Wins
    whenever U fits comfortably in HBM; auto-enabled below ~256M elements.

    ``_profile_stop``: profiling hook for per-phase timing. When set to one of "resjac"/"hb"/"w"/"sassembly"/"rhs"/"chol",
    returns early with a scalar that sums every intermediate live at that
    point (so XLA cannot dead-code-eliminate the work). Production callers
    leave it None; jit specializes on the static string, so the hook costs
    nothing when unset.
    """

    def _profile_exit(*xs):
        return sum(jnp.sum(x) for x in xs)

    dtype = state.poses.dtype
    n_pose = state.poses.shape[0]
    n_point = state.points.shape[0]
    n_obj = state.objects.shape[0]

    pose_free = free.poses.astype(dtype)
    point_free = free.points.astype(dtype)
    obj_free = free.objects.astype(dtype)

    # ---- residuals + jacobians, robustified ------------------------------
    r_rp, j_rp_pose, j_rp_point = reproj_residuals_and_jac_fast(
        state, cams, tables.reproj
    )
    w_rp = _block_weight(
        r_rp, huber.reproj, weights.reproj, tables.reproj.mask.astype(dtype)
    )
    r_rp, (j_rp_pose, j_rp_point) = _weighted(r_rp, [j_rp_pose, j_rp_point], w_rp)
    j_rp_pose = j_rp_pose * pose_free[tables.reproj.pose_idx][:, None, None]
    j_rp_point = j_rp_point * point_free[tables.reproj.point_idx][:, None, None]

    r_bb, j_bb_obj, j_bb_pose = fac.bbox_residuals_and_jac(
        state, cams, tables.bbox, huber.invalid_ellipse_error
    )
    w_bb = _block_weight(r_bb, huber.bbox, weights.bbox, tables.bbox.mask.astype(dtype))
    r_bb, (j_bb_obj, j_bb_pose) = _weighted(r_bb, [j_bb_obj, j_bb_pose], w_bb)
    j_bb_obj = j_bb_obj * obj_free[tables.bbox.obj_idx][:, None, None]
    j_bb_pose = j_bb_pose * pose_free[tables.bbox.pose_idx][:, None, None]

    r_sh, j_sh = fac.shape_residuals_and_jac(state, tables.shape)
    w_sh = _block_weight(
        r_sh, huber.shape, weights.shape, tables.shape.mask.astype(dtype)
    )
    r_sh, (j_sh,) = _weighted(r_sh, [j_sh], w_sh)
    j_sh = j_sh * obj_free[tables.shape.obj_idx][:, None, None]

    r_rl, j_rl_b, j_rl_a = fac.relpose_residuals_and_jac(state, tables.relpose)
    w_rl = _block_weight(
        r_rl, huber.relpose, weights.relpose, tables.relpose.mask.astype(dtype)
    )
    r_rl, (j_rl_b, j_rl_a) = _weighted(r_rl, [j_rl_b, j_rl_a], w_rl)
    j_rl_b = j_rl_b * pose_free[tables.relpose.before_idx][:, None, None]
    j_rl_a = j_rl_a * pose_free[tables.relpose.after_idx][:, None, None]

    r_lt, j_lt = fac.ltm_residuals_and_jac(state, tables.ltm)
    w_lt = _block_weight(
        r_lt, huber.ltm, weights.ltm, tables.ltm.mask.astype(dtype)
    )
    r_lt, (j_lt,) = _weighted(r_lt, [j_lt], w_lt)
    j_lt = j_lt * obj_free[tables.ltm.obj_idx][:, None, None]

    # Scalar param priors (no Huber in reference).
    pp = tables.param_prior
    r_pp = fac.param_prior_residuals(state, pp)

    if _profile_stop == "resjac":
        return _profile_exit(
            r_rp, j_rp_pose, j_rp_point, r_bb, j_bb_obj, j_bb_pose,
            r_sh, j_sh, r_rl, j_rl_b, j_rl_a, r_lt, j_lt, r_pp,
        )

    # ---- landmark blocks -------------------------------------------------
    # H_ll (M,3,3) and b_l (M,3) packed into ONE segment_sum (12 components)
    # to amortize the gather/scatter launch over a lane-friendly layout.
    ll_pack = jnp.concatenate(
        [
            _outer_rr(j_rp_point, j_rp_point).reshape(-1, 9),
            -_jtr(j_rp_point, r_rp),
        ],
        axis=1,
    )
    ll_out = jax.ops.segment_sum(
        ll_pack, tables.reproj.point_idx, num_segments=n_point
    )
    h_ll = ll_out[:, :9].reshape(n_point, 3, 3)
    b_l = ll_out[:, 9:12]
    def _hb_pack(j, r, d):
        """[J^T J (d*d) | -J^T r (d)] flattened per factor — keeps every
        segment_sum 2-D with a lane-sized trailing dim (a (F, d, d) layout
        puts d in the lane dimension and pads it up to 128)."""
        h = _outer_rr(j, j).reshape(j.shape[0], d * d)
        b = -_jtr(j, r)
        return jnp.concatenate([h, b], axis=1)

    # H_oo (K,7,7), b_o from bbox + shape + ltm (+ object param priors below).
    oo_out = jax.ops.segment_sum(
        _hb_pack(j_bb_obj, r_bb, 7), tables.bbox.obj_idx, num_segments=n_obj
    )
    oo_out += jax.ops.segment_sum(
        _hb_pack(j_sh, r_sh, 7), tables.shape.obj_idx, num_segments=n_obj
    )
    oo_out += jax.ops.segment_sum(
        _hb_pack(j_lt, r_lt, 7), tables.ltm.obj_idx, num_segments=n_obj
    )
    h_oo = oo_out[:, :49].reshape(n_obj, 7, 7)
    b_o = oo_out[:, 49:56]

    # ---- pose blocks -----------------------------------------------------
    pp_out = jax.ops.segment_sum(
        _hb_pack(j_rp_pose, r_rp, 6), tables.reproj.pose_idx, num_segments=n_pose
    )
    pp_out += jax.ops.segment_sum(
        _hb_pack(j_bb_pose, r_bb, 6), tables.bbox.pose_idx, num_segments=n_pose
    )
    # Relpose H/b kept separate: the dense-S path carries the relpose factor
    # contribution (diag + cross) through a V V^T gram matmul instead, so it
    # needs h_pp WITHOUT the relpose diagonal (b_p and damping use the total).
    pp_rel_out = jax.ops.segment_sum(
        _hb_pack(j_rl_b, r_rl, 6), tables.relpose.before_idx, num_segments=n_pose
    )
    pp_rel_out += jax.ops.segment_sum(
        _hb_pack(j_rl_a, r_rl, 6), tables.relpose.after_idx, num_segments=n_pose
    )
    pp_out += pp_rel_out
    h_pp = pp_out[:, :36].reshape(n_pose, 6, 6)
    h_pp_rel = pp_rel_out[:, :36].reshape(n_pose, 6, 6)
    b_p = pp_out[:, 36:42]

    # ---- scalar param priors into diagonals ------------------------------
    pp_live = pp.mask.astype(dtype)
    pp_w2 = (pp.inv_std * pp.inv_std) * pp_live
    is_pose = (pp.block_kind == 0).astype(dtype) * pose_free[
        jnp.clip(pp.block_idx, 0, n_pose - 1)
    ]
    is_point = (pp.block_kind == 1).astype(dtype) * point_free[
        jnp.clip(pp.block_idx, 0, n_point - 1)
    ]
    is_obj = (pp.block_kind == 2).astype(dtype) * obj_free[
        jnp.clip(pp.block_idx, 0, n_obj - 1)
    ]
    pose_pi = jnp.clip(pp.param_idx, 0, 5)
    point_pi = jnp.clip(pp.param_idx, 0, 2)
    obj_pi = jnp.clip(pp.param_idx, 0, 6)
    grad_pp = pp.inv_std * r_pp * pp_live

    # One-hot matmul accumulation instead of scatter-add: the prior table is
    # tiny (rank-repair priors only); a (cap, size) one-hot contraction
    # fuses with its neighbours where a scatter into the H blocks would not.
    def _prior_accum(block, dim, size, values):
        flat = jnp.clip(pp.block_idx, 0, block - 1) * dim + jnp.clip(
            pp.param_idx, 0, dim - 1
        )
        oh = jax.nn.one_hot(flat, size, dtype=dtype)
        return jnp.einsum("c,cs->s", values, oh)

    def _diag_add(h, vec, n, dim):
        return h + vec.reshape(n, dim)[:, :, None] * jnp.eye(dim, dtype=dtype)

    h_pp = _diag_add(
        h_pp, _prior_accum(n_pose, 6, n_pose * 6, pp_w2 * is_pose), n_pose, 6
    )
    h_ll = _diag_add(
        h_ll, _prior_accum(n_point, 3, n_point * 3, pp_w2 * is_point), n_point, 3
    )
    h_oo = _diag_add(
        h_oo, _prior_accum(n_obj, 7, n_obj * 7, pp_w2 * is_obj), n_obj, 7
    )
    b_p = b_p + _prior_accum(n_pose, 6, n_pose * 6, -grad_pp * is_pose).reshape(
        n_pose, 6
    )
    b_l = b_l + _prior_accum(n_point, 3, n_point * 3, -grad_pp * is_point).reshape(
        n_point, 3
    )
    b_o = b_o + _prior_accum(n_obj, 7, n_obj * 7, -grad_pp * is_obj).reshape(
        n_obj, 7
    )

    # ---- gradient max (for Ceres gradient_tolerance check) ---------------
    grad_max = jnp.maximum(
        jnp.max(jnp.abs(b_p)), jnp.maximum(jnp.max(jnp.abs(b_l)), jnp.max(jnp.abs(b_o)))
    )

    # ---- LM damping: H += diag(clamp(diag(H))) / radius ------------------
    inv_radius = 1.0 / radius

    def damp(h):
        d = jnp.clip(
            jnp.diagonal(h, axis1=-2, axis2=-1), _MIN_DIAG, _MAX_DIAG
        )
        n = h.shape[-1]
        return h + (d * inv_radius)[..., :, None] * jnp.eye(n, dtype=dtype)

    h_ll_d = damp(h_ll)
    h_oo_d = damp(h_oo)
    h_pp_d = damp(h_pp)

    # Guard: fixed/unobserved landmark blocks -> identity (delta stays 0
    # because their b is 0 and W rows are 0).
    eye3 = jnp.eye(3, dtype=dtype)
    eye7 = jnp.eye(7, dtype=dtype)
    ll_singular = jnp.abs(jnp.diagonal(h_ll, axis1=-2, axis2=-1)).sum(-1) < 1e-12
    oo_singular = jnp.abs(jnp.diagonal(h_oo, axis1=-2, axis2=-1)).sum(-1) < 1e-12
    h_ll_d = jnp.where(ll_singular[:, None, None], eye3, h_ll_d)
    h_oo_d = jnp.where(oo_singular[:, None, None], eye7, h_oo_d)
    h_ll_inv, g_ll = _spd_inverse_and_factor(h_ll_d, 3)
    h_oo_inv, g_oo = _spd_inverse_and_factor(h_oo_d, 7)

    if _profile_stop == "hb":
        return _profile_exit(
            h_pp_d, h_ll_inv, g_ll, h_oo_inv, g_oo, b_p, b_l, b_o, grad_max,
        )

    # ---- W pair blocks ---------------------------------------------------
    # Gather path when factor->pair is injective (pt_pair_factor docstring);
    # 2-D packed segment sums otherwise (_hb_pack note).
    n_pt_pair = plan.pt_pair_pose.shape[0]
    if plan.pt_pair_factor is not None:
        # Gather in the 2-D (F, 18) form: a (F, 6, 3) gather materializes
        # with the 3-wide minor dim padded to a full 128-lane tile.
        w_pt = (
            _outer_rr(j_rp_pose, j_rp_point)
            .reshape(-1, 18)[plan.pt_pair_factor]
            .reshape(n_pt_pair, 6, 3)
        )
    else:
        w_pt = jax.ops.segment_sum(
            _outer_rr(j_rp_pose, j_rp_point).reshape(-1, 18),
            plan.rp_factor_pair,
            num_segments=n_pt_pair,
        ).reshape(n_pt_pair, 6, 3)
    w_pt = w_pt * plan.pt_pair_mask[:, None, None].astype(dtype)
    n_ob_pair = plan.ob_pair_pose.shape[0]
    if plan.ob_pair_factor is not None:
        w_ob = (
            _outer_rr(j_bb_pose, j_bb_obj)
            .reshape(-1, 42)[plan.ob_pair_factor]
            .reshape(n_ob_pair, 6, 7)
        )
    else:
        w_ob = jax.ops.segment_sum(
            _outer_rr(j_bb_pose, j_bb_obj).reshape(-1, 42),
            plan.bb_factor_pair,
            num_segments=n_ob_pair,
        ).reshape(n_ob_pair, 6, 7)
    w_ob = w_ob * plan.ob_pair_mask[:, None, None].astype(dtype)

    if _profile_stop == "w":
        return _profile_exit(
            w_pt, w_ob, h_pp_d, h_ll_inv, g_ll, h_oo_inv, g_oo, b_p, b_l, b_o,
            grad_max,
        )

    # ---- dense reduced camera system S -----------------------------------
    # Assembled directly in (P, 6, P, 6) so the flattening to (6P, 6P) is a
    # free bitcast instead of a 75MB transpose-copy. Fixed/unconstrained
    # poses get identity diagonal blocks; every off-diagonal contribution
    # (relpose cross, Schur subtraction) is already zero for such poses
    # because their Jacobian blocks were masked at evaluation time, so no
    # whole-matrix row/col masking is needed.
    pose_active = (
        jnp.abs(jnp.diagonal(h_pp, axis1=-2, axis2=-1)).sum(-1) > 1e-12
    ) & free.poses
    eye6 = jnp.eye(6, dtype=dtype)
    act = pose_active.astype(dtype)
    diag_idx = jnp.arange(n_pose)
    def _gram(m):
        """m @ m.T at _GRAM_PRECISION."""
        return jax.lax.dot_general(
            m,
            m,
            (((1,), (1,)), ((), ())),
            precision=_GRAM_PRECISION,
            preferred_element_type=dtype,
        )

    def _dense_from_pairs(row_blk, col_blk, live, blocks, n_land, bh, bw):
        """Dense (bh*P, bw*n_land) block matrix: block (row_blk[k],
        col_blk[k]) = blocks[k]. Built by element scatter, whose cost
        scales with the UPDATES rather than the full output a flat gather
        would touch. Dead rows are routed out of bounds and dropped so indices are
        genuinely unique."""
        if cp_order:
            # c-major row order (component-major): row (p, c) -> c*P + p;
            # dead rows routed past the end and dropped.
            rows = jnp.where(
                live[:, None],
                jnp.arange(bh) * n_pose + row_blk[:, None],
                n_pose * bh,
            )  # (K, bh)
        else:
            safe_row = jnp.where(live, row_blk, n_pose)
            rows = safe_row[:, None] * bh + jnp.arange(bh)  # (K, bh)
        cols = col_blk[:, None] * bw + jnp.arange(bw)  # (K, bw)
        out = jnp.zeros((n_pose * bh, n_land * bw), dtype=dtype)
        return out.at[rows[:, :, None], cols[:, None, :]].set(
            blocks, mode="drop", unique_indices=True
        )

    def _shard_rows(z, axis_index):
        """Landmark/slot-axis sharding constraint on a z tensor.

        Without this, the factor-axis input sharding dies at the fused H/b
        all-reduce and EVERY gram — the step's FLOP carrier — runs
        replicated on all devices (audited: the compiled 8-device HLO held
        exactly one 2.1 MB tuple all-reduce and no other collectives, so
        multi-chip speedup capped at the resjac share). Sharding the z
        rows makes the gram's contraction dim sharded on both operands:
        XLA emits per-device partial group grams + one all-reduce of the
        (G, 768, 768) result — compute scales 1/N, comm is the gram
        output, not the factor tables."""
        if shard_mesh is None:
            return z
        from jax.sharding import NamedSharding, PartitionSpec

        spec = [None] * z.ndim
        spec[axis_index] = shard_axis
        return jax.lax.with_sharding_constraint(
            z, NamedSharding(shard_mesh, PartitionSpec(*spec))
        )

    def _slot_gram(
        w_scaled_blocks, slot_gather, slot_pose, slot_mask, bw,
        band_local=None, cp_order=False, emit_tiles=False, skip_gram=False,
    ):
        """Schur subtraction Σ_l U_l U_l^T as matrix products.

        Uses the plan's per-landmark slot grid: a one-hot contraction over
        slots places each (6, bw) pair block at its pose row
        (z_b[l, p] = (W_{p,l} G_l)[:, b] — exact, since every (l, p) output
        sums exactly one nonzero product and HIGHEST keeps f32 operands
        unrounded), then a gram over the landmark dim yields all
        -W_a Hxx^-1 W_b^T blocks. Replaces the element scatter that built a
        dense U; the one-hot build + block products are dense and regular.

        z is produced as ``bw`` separate (L, P, 6) tensors (one per landmark
        block column) instead of one (L, P, 6, bw): each z_b reshapes FREELY
        to a (K, M) landmark-major matrix — contraction over the leading
        dim, no relayout. The 4-D form would put bw in the minor dim,
        forcing a transpose of the whole buffer to feed any (K, M) gram; the
        per-b (L, P, 6) tensors keep (P, 6) minor-contiguous for every
        consumer (gram, reduced RHS, back-substitution)."""
        L, C = slot_gather.shape
        w_comp = w_scaled_blocks.reshape(-1, 6 * bw)[
            slot_gather.reshape(-1)
        ].reshape(L, C, 6, bw)
        if band_local is not None:
            # Banded gram: one-hot over the 128-wide LOCAL pose window, ONE
            # batched group gram, staggered add onto the padded dense S.
            #
            # Layout: one N=18 dot (b-major w columns) emits
            # z (L, bw, 6, 128) — the (bw) block column lands NEXT TO the
            # landmark dim so (Lg, bw) merge into a single 3Lg-deep
            # contraction per group with zero relayout; the (c, p) output
            # order is permuted back to (p, c) once on the SMALL (G, 768,
            # 768) group result, instead of 3 separate per-b N=6 dots + 3
            # gram epilogues.
            n_group, lg, _ = band_local.shape
            width = 2 * _BAND_TP  # 128 local poses
            w_band = 6 * width  # 768
            onehot = (
                (
                    band_local.reshape(L, C)[:, :, None]
                    == jnp.arange(width, dtype=band_local.dtype)
                )
                & slot_mask[:, :, None]
            ).astype(dtype)
            w_bt = jnp.swapaxes(w_comp, 2, 3).reshape(L, C, bw * 6)
            z4 = jax.lax.dot_general(
                w_bt,
                onehot,
                (((1,), (1,)), ((0,), (0,))),
                precision=_P_HI,
                preferred_element_type=dtype,
            )  # (L, bw*6, 128): dims (l, (b, c), p)
            zg = z4.reshape(n_group, lg, bw, 6 * width).reshape(
                n_group, lg * bw, 6 * width
            )  # contraction rows (l, b); columns (c, p)
            zg = _shard_rows(zg, 1)
            if _profile_stop == "ptz":
                return zg
            sg = jax.lax.dot_general(
                zg,
                zg,
                (((1,), (1,)), ((0,), (0,))),
                precision=_GRAM_PRECISION,
                preferred_element_type=dtype,
            )  # (G, 768, 768) in (c, p) x (c, p) order
            if _profile_stop == "ptgram":
                return sg
            if emit_tiles:
                # Band-solve mode (solver/band_solve.py): return the RAW
                # gram quadrants instead of folding a dense (6P, 6P) S.
                # Group g's gram covers poses [64g, 64g+128) -> quadrants
                # land on tiles (g, g), (g+1, g), (g+1, g+1); consecutive
                # groups overlap only on the shared diagonal tile
                # (Q11[g] + Q00[g+1]). The overlap fold happens at the
                # assembly site — immediately on the single-device path, or
                # INSIDE the shard_map domain bodies on the decomposed path
                # (the fold's g-1 neighbor dependency otherwise forces the
                # partitioner to all-gather the whole tile batch).
                tp_ = _BAND_TP
                sg6 = sg.reshape(n_group, 6, 2, tp_, 6, 2, tp_)
                q00 = sg6[:, :, 0, :, :, 0, :]
                q10 = sg6[:, :, 1, :, :, 0, :]
                q11 = sg6[:, :, 1, :, :, 1, :]
                return (q00, q10, q11), zg
            # The group grams come out in (component, pose)-major order.
            # KEEP that order: the whole reduced system runs c-major under
            # banding (a symmetric permutation — Cholesky/solves are
            # oblivious), because permuting each gram output back to
            # (p, c) is an interleaved transpose of the whole gram while
            # transposing the (P, 6) rhs/delta vectors at the solve boundary
            # is nearly free.
            # Staggered fold of the overlapping group grams (stride 64,
            # width 128) onto the c-major S. A dynamic-slice/update loop
            # would copy the padded buffer once per group; instead decompose each group gram
            # into its four 64-pose quadrants — the only overlap between
            # consecutive windows is Q11[g] + Q00[g+1] on the shared tile —
            # and assemble S column-of-tiles by column with static concats:
            # one bandwidth-speed pass, no dynamic updates. Group g homes
            # tiles {g, g+1}; quadrant tiles past n_pose (the pad tile of
            # the last group) are simply never concatenated.
            tp = _BAND_TP
            nb = n_group  # 64-pose tiles covering n_pose (== ceil(P/64))
            sg6 = sg.reshape(n_group, 6, 2, tp, 6, 2, tp)
            q00 = sg6[:, :, 0, :, :, 0, :]  # (G, 6, 64, 6, 64) tile (g, g)
            q01 = sg6[:, :, 0, :, :, 1, :]  # tile (g, g+1)
            q10 = sg6[:, :, 1, :, :, 0, :]  # tile (g+1, g)
            q11 = sg6[:, :, 1, :, :, 1, :]  # tile (g+1, g+1)
            zeros_col = jnp.zeros((6, tp, 6, tp), dtype)
            cols = []
            for b in range(nb):
                pieces = []
                for a in range(nb):
                    if a == b:
                        tile = q00[b]
                        if b > 0:
                            tile = tile + q11[b - 1]
                    elif a == b - 1:
                        tile = q01[b - 1]
                    elif a == b + 1:
                        tile = q10[b]
                    else:
                        tile = zeros_col
                    pieces.append(tile)
                cols.append(jnp.concatenate(pieces, axis=1))
            s_cm = jnp.concatenate(cols, axis=3)[
                :, :n_pose, :, :n_pose
            ].reshape(n_pose * 6, n_pose * 6)  # c-major (6P, 6P)
            if _profile_stop == "ptfold":
                return s_cm
            return s_cm, zg
        onehot = (
            (slot_pose[:, :, None] == jnp.arange(n_pose, dtype=slot_pose.dtype))
            & slot_mask[:, :, None]
        ).astype(dtype)
        if cp_order:
            # c-major variant (used for the small object gram when the
            # point gram runs banded, so all S contributions share one
            # layout): rows (l, b), columns (c, p); one 2-D gram.
            w_bt = jnp.swapaxes(w_comp, 2, 3).reshape(L, C, bw * 6)
            zf = jax.lax.dot_general(
                w_bt,
                onehot,
                (((1,), (1,)), ((0,), (0,))),
                precision=_P_HI,
                preferred_element_type=dtype,
            ).reshape(L * bw, 6 * n_pose)  # (l*b, (c, p))
            zf = _shard_rows(zf, 0)
            if skip_gram:
                # Band-solve mode: the object coupling goes into the
                # Woodbury low-rank term as zf itself; its (6P, 6P) gram is
                # never needed.
                return None, zf
            s = jax.lax.dot_general(
                zf,
                zf,
                (((0,), (0,)), ((), ())),
                precision=_GRAM_PRECISION,
                preferred_element_type=dtype,
            )
            return s, zf
        z_bs = tuple(
            _shard_rows(
                jax.lax.dot_general(
                    onehot,
                    w_comp[..., b],
                    (((1,), (1,)), ((0,), (0,))),
                    precision=_P_HI,
                    preferred_element_type=dtype,
                ),
                0,
            )  # (L, P, 6), landmark axis sharded
            for b in range(bw)
        )
        s = sum(
            jax.lax.dot_general(
                z,
                z,
                (((0,), (0,)), ((), ())),
                precision=_GRAM_PRECISION,
                preferred_element_type=dtype,
            )
            for z in z_bs
        )  # (P, 6, P, 6)
        return s.reshape(n_pose * 6, n_pose * 6), z_bs

    # Banded point gram applies when the plan carries the band layout AND
    # the runtime pose count fits the group coverage (the plan may have been
    # built for a smaller pose capacity).
    pt_band = (
        plan.pt_band_local_pose is not None
        and n_pose
        <= _BAND_TP * (plan.pt_band_local_pose.shape[0] + 1)
    )
    # One-hot size gate: for extreme landmark degree (C ~ P) the slot grid's
    # one-hot exceeds the dense-U buffer it replaces — fall back to scatter.
    # Under banding the point one-hot spans only the 128-wide LOCAL pose
    # window, not n_pose — sizing it with n_pose wrongly disabled the
    # banded path (and with it the block-tridiag solve) at >=1024 poses,
    # exactly the scale it exists for.
    _slot_budget = 48 * 1024 * 1024  # elements (192 MB f32)
    pt_onehot_width = 2 * _BAND_TP if pt_band else n_pose
    pt_slot_ok = (
        plan.pt_slot_gather.shape[0]
        * plan.pt_slot_gather.shape[1]
        * pt_onehot_width
        <= _slot_budget
    )
    ob_slot_ok = (
        plan.ob_slot_gather.shape[0] * plan.ob_slot_gather.shape[1] * n_pose
        <= _slot_budget
    )
    if dense_schur is None:
        # The dense-U size rule predates the slot grams: with the BANDED
        # layout no (6P, 3M)-sized buffer ever exists — the z build is
        # (G, Lg*3, 768), independent of P — so large banded problems
        # (1024 poses x 16k points, the reference scale) must stay on the
        # slot-gram path instead of falling back to pair enumeration.
        if pt_band and pt_slot_ok:
            lp = plan.pt_band_local_pose.shape
            u_elems = lp[0] * lp[1] * 3 * 6 * 2 * _BAND_TP
        else:
            u_elems = (n_pose * 6) * (n_point * 3)
        dense_schur = u_elems <= 256 * 1024 * 1024
    # Under banding the whole reduced camera system is assembled and solved
    # in (component, pose)-major order — the band grams' native layout —
    # and only the (P, 6) rhs/delta vectors are transposed at the solve
    # boundary (see the band-branch comment in _slot_gram).
    cp_order = pt_band and pt_slot_ok
    # Block-tridiagonal + Woodbury reduced solve (solver/band_solve.py): at
    # reference scale the dense (6P)^2 S and its O(P^3) Cholesky dominate;
    # when the band layout is active the point/relpose couplings are
    # block-tridiagonal at 64-pose tiles and the object coupling is rank
    # <= 7K -> S = B - Z^T Z, solved in O(P b^2 + P b Rz). Requires: banded
    # points (cp_order), banded relpose (every live relpose pair within one
    # tile of its partner — rel_band_local_pose present), the object slot
    # grid (Z), and a low-rank object term worth the Woodbury detour.
    band_solve_on = (
        dense_schur  # tiles come from the slot-gram path
        and cp_order
        and ob_slot_ok
        and _use_band_solve(n_pose)
        # The block-tridiag solve reshapes S into (6, P/64, 64) tiles;
        # pipeline pose capacities are powers of two so auto mode always
        # satisfies this, but OBVI_BAND_SOLVE=on with a non-multiple-of-64
        # capacity must fall back to the dense solve instead of dying in an
        # opaque reshape trace error.
        and n_pose % _BAND_TP == 0
        and plan.rel_band_local_pose is not None
        and plan.ob_slot_gather.shape[0] * 7 <= 3 * n_pose
        # Profile stops that are path-identical (or band-specific) keep the
        # band path; stops tied to the dense S (sassembly/ptfold/obgram)
        # force the dense path.
        and _profile_stop
        in (None, "resjac", "hb", "w", "ptw", "ptz", "ptgram", "bandtiles",
            "rhs", "chol", "backsub")
    )

    s_sub2 = None
    z_pt = z_ob = None
    band_rel_scatter = None  # deferred tile updates for the shard_map DD
    if dense_schur:
        # Dense-U path. Layout considerations shaping this code:
        # (1) The per-landmark Hll^-1 is folded into U via its Cholesky
        #     factor G (Hll^-1 = G G^T), so the Schur subtraction is a
        #     symmetric gram (U G)(U G)^T — no second U-sized buffer.
        # (2) precision=HIGHEST keeps contractions at full f32 operand
        #     precision (a GPU's default f32 product may use TF32); the
        #     contraction dim here is 3*n_landmarks, the largest accumulation
        #     in the whole solver.
        # (3) U itself is never scattered: _slot_gram builds the per-landmark
        #     blocks with a one-hot matmul (column order under a gram is
        #     free, so the landmark axis is compacted to observed landmarks).
        w_scaled = geo.bmm(w_pt, g_ll[plan.pt_pair_point])  # (Np, 6, 3)
        if _profile_stop == "ptw":
            return _profile_exit(w_scaled, w_ob, b_p, b_l, b_o, grad_max)
        if pt_slot_ok:
            out = _slot_gram(
                w_scaled,
                plan.pt_slot_gather,
                plan.pt_slot_pose,
                plan.pt_slot_mask,
                3,
                band_local=plan.pt_band_local_pose if pt_band else None,
                emit_tiles=band_solve_on,
            )
            if _profile_stop in ("ptz", "ptgram", "ptfold"):
                # _slot_gram returned the raw intermediate for this stop.
                return _profile_exit(out, w_ob, b_p, b_l, b_o, grad_max)
            s_sub2, z_pt = out
        else:
            u2 = _dense_from_pairs(
                plan.pt_pair_pose,
                plan.pt_pair_point,
                plan.pt_pair_mask,
                w_scaled,
                n_point,
                6,
                3,
            )
            s_sub2 = _gram(u2)  # (6P, 6P)

        # Object (bbox) Schur subtraction the same way: v_ob = W_ob G_oo on
        # the (pose, object) grid reproduces every -W_a Hoo^-1 W_b^T block
        # (diagonal included).
        w_ob_scaled = geo.bmm(w_ob, g_oo[plan.ob_pair_obj])  # (No, 6, 7)
        if ob_slot_ok:
            s_sub_ob, z_ob = _slot_gram(
                w_ob_scaled,
                plan.ob_slot_gather,
                plan.ob_slot_pose,
                plan.ob_slot_mask,
                7,
                cp_order=cp_order,
                skip_gram=band_solve_on,
            )
            if _profile_stop == "obgram":
                return _profile_exit(
                    s_sub2, s_sub_ob, z_pt, z_ob, b_p, b_l, b_o, grad_max
                )
        else:
            v_ob = _dense_from_pairs(
                plan.ob_pair_pose,
                plan.ob_pair_obj,
                plan.ob_pair_mask,
                w_ob_scaled,
                n_obj,
                6,
                7,
            )
            s_sub_ob = _gram(v_ob)

        # Relpose factor contribution (diagonal + cross, + sign) as a third
        # gram: V_rel[(p,i), (k,r)] = J_{p,k}[r,i] for p in {before_k,
        # after_k}, so V_rel V_rel^T sums J_p^T J_q over relpose factors —
        # exactly the blocks the reference's Ceres problem assembles for
        # RelativePoseFactor. (h_pp_rel is excluded from the diagonal below
        # to avoid double counting.) Assumes before != after per live factor
        # (a self-relative-pose factor is meaningless and never created,
        # relative_pose_factor.h:32-61).
        # Pose-diagonal blocks (damped h_pp minus the relpose part carried
        # by V_rel below; identity for fixed/unobserved poses). They are PSD
        # (sums of J^T J + damping + priors), so their Cholesky factors ride
        # along as P extra column blocks of V_rel: the ENTIRE S assembly is
        # then three gram matmuls with fused epilogue subtracts — zero
        # full-S elementwise passes (a where()-broadcast diagonal add costs
        # a select + layout copy of the whole S).
        if cp_order:
            # Direct c-major assembly of the relpose + pose-diagonal
            # contributions: the damped diagonal is block-diagonal and each
            # relpose factor adds one 6x6 cross block at (before, after) —
            # a gram formulation (a rel-band group gram) computes a full
            # (G, 768, 768) product for what is a block-tridiagonal pattern
            # of (2R + P) * 36 scalars. A direct element scatter-add of
            # those blocks onto -(s_sub2 + s_sub_ob) costs one full-S pass
            # + ~27k scattered elements (256-pose bench problem) instead of
            # a gram + one-hot build + a second group-fold. Also EXACT: no gram summation roundoff, and
            # no relpose span limit (wide loop-closure relpose pairs land
            # the same way). j_rl_* are weighted and mask-zeroed, so dead
            # capacity rows contribute exact zeros at clipped indices.
            diag_blocks = (
                act[:, None, None] * h_pp_d
                + (1.0 - act)[:, None, None] * eye6
            )
            rl_cross = _outer_rr(j_rl_b, j_rl_a)  # (R, 6, 6)
            bidx = jnp.clip(tables.relpose.before_idx, 0, n_pose - 1)
            aidx = jnp.clip(tables.relpose.after_idx, 0, n_pose - 1)
            rows_blk = jnp.concatenate([diag_idx, bidx, aidx])
            cols_blk = jnp.concatenate([diag_idx, aidx, bidx])
            vals = jnp.concatenate(
                [diag_blocks, rl_cross, jnp.swapaxes(rl_cross, -1, -2)],
                axis=0,
            )
            ci = jnp.arange(6)
            if band_solve_on:
                # Band-solve assembly: scatter the relpose + diagonal
                # blocks straight onto the block-tridiagonal tiles (no
                # (6P)^2 buffer). Lower/diagonal blocks only — each cross
                # block's transpose twin is already in ``vals``, and the
                # band factorization reads just the lower structure. Upper
                # blocks (row tile < col tile) and padding are routed out
                # of bounds and dropped. band_solve_on requires
                # rel_band_local_pose, which guarantees every live relpose
                # pair spans at most adjacent tiles. The solve itself runs
                # after the reduced RHS below.
                q00, q10, q11 = s_sub2  # (G,6,tp,6,tp) gram quadrants
                nb_t = q00.shape[0]
                tp_ = _BAND_TP
                t_r = rows_blk // tp_
                t_c = cols_blk // tp_
                pl_r = rows_blk % tp_
                pl_c = cols_blk % tp_
                d_dest = jnp.where(t_r == t_c, t_r, nb_t)
                e_dest = jnp.where(t_r == t_c + 1, t_c, nb_t)
                m_t = 6 * tp_
                _n_dom_assembly = _dd_domains(shard_mesh, nb_t)
                if _n_dom_assembly > 1 and _n_dom_assembly == int(
                    shard_mesh.devices.size
                ):
                    # shard_map DD solve below: DEFER the quadrant fold AND
                    # this scatter into the shard bodies so the tile batch
                    # never re-gathers (the fold's g-1 overlap + the at-site
                    # scatter otherwise force an all-gather of the tile
                    # batch every iteration). The quadrants stay POSITIVE
                    # grams; negation happens with the deferred updates.
                    band_rel_scatter = (d_dest, e_dest, pl_r, pl_c, vals)
                    band_tiles = (q00, q10, q11)
                else:
                    d_t5 = q00.at[1:].add(q11[:-1])
                    e_t5 = q10[:-1]
                    d_t5, e_t5 = -d_t5, -e_t5  # S = (rel+diag) - pt gram
                    ix = (
                        lambda dest: (
                            dest[:, None, None],
                            ci[None, :, None],
                            pl_r[:, None, None],
                            ci[None, None, :],
                            pl_c[:, None, None],
                        )
                    )
                    d_t5 = d_t5.at[ix(d_dest)].add(vals, mode="drop")
                    e_t5 = e_t5.at[ix(e_dest)].add(vals, mode="drop")
                    band_tiles = (
                        d_t5.reshape(nb_t, m_t, m_t),
                        e_t5.reshape(nb_t - 1, m_t, m_t),
                    )
                s4 = None
                if _profile_stop == "bandtiles":
                    return _profile_exit(
                        band_tiles[0], band_tiles[1], b_p, b_l, b_o,
                        grad_max, z_pt, z_ob,
                    )
            else:
                # c-major flat indices: (c, p) -> c * P + p.
                rr_idx = ci[None, :, None] * n_pose + rows_blk[:, None, None]
                cc_idx = ci[None, None, :] * n_pose + cols_blk[:, None, None]
                s4 = (
                    (-(s_sub2 + s_sub_ob))
                    .at[rr_idx, cc_idx]
                    .add(vals)
                    .reshape(n_pose, 6, n_pose, 6)
                )
        else:
            diag_blocks = (
                act[:, None, None] * (h_pp_d - h_pp_rel)
                + (1.0 - act)[:, None, None] * eye6
            )
            l_diag = _cholesky_unrolled(diag_blocks, 6)  # L L^T = diag_blocks
            n_rel = j_rl_b.shape[0]
            rel_blocks = jnp.concatenate(
                [jnp.swapaxes(j_rl_b, 1, 2), jnp.swapaxes(j_rl_a, 1, 2), l_diag],
                axis=0,
            )  # (2R + P, 6, 6) — the stack rel_band_gather indexes into
            k_rng = jnp.arange(n_rel, dtype=jnp.int32)
            live_rl = tables.relpose.mask
            v_rel = _dense_from_pairs(
                jnp.concatenate(
                    [
                        tables.relpose.before_idx,
                        tables.relpose.after_idx,
                        diag_idx,
                    ]
                ),
                jnp.concatenate(
                    [k_rng, k_rng, n_rel + jnp.arange(n_pose, dtype=jnp.int32)]
                ),
                jnp.concatenate(
                    [live_rl, live_rl, jnp.ones(n_pose, dtype=bool)]
                ),
                rel_blocks,
                n_rel + n_pose,
                6,
                6,
            )

            # S = V_rel V_rel^T - (U G)(U G)^T - (W_ob G_oo)(W_ob G_oo)^T.
            s4 = (_gram(v_rel) - s_sub2 - s_sub_ob).reshape(
                n_pose, 6, n_pose, 6
            )
    else:
        # Pair-enumeration path (problems too large for a dense U): combine
        # rows sharing a destination with a sorted segment_sum, scatter
        # unique dests; diagonal, relpose cross and object cross blocks land
        # in ONE scatter-add (each .at[].add on the (P,6,P,6) buffer costs a
        # full-buffer copy).
        h_pp_masked = (
            h_pp_d * act[:, None, None] + (1.0 - act)[:, None, None] * eye6
        )
        rl_cross = _outer_rr(j_rl_b, j_rl_a)
        s4_idx_a = [diag_idx, tables.relpose.before_idx, tables.relpose.after_idx]
        s4_idx_b = [diag_idx, tables.relpose.after_idx, tables.relpose.before_idx]
        s4_updates = [h_pp_masked, rl_cross, jnp.swapaxes(rl_cross, -1, -2)]
        wha_pt = geo.bmm(
            w_pt[plan.pt_cross_a], h_ll_inv[plan.pt_pair_point[plan.pt_cross_a]]
        )
        cross_pt = -geo.bmm(wha_pt, jnp.swapaxes(w_pt[plan.pt_cross_b], -1, -2))
        cross_pt = cross_pt * plan.pt_cross_mask[:, None, None].astype(dtype)
        n_pt_dest = plan.pt_dest_a.shape[0]
        dest_pt = jax.ops.segment_sum(
            cross_pt, plan.pt_cross_dest, num_segments=n_pt_dest,
            indices_are_sorted=True,
        ) * plan.pt_dest_mask[:, None, None].astype(dtype)
        s4_idx_a.append(plan.pt_dest_a)
        s4_idx_b.append(plan.pt_dest_b)
        s4_updates.append(dest_pt)
        wha_ob = geo.bmm(
            w_ob[plan.ob_cross_a], h_oo_inv[plan.ob_pair_obj[plan.ob_cross_a]]
        )
        cross_ob = -geo.bmm(wha_ob, jnp.swapaxes(w_ob[plan.ob_cross_b], -1, -2))
        cross_ob = cross_ob * plan.ob_cross_mask[:, None, None].astype(dtype)
        n_ob_dest = plan.ob_dest_a.shape[0]
        dest_ob = jax.ops.segment_sum(
            cross_ob, plan.ob_cross_dest, num_segments=n_ob_dest,
            indices_are_sorted=True,
        ) * plan.ob_dest_mask[:, None, None].astype(dtype)
        s4_idx_a.append(plan.ob_dest_a)
        s4_idx_b.append(plan.ob_dest_b)
        s4_updates.append(dest_ob)
        s4_base = jnp.zeros((n_pose, 6, n_pose, 6), dtype=dtype)
        s4 = s4_base.at[
            jnp.concatenate(s4_idx_a), :, jnp.concatenate(s4_idx_b), :
        ].add(jnp.concatenate(s4_updates, axis=0))

    if _profile_stop == "sassembly":
        pieces = [s4, b_p, b_l, b_o, grad_max]
        for z in (z_pt, z_ob):
            if isinstance(z, tuple):
                pieces += list(z)
            elif z is not None:
                pieces.append(z)
        return _profile_exit(*pieces)

    # Reduced RHS: b_S = b_p - sum_pairs W Hxx^-1 b_x. When the slot tensor
    # z = W G is live, W Hxx^-1 b = z (G^T b) is one contraction over
    # (landmark, block) — replacing a per-pair einsum + 24k-row scatter-add.
    b_s = b_p
    g_ll_slot = g_oo_slot = None
    if z_pt is not None:
        g_ll_slot = g_ll[plan.pt_slot_land]
        y_pt = (g_ll_slot * b_l[plan.pt_slot_land][:, :, None]).sum(1)
        if pt_band:
            n_group, k_rows, w_band = z_pt.shape
            width = w_band // 6
            lg = k_rows // 3
            y4 = y_pt.reshape(n_group, k_rows)  # (l, b) row order matches z
            contrib = jax.lax.dot_general(
                z_pt,
                y4,
                (((1,), (1,)), ((0,), (0,))),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=dtype,
            )  # (G, 768) in (c, p) order
            contrib = (
                contrib.reshape(n_group, 6, width)
                .transpose(0, 2, 1)
                .reshape(n_group, w_band)
            )  # -> (p, c)
            pad = 6 * _BAND_TP * (n_group + 1)
            flat = jnp.zeros((pad,), dtype)
            for g in range(n_group):
                off = 6 * _BAND_TP * g
                cur = jax.lax.dynamic_slice(flat, (off,), (w_band,))
                flat = jax.lax.dynamic_update_slice(
                    flat, cur + contrib[g], (off,)
                )
            b_s = b_s - flat[: n_pose * 6].reshape(n_pose, 6)
        else:
            b_s = b_s - sum(
                jax.lax.dot_general(
                    z_b,
                    y_pt[:, b],
                    (((0,), (0,)), ((), ())),
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=dtype,
                )
                for b, z_b in enumerate(z_pt)
            )
    else:
        wb_pt = geo.bmv(w_pt, geo.bmv(h_ll_inv[plan.pt_pair_point], b_l[plan.pt_pair_point]))
        b_s = b_s.at[plan.pt_pair_pose].add(-wb_pt)
    if z_ob is not None:
        g_oo_slot = g_oo[plan.ob_slot_land]
        y_ob = (g_oo_slot * b_o[plan.ob_slot_land][:, :, None]).sum(1)
        if cp_order:
            contrib_ob = jax.lax.dot_general(
                z_ob,
                y_ob.reshape(-1),
                (((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=dtype,
            )  # (6P,) c-major
            b_s = b_s - contrib_ob.reshape(6, n_pose).T
        else:
            b_s = b_s - sum(
                jax.lax.dot_general(
                    z_b,
                    y_ob[:, b],
                    (((0,), (0,)), ((), ())),
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=dtype,
                )
                for b, z_b in enumerate(z_ob)
            )
    else:
        wb_ob = geo.bmv(w_ob, geo.bmv(h_oo_inv[plan.ob_pair_obj], b_o[plan.ob_pair_obj]))
        b_s = b_s.at[plan.ob_pair_pose].add(-wb_ob)

    b_s = b_s * act[:, None]

    if _profile_stop == "rhs":
        pieces = [b_s, b_l, b_o, grad_max]
        pieces += list(band_tiles) if s4 is None else [s4]
        for z in (z_pt, z_ob):
            if isinstance(z, tuple):
                pieces += list(z)
            elif z is not None:
                pieces.append(z)
        return _profile_exit(*pieces)

    if band_solve_on:
        # Block-tridiagonal + Woodbury solve (solver/band_solve.py):
        # rhs/Z permute into the tile-major (tile, component, pose_local)
        # flattening the band tiles use; delta permutes back. Iterative
        # refinement runs inside woodbury_band_solve (same role as the
        # dense path's refinement step below).
        nb_t = band_tiles[0].shape[0]
        tp_ = _BAND_TP
        m_t = 6 * tp_
        rhs_band = (
            b_s.T.reshape(6, nb_t, tp_).transpose(1, 0, 2).reshape(nb_t * m_t)
        )
        z_band = (
            z_ob.reshape(-1, 6, nb_t, tp_)
            .transpose(0, 2, 1, 3)
            .reshape(z_ob.shape[0], nb_t * m_t)
        )
        n_dom = _dd_domains(shard_mesh, nb_t)
        if band_rel_scatter is not None:
            # Trajectory-domain decomposition (multi-host/multi-device):
            # contiguous tile runs per device, interiors solved batched and
            # device-local, only the tiny interface Schur system + the
            # Woodbury C combine cross the interconnect, where the replicated
            # CR path all-gathers every level batch each iteration. Tiles
            # arrive as deferred
            # gram quadrants + relpose updates (see the assembly comment).
            delta_band = band_solve_mod.dd_woodbury_band_solve(
                None, None, z_band, rhs_band, n_domains=n_dom,
                shard_mesh=shard_mesh, shard_axis=shard_axis,
                rel_scatter=band_rel_scatter, gram_quads=band_tiles,
            )
        elif n_dom > 1:
            d_tiles, e_tiles = band_tiles
            delta_band = band_solve_mod.dd_woodbury_band_solve(
                d_tiles, e_tiles, z_band, rhs_band, n_domains=n_dom,
                shard_mesh=shard_mesh, shard_axis=shard_axis,
            )
        else:
            d_tiles, e_tiles = band_tiles
            delta_band = band_solve_mod.woodbury_band_solve(
                d_tiles, e_tiles, z_band, rhs_band
            )
        # Non-finite (factorization failure before enough damping) -> zero
        # step -> LM rejects and shrinks the radius, like the dense path.
        delta_band = jnp.where(
            jnp.all(jnp.isfinite(delta_band)), delta_band, 0.0
        )
        delta_p = (
            delta_band.reshape(nb_t, 6, tp_)
            .transpose(1, 0, 2)
            .reshape(6, n_pose)
            .T
        )
    else:
        # (Rows/cols of the folded s_sub2 for fixed or unconstrained poses
        # are exactly zero — their Jacobian blocks were masked before W
        # assembly — so folding it under the identity-diag masking above is
        # safe.)
        s_dense = s4.reshape(n_pose * 6, n_pose * 6)
        if dense_schur:
            # Sum of gram matrices: symmetric by construction (up to
            # per-tile summation-order roundoff, which neither Cholesky —
            # it reads one triangle — nor the refinement matvec is
            # sensitive to). Skipping 0.5 (S + S^T) saves a full-S
            # transpose pass.
            s_sym = s_dense
        else:
            s_sym = 0.5 * (s_dense + s_dense.T)
        # symmetrize_input=False: jnp.linalg.cholesky inserts a (S + S^T)/2
        # pass first; s_sym is already symmetric (explicitly on the pair
        # path, up to summation-order roundoff on the gram path, which
        # Cholesky — reading one triangle — is insensitive to).
        chol = jax.lax.linalg.cholesky(s_sym, symmetrize_input=False)
        # c-major S (banding): permute the rhs to match — a symmetric
        # permutation of the system, so the factorization/solve are
        # unchanged.
        rhs = b_s.T.reshape(-1) if cp_order else b_s.reshape(-1)
        delta_raw = jax.scipy.linalg.cho_solve((chol, True), rhs)
        # One step of iterative refinement: reuses the factorization and
        # costs a single matvec + triangular solves, but recovers most of
        # the accuracy an f32 Cholesky loses on ill-conditioned windows
        # (f32-vs-f64 parity, PARITY.md known-gaps). Runs
        # unconditionally — keeping it out of the cond avoids a pipeline
        # sync around the whole solve; the cond below only selects the
        # (rarely taken) LU fallback.
        # Contract over dim 0 (S is symmetric by construction), avoiding a
        # hidden full-matrix transpose a dim-1 contraction can trigger.
        resid = rhs - jax.lax.dot_general(
            s_sym,
            delta_raw,
            (((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=s_sym.dtype,
        )
        delta_ref = delta_raw + jax.scipy.linalg.cho_solve(
            (chol, True), resid
        )
        # If the Cholesky failed (indefinite S before enough damping), zero
        # the step: model_cost_change becomes 0 and the LM loop rejects the
        # step and shrinks the radius — exactly Ceres'
        # linear-solver-failure handling (and cheaper than an LU-fallback
        # branch, which costs a pipeline sync as a lax.cond even when never
        # taken).
        delta_flat = jnp.where(
            jnp.all(jnp.isfinite(delta_ref)), delta_ref, 0.0
        )
        if cp_order:
            delta_p = delta_flat.reshape(6, n_pose).T
        else:
            delta_p = delta_flat.reshape(n_pose, 6)

    if _profile_stop == "chol":
        pieces = [delta_p, b_l, b_o, grad_max]
        for z in (z_pt, z_ob):
            if isinstance(z, tuple):
                pieces += list(z)
            elif z is not None:
                pieces.append(z)
        return _profile_exit(*pieces)

    # ---- back-substitution ----------------------------------------------
    # delta_x = Hxx^-1 (b_x - W^T delta_p). With z live the coupling term is
    # G (z^T delta_p) per compact landmark row — two contractions and one
    # small unique-row scatter instead of a pair gather + 24k-row segment_sum.
    # The Hxx^-1 b_x base term runs over ALL landmarks, which also covers
    # prior-only landmarks absent from the slot grid.
    if z_pt is not None:
        delta_l = geo.bmv(h_ll_inv, b_l)
        if pt_band:
            n_group, k_rows, w_band = z_pt.shape
            width = w_band // 6
            pad = 6 * _BAND_TP * (n_group + 1)
            dp_flat = jnp.zeros((pad,), dtype)
            dp_flat = jax.lax.dynamic_update_slice(
                dp_flat, delta_p.reshape(-1), (0,)
            )
            windows = jnp.stack(
                [
                    jax.lax.dynamic_slice(
                        dp_flat, (6 * _BAND_TP * g,), (w_band,)
                    )
                    for g in range(n_group)
                ]
            )  # (G, 768) in (p, c) order
            windows = (
                windows.reshape(n_group, width, 6)
                .transpose(0, 2, 1)
                .reshape(n_group, w_band)
            )  # -> (c, p), matching z columns
            q_pt = jax.lax.dot_general(
                z_pt,
                windows,
                (((2,), (1,)), ((0,), (0,))),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=dtype,
            ).reshape(-1, 3)  # (G, Lg*3) -> (L, 3), rows are (l, b)
        else:
            q_pt = jnp.stack(
                [
                    jax.lax.dot_general(
                        z_b,
                        delta_p,
                        (((1, 2), (0, 1)), ((), ())),
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=dtype,
                    )
                    for z_b in z_pt
                ],
                axis=1,
            )  # (L, 3) = G^T W^T delta_p
        corr = geo.bmv(g_ll_slot, q_pt)
        live_row = jnp.any(plan.pt_slot_mask, axis=1)
        safe_land = jnp.where(live_row, plan.pt_slot_land, n_point)
        delta_l = delta_l.at[safe_land].add(
            -corr, mode="drop", unique_indices=True
        )
    else:
        wt_dp_pt = (w_pt * delta_p[plan.pt_pair_pose][:, :, None]).sum(1)
        rhs_l = b_l - jax.ops.segment_sum(
            wt_dp_pt, plan.pt_pair_point, num_segments=n_point
        )
        delta_l = geo.bmv(h_ll_inv, rhs_l)
    delta_l = delta_l * (~ll_singular[:, None]) * point_free[:, None]
    if z_ob is not None:
        delta_o = geo.bmv(h_oo_inv, b_o)
        if cp_order:
            q_ob = jax.lax.dot_general(
                z_ob,
                delta_p.T.reshape(-1),
                (((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=dtype,
            ).reshape(-1, 7)  # rows (l, b) -> (Lo, 7)
        else:
            q_ob = jnp.stack(
                [
                    jax.lax.dot_general(
                        z_b,
                        delta_p,
                        (((1, 2), (0, 1)), ((), ())),
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=dtype,
                    )
                    for z_b in z_ob
                ],
                axis=1,
            )  # (Lo, 7)
        corr_o = geo.bmv(g_oo_slot, q_ob)
        live_row_o = jnp.any(plan.ob_slot_mask, axis=1)
        safe_obj = jnp.where(live_row_o, plan.ob_slot_land, n_obj)
        delta_o = delta_o.at[safe_obj].add(
            -corr_o, mode="drop", unique_indices=True
        )
    else:
        wt_dp_ob = (w_ob * delta_p[plan.ob_pair_pose][:, :, None]).sum(1)
        rhs_o = b_o - jax.ops.segment_sum(
            wt_dp_ob, plan.ob_pair_obj, num_segments=n_obj
        )
        delta_o = geo.bmv(h_oo_inv, rhs_o)
    delta_o = delta_o * (~oo_singular[:, None]) * obj_free[:, None]
    delta_p = delta_p * act[:, None]

    if _profile_stop == "backsub":
        return _profile_exit(delta_p, delta_l, delta_o, grad_max)

    # ---- model cost change (Ceres: -m'(r + m/2), m = J*step) -------------
    # Algebraically, with b = -J^T r and H_u = J^T J (undamped robustified
    # GN Hessian):       mcc = delta'b - 0.5 delta' H_u delta.
    # The Schur solve satisfies the DAMPED system H_d delta = b exactly —
    # landmark/object rows by back-substitution construction, pose rows up
    # to the refined-Cholesky residual — and H_d = H_u + D with
    # D = diag(clamp(diag(H_u))) / radius (Ceres' LM damping), so
    # H_u delta = b - D delta and
    #           mcc = 0.5 (delta'b + delta' D delta).
    # This O(n) form replaces the per-factor J*step products, which re-read
    # every Jacobian block from device memory; it also covers the param-prior blocks the J-products form skipped. When
    # the factorization fails, delta = 0 gives mcc = 0, which both LM loops
    # treat as an invalid model (reject + shrink) — Ceres'
    # linear-solver-failure handling unchanged.
    def _clip_diag(h):
        return jnp.clip(
            jnp.diagonal(h, axis1=-2, axis2=-1), _MIN_DIAG, _MAX_DIAG
        )

    quad_damp = (
        jnp.sum(_clip_diag(h_pp) * delta_p * delta_p)
        + jnp.sum(_clip_diag(h_ll) * delta_l * delta_l)
        + jnp.sum(_clip_diag(h_oo) * delta_o * delta_o)
    )
    model_cost_change = 0.5 * (
        jnp.sum(delta_p * b_p)
        + jnp.sum(delta_l * b_l)
        + jnp.sum(delta_o * b_o)
        + inv_radius * quad_damp
    )

    delta = BAState(poses=delta_p, points=delta_l, objects=delta_o)
    return delta, model_cost_change, grad_max


@fac.highest_matmul
def compute_marginal_covariances(
    state: BAState,
    cams: CameraBundle,
    tables: FactorTables,
    plan: SchurPlan,
    free: FreeMasks,
    weights: FactorWeights,
    huber: HuberParams = HuberParams(),
    return_reduced_hessian: bool = False,
    ridge: float = 0.0,
):
    """Per-object marginal covariances at the current state.

    Ceres-Covariance equivalent for LTM extraction
    (long_term_object_map_extraction.h:466-516): builds the UNDAMPED
    robustified Gauss-Newton Hessian, eliminates feature points analytically
    (they only couple to poses), inverts the dense reduced (poses+objects)
    system, and returns the 7x7 object diagonal blocks of the inverse.

    Fixed blocks are decoupled (zero cross rows/cols + identity diagonal), so
    remaining blocks equal the inverse of the sub-Hessian with fixed params
    removed — matching Ceres' constant-parameter-block covariance semantics.

    The whole computation runs as ONE jitted program (eager per-primitive
    dispatch pays a device round trip per op); ``ridge`` rides as a device
    operand so repair retries share the compiled program.

    Returns (obj_covariances (K,7,7), h_diag dict with per-block-type Jacobian
    column squared-norms for rank-deficiency detection, ok flag).
    """
    dtype = state.poses.dtype
    return _marginal_cov_jit(
        state, cams, tables, plan, free, weights,
        jnp.asarray(ridge, dtype), huber, return_reduced_hessian,
    )


@functools.partial(
    jax.jit, static_argnames=("huber", "return_reduced_hessian")
)
def _marginal_cov_jit(
    state, cams, tables, plan, free, weights, ridge, huber,
    return_reduced_hessian,
):
    dtype = state.poses.dtype
    n_pose = state.poses.shape[0]
    n_point = state.points.shape[0]
    n_obj = state.objects.shape[0]

    pose_free = free.poses.astype(dtype)
    point_free = free.points.astype(dtype)
    obj_free = free.objects.astype(dtype)

    from obvi_slam_tpu.factors.reproj_fast import reproj_residuals_and_jac_fast

    r_rp, j_rp_pose, j_rp_point = reproj_residuals_and_jac_fast(
        state, cams, tables.reproj
    )
    w_rp = _block_weight(r_rp, huber.reproj, weights.reproj, tables.reproj.mask.astype(dtype))
    _, (j_rp_pose, j_rp_point) = _weighted(r_rp, [j_rp_pose, j_rp_point], w_rp)
    j_rp_pose = j_rp_pose * pose_free[tables.reproj.pose_idx][:, None, None]
    j_rp_point = j_rp_point * point_free[tables.reproj.point_idx][:, None, None]

    r_bb, j_bb_obj, j_bb_pose = fac.bbox_residuals_and_jac(
        state, cams, tables.bbox, huber.invalid_ellipse_error
    )
    w_bb = _block_weight(r_bb, huber.bbox, weights.bbox, tables.bbox.mask.astype(dtype))
    _, (j_bb_obj, j_bb_pose) = _weighted(r_bb, [j_bb_obj, j_bb_pose], w_bb)
    j_bb_obj = j_bb_obj * obj_free[tables.bbox.obj_idx][:, None, None]
    j_bb_pose = j_bb_pose * pose_free[tables.bbox.pose_idx][:, None, None]

    r_sh, j_sh = fac.shape_residuals_and_jac(state, tables.shape)
    w_sh = _block_weight(r_sh, huber.shape, weights.shape, tables.shape.mask.astype(dtype))
    _, (j_sh,) = _weighted(r_sh, [j_sh], w_sh)
    j_sh = j_sh * obj_free[tables.shape.obj_idx][:, None, None]

    r_rl, j_rl_b, j_rl_a = fac.relpose_residuals_and_jac(state, tables.relpose)
    w_rl = _block_weight(r_rl, huber.relpose, weights.relpose, tables.relpose.mask.astype(dtype))
    _, (j_rl_b, j_rl_a) = _weighted(r_rl, [j_rl_b, j_rl_a], w_rl)
    j_rl_b = j_rl_b * pose_free[tables.relpose.before_idx][:, None, None]
    j_rl_a = j_rl_a * pose_free[tables.relpose.after_idx][:, None, None]

    r_lt, j_lt = fac.ltm_residuals_and_jac(state, tables.ltm)
    w_lt = _block_weight(r_lt, huber.ltm, weights.ltm, tables.ltm.mask.astype(dtype))
    _, (j_lt,) = _weighted(r_lt, [j_lt], w_lt)
    j_lt = j_lt * obj_free[tables.ltm.obj_idx][:, None, None]

    # ---- block Hessians (undamped) ----------------------------------------
    h_ll = jax.ops.segment_sum(
        jnp.einsum("fri,frj->fij", j_rp_point, j_rp_point),
        tables.reproj.point_idx,
        num_segments=n_point,
    )
    h_oo = jax.ops.segment_sum(
        jnp.einsum("fri,frj->fij", j_bb_obj, j_bb_obj),
        tables.bbox.obj_idx,
        num_segments=n_obj,
    )
    h_oo += jax.ops.segment_sum(
        jnp.einsum("fri,frj->fij", j_sh, j_sh), tables.shape.obj_idx, num_segments=n_obj
    )
    h_oo += jax.ops.segment_sum(
        jnp.einsum("fri,frj->fij", j_lt, j_lt), tables.ltm.obj_idx, num_segments=n_obj
    )
    h_pp = jax.ops.segment_sum(
        jnp.einsum("fri,frj->fij", j_rp_pose, j_rp_pose),
        tables.reproj.pose_idx,
        num_segments=n_pose,
    )
    h_pp += jax.ops.segment_sum(
        jnp.einsum("fri,frj->fij", j_bb_pose, j_bb_pose),
        tables.bbox.pose_idx,
        num_segments=n_pose,
    )
    h_pp += jax.ops.segment_sum(
        jnp.einsum("fri,frj->fij", j_rl_b, j_rl_b),
        tables.relpose.before_idx,
        num_segments=n_pose,
    )
    h_pp += jax.ops.segment_sum(
        jnp.einsum("fri,frj->fij", j_rl_a, j_rl_a),
        tables.relpose.after_idx,
        num_segments=n_pose,
    )

    # Scalar param priors into diagonals (rank-deficiency repair factors).
    pp = tables.param_prior
    pp_live = pp.mask.astype(dtype)
    pp_w2 = (pp.inv_std * pp.inv_std) * pp_live
    is_pose = (pp.block_kind == 0).astype(dtype)
    is_point = (pp.block_kind == 1).astype(dtype)
    is_obj = (pp.block_kind == 2).astype(dtype)
    pose_pi = jnp.clip(pp.param_idx, 0, 5)
    point_pi = jnp.clip(pp.param_idx, 0, 2)
    obj_pi = jnp.clip(pp.param_idx, 0, 6)
    h_pp = h_pp.at[jnp.clip(pp.block_idx, 0, n_pose - 1), pose_pi, pose_pi].add(
        pp_w2 * is_pose * pose_free[jnp.clip(pp.block_idx, 0, n_pose - 1)]
    )
    h_ll = h_ll.at[jnp.clip(pp.block_idx, 0, n_point - 1), point_pi, point_pi].add(
        pp_w2 * is_point * point_free[jnp.clip(pp.block_idx, 0, n_point - 1)]
    )
    h_oo = h_oo.at[jnp.clip(pp.block_idx, 0, n_obj - 1), obj_pi, obj_pi].add(
        pp_w2 * is_obj * obj_free[jnp.clip(pp.block_idx, 0, n_obj - 1)]
    )

    # Jacobian column squared-norms (rank-deficiency detection signal).
    h_diag = {
        "pose": jnp.diagonal(h_pp, axis1=-2, axis2=-1),
        "point": jnp.diagonal(h_ll, axis1=-2, axis2=-1),
        "object": jnp.diagonal(h_oo, axis1=-2, axis2=-1),
    }

    # ---- eliminate points --------------------------------------------------
    eye3 = jnp.eye(3, dtype=dtype)
    ll_active = (
        jnp.abs(jnp.diagonal(h_ll, axis1=-2, axis2=-1)).sum(-1) > 1e-12
    ) & free.points
    h_ll_guarded = jnp.where(ll_active[:, None, None], h_ll, eye3)
    h_ll_inv = jnp.linalg.inv(h_ll_guarded)
    h_ll_inv = h_ll_inv * ll_active[:, None, None]

    n_pt_pair = plan.pt_pair_pose.shape[0]
    w_pt = jax.ops.segment_sum(
        jnp.einsum("fri,frj->fij", j_rp_pose, j_rp_point),
        plan.rp_factor_pair,
        num_segments=n_pt_pair,
    ) * plan.pt_pair_mask[:, None, None].astype(dtype)

    s_pp = jnp.zeros((n_pose, n_pose, 6, 6), dtype=dtype)
    diag_idx = jnp.arange(n_pose)
    s_pp = s_pp.at[diag_idx, diag_idx].add(h_pp)
    rl_cross = jnp.einsum("fri,frj->fij", j_rl_b, j_rl_a)
    s_pp = s_pp.at[tables.relpose.before_idx, tables.relpose.after_idx].add(rl_cross)
    s_pp = s_pp.at[tables.relpose.after_idx, tables.relpose.before_idx].add(
        jnp.swapaxes(rl_cross, -1, -2)
    )
    wha = jnp.einsum(
        "cik,ckl->cil", w_pt[plan.pt_cross_a], h_ll_inv[plan.pt_pair_point[plan.pt_cross_a]]
    )
    cross = -jnp.einsum("cil,cjl->cij", wha, w_pt[plan.pt_cross_b])
    cross = cross * plan.pt_cross_mask[:, None, None].astype(dtype)
    n_pt_dest = plan.pt_dest_a.shape[0]
    dest_pt = jax.ops.segment_sum(
        cross, plan.pt_cross_dest, num_segments=n_pt_dest, indices_are_sorted=True
    ) * plan.pt_dest_mask[:, None, None].astype(dtype)
    s_pp = s_pp.at[plan.pt_dest_a, plan.pt_dest_b].add(dest_pt)

    # ---- pose-object coupling ----------------------------------------------
    n_ob_pair = plan.ob_pair_pose.shape[0]
    w_ob = jax.ops.segment_sum(
        jnp.einsum("fri,frj->fij", j_bb_pose, j_bb_obj),
        plan.bb_factor_pair,
        num_segments=n_ob_pair,
    ) * plan.ob_pair_mask[:, None, None].astype(dtype)
    h_po = jnp.zeros((n_pose, n_obj, 6, 7), dtype=dtype)
    h_po = h_po.at[plan.ob_pair_pose, plan.ob_pair_obj].add(w_ob)

    # ---- assemble the dense reduced system ---------------------------------
    dim = n_pose * 6 + n_obj * 7
    a = jnp.zeros((dim, dim), dtype=dtype)
    s_dense = s_pp.transpose(0, 2, 1, 3).reshape(n_pose * 6, n_pose * 6)
    a = a.at[: n_pose * 6, : n_pose * 6].set(s_dense)
    h_po_dense = h_po.transpose(0, 2, 1, 3).reshape(n_pose * 6, n_obj * 7)
    a = a.at[: n_pose * 6, n_pose * 6 :].set(h_po_dense)
    a = a.at[n_pose * 6 :, : n_pose * 6].set(h_po_dense.T)
    oo_dense = jnp.zeros((n_obj, n_obj, 7, 7), dtype=dtype)
    oo_dense = oo_dense.at[jnp.arange(n_obj), jnp.arange(n_obj)].set(h_oo)
    a = a.at[n_pose * 6 :, n_pose * 6 :].set(
        oo_dense.transpose(0, 2, 1, 3).reshape(n_obj * 7, n_obj * 7)
    )

    # Decouple fixed / inactive rows (identity diagonal).
    pose_active = (
        (jnp.abs(jnp.diagonal(h_pp, axis1=-2, axis2=-1)).sum(-1) > 1e-12) & free.poses
    )
    obj_active = (
        (jnp.abs(jnp.diagonal(h_oo, axis1=-2, axis2=-1)).sum(-1) > 1e-12) & free.objects
    )
    act = jnp.concatenate(
        [
            jnp.repeat(pose_active.astype(dtype), 6),
            jnp.repeat(obj_active.astype(dtype), 7),
        ]
    )
    a = a * act[:, None] * act[None, :]
    a = a + jnp.diag(1.0 - act)
    # Rank-deficiency regularization (retry path): adds ``ridge`` information
    # to every active parameter — the equivalent of the reference's
    # SuiteSparseQR-guided repair priors, which add (min_col_norm - col_norm)
    # ~= min_col_norm information to deficient columns
    # (long_term_object_map_extraction.cpp:761-922). Unobservable directions
    # then get variance ~1/ridge instead of a singular inverse. Null
    # directions that are linear COMBINATIONS of columns (invisible to
    # column-norm checks) are covered too.
    a = a + jnp.diag(act * ridge)

    sigma = jnp.linalg.inv(a)
    ok = jnp.all(jnp.isfinite(sigma))
    sigma_obj = sigma[n_pose * 6 :, n_pose * 6 :].reshape(n_obj, 7, n_obj, 7)
    obj_covs = sigma_obj[jnp.arange(n_obj), :, jnp.arange(n_obj), :]
    if return_reduced_hessian:
        return obj_covs, h_diag, ok, a
    return obj_covs, h_diag, ok
