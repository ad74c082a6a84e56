"""Window problem builder: pose-graph -> padded device tables.

Device-side replacement for the reference's incremental Ceres problem
management (``object_pose_graph_optimizer.h:126-632``
``buildPoseGraphOptimization``): instead of mutating a ceres::Problem, each
window is gathered into capacity-bucketed ``FactorTables`` + a ``SchurPlan``.
Scope-dependent inclusion (min-observation thresholds, feature-starved
relpose gating, LTM handling) is expressed as 0/1 ``FactorWeights`` so
phase-1 and phase-2 of an iteration — and successive windows of similar size —
share one jit signature and ZERO problem rebuilds.

Selection rules replicated from the reference:
  - visual factors with frames in [min,max]; features kept only with
    >= min_low_level_feature_observations factors in scope (:827-861)
  - relpose factors only for frames with < min_..._per_frame live feature
    observations (:240-299)
  - object observation factors in scope; objects kept with
    >= min_object_observations or LTM membership (:335-339)
  - object-only factors (shape prior / LTM prior) for included objects;
    force_include_ltm_objs adds all LTM objects (LTM extraction) (:342-405)
  - constant poses: frame 0 when window starts at 0, else the first
    max(1, poses_prior_to_window_to_keep_constant) window frames (:424-472)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation

from obvi_slam_tpu import types as T
from obvi_slam_tpu.types import asarray as _asarray
from obvi_slam_tpu.pose_graph import (
    OBJECT_OBSERVATION_FACTOR,
    batched_sqrt_inf,
    RELATIVE_POSE_FACTOR,
    REPROJECTION_FACTOR,
    SHAPE_PRIOR_FACTOR,
    PoseGraph,
)
from obvi_slam_tpu.solver import schur as schur_mod
from obvi_slam_tpu.solver.two_phase import TwoPhaseAux


@dataclass
class Scope:
    """OptimizationScopeParams mirror (optimization_factors_enabled_params.h:84+)."""

    min_frame_id: int
    max_frame_id: int
    include_object_factors: bool = True
    include_visual_factors: bool = True
    fix_poses: bool = False
    fix_objects: bool = False
    fix_visual_features: bool = False
    fix_ltm_objects: bool = False
    poses_prior_to_window_to_keep_constant: int = 1
    min_object_observations: int = 1
    min_low_level_feature_observations: int = 3
    min_low_level_feature_observations_per_frame: int = 50
    force_include_ltm_objs: bool = False
    include_shape_priors: bool = True  # excluded during LTM extraction


def _bucket(n: int, minimum=16) -> int:
    """Next power of two >= n, for jit-signature stability."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


@dataclass
class Problem:
    """A gathered window: device-ready arrays + host index maps."""

    state: T.BAState
    cams: T.CameraBundle
    tables: T.FactorTables
    plan: schur_mod.SchurPlan
    free: T.FreeMasks
    weights: schur_mod.FactorWeights
    huber: schur_mod.HuberParams
    # Host index maps (row -> pose-graph id).
    pose_rows: np.ndarray  # frame ids
    point_rows: np.ndarray  # feature ids
    obj_rows: np.ndarray  # object ids
    reproj_rows: np.ndarray  # visual factor ids (pg indices)
    bbox_rows: np.ndarray  # object observation factor ids
    relpose_rows: np.ndarray
    shape_rows: np.ndarray
    ltm_rows: np.ndarray
    scope: Scope = None
    # numpy copies of weight vectors (pre-exclusion), for the outlier pass
    base_weights_np: dict = field(default_factory=dict)
    # Device arrays for the fused two-phase re-selection
    # (solver/two_phase.py): LTM membership per object row, shape-prior
    # tombstone mask.
    aux: TwoPhaseAux = None


def camera_bundle_from_pose_graph(pg: PoseGraph, dtype=np.float64):
    """Contiguous camera rows + id map."""
    cam_ids = sorted(pg.cameras)
    idx = {c: i for i, c in enumerate(cam_ids)}
    r = np.stack([pg.cameras[c].extrinsics_r for c in cam_ids])
    t = np.stack([pg.cameras[c].extrinsics_t for c in cam_ids])
    fx = np.array([pg.cameras[c].intrinsics[0, 0] for c in cam_ids])
    fy = np.array([pg.cameras[c].intrinsics[1, 1] for c in cam_ids])
    cx = np.array([pg.cameras[c].intrinsics[0, 2] for c in cam_ids])
    cy = np.array([pg.cameras[c].intrinsics[1, 2] for c in cam_ids])
    return T.make_camera_bundle(r, t, fx, fy, cx, cy, dtype=dtype), idx


def compute_inclusion_weights(
    pg: PoseGraph,
    scope: Scope,
    reproj_rows: np.ndarray,
    bbox_rows: np.ndarray,
    relpose_rows: np.ndarray,
    shape_rows: np.ndarray,
    ltm_rows: np.ndarray,
    excluded: Optional[Set[Tuple[int, int]]] = None,
):
    """0/1 weights implementing the reference's factor-selection rules,
    vectorized over the pose graph's columnar factor views.

    ``excluded``: set of (factor_type, pg_factor_id) outliers (two-phase)."""
    excluded = excluded or set()

    def excluded_ids(ftype):
        ids = [fid for t, fid in excluded if t == ftype]
        return np.asarray(ids, dtype=np.int64)

    vf = pg.visual_factor_columns()
    rp_w = np.ones(len(reproj_rows))
    exc = excluded_ids(REPROJECTION_FACTOR)
    if len(exc):
        rp_w[np.isin(reproj_rows, exc)] = 0.0
    # Min observations per feature (count of live factors in scope), over a
    # compact feature index (np.unique's inverse).
    rp_feat = vf["feature_id"][reproj_rows]
    _, feat_inv = np.unique(rp_feat, return_inverse=True)
    live = rp_w > 0
    feat_count = np.bincount(
        feat_inv[live], minlength=feat_inv.max() + 1 if len(feat_inv) else 0
    )
    if len(reproj_rows):
        rp_w[live & (feat_count[feat_inv] < scope.min_low_level_feature_observations)] = 0.0
    if not scope.include_visual_factors:
        rp_w[:] = 0.0

    # Relpose: only for feature-starved frames (count live factor rows by frame).
    use_relpose = (
        scope.min_low_level_feature_observations_per_frame > 0
        and scope.include_visual_factors
    )
    rl_w = np.zeros(len(relpose_rows))
    if use_relpose and len(relpose_rows):
        rp_frame = vf["frame_id"][reproj_rows]
        live = rp_w > 0
        span = scope.max_frame_id - scope.min_frame_id + 1
        in_span = live & (rp_frame >= scope.min_frame_id) & (rp_frame <= scope.max_frame_id)
        frame_obs = np.bincount(
            (rp_frame[in_span] - scope.min_frame_id), minlength=span
        )
        starved = frame_obs < scope.min_low_level_feature_observations_per_frame

        def frame_starved(fr):
            rel = fr - scope.min_frame_id
            return (rel >= 0) & (rel < span) & starved[np.clip(rel, 0, span - 1)]

        rl = pg.relpose_factor_columns()
        before = rl["before"][relpose_rows]
        after = rl["after"][relpose_rows]
        rl_w[frame_starved(before) | frame_starved(after)] = 1.0
        exc = excluded_ids(RELATIVE_POSE_FACTOR)
        if len(exc):
            rl_w[np.isin(relpose_rows, exc)] = 0.0

    # Objects: min observations or LTM membership.
    oo = pg.object_observation_columns()
    bb_w = np.ones(len(bbox_rows))
    exc = excluded_ids(OBJECT_OBSERVATION_FACTOR)
    if len(exc):
        bb_w[np.isin(bbox_rows, exc)] = 0.0
    included_objects = set()
    if len(bbox_rows):
        bb_obj = oo["object_id"][bbox_rows]
        uniq_obj, obj_inv = np.unique(bb_obj, return_inverse=True)
        obj_count = np.bincount(obj_inv[bb_w > 0], minlength=len(uniq_obj))
        is_ltm = np.array([o in pg.ltm_object_ids for o in uniq_obj])
        # An object needs >= 1 LIVE observation to be included at all (the
        # reference counts only live factors; an LTM object whose every
        # observation was excluded as an outlier must NOT be optimized
        # against its priors alone).
        obj_included = ((obj_count >= scope.min_object_observations) | is_ltm) & (
            obj_count > 0
        )
        included_objects = set(uniq_obj[obj_included].tolist())
        bb_w[(bb_w > 0) & ~obj_included[obj_inv]] = 0.0
    if not scope.include_object_factors:
        bb_w[:] = 0.0
        included_objects = set()

    # Object-only factors for included objects.
    use_object_only = scope.include_object_factors and not scope.fix_objects
    fix_ltm = scope.fix_objects or scope.fix_ltm_objects
    objs_with_object_only = set()
    if use_object_only:
        if fix_ltm:
            objs_with_object_only = {
                o for o in included_objects if o not in pg.ltm_object_ids
            }
        else:
            objs_with_object_only = set(included_objects)
            if scope.force_include_ltm_objs:
                objs_with_object_only |= pg.ltm_object_ids
    oo_arr = np.fromiter(objs_with_object_only, dtype=np.int64, count=len(objs_with_object_only))
    sh_w = np.zeros(len(shape_rows))
    if scope.include_shape_priors and len(shape_rows):
        sp_obj = pg.shape_prior_columns()["object_id"][shape_rows]
        sh_w[np.isin(sp_obj, oo_arr)] = 1.0  # tombstones are -1, never match
    lt_w = np.zeros(len(ltm_rows))
    if len(ltm_rows):
        lt_obj = pg.ltm_factor_columns()["object_id"][ltm_rows]
        lt_w[np.isin(lt_obj, oo_arr)] = 1.0

    return rp_w, bb_w, sh_w, rl_w, lt_w, included_objects, objs_with_object_only


def _registry_rows(registry: dict, kind: str, current_sorted) -> List[int]:
    """Session row assignment: first-appearance order, append-only.

    ``registry`` is a per-session dict (one per caps pool); ids keep their row
    for the whole session so successive global-BA builds produce tables that
    differ only in appended/changed rows — the property the device diff-sync
    exploits. Ids that left the pose graph (merged objects) stay as
    tombstone rows."""
    ids_list = registry.setdefault(kind + "_ids", [])
    id_map = registry.setdefault(kind + "_map", {})
    for i in current_sorted:
        i = int(i)
        if i not in id_map:
            id_map[i] = len(ids_list)
            ids_list.append(i)
    return ids_list


def build_problem(
    pg: PoseGraph,
    scope: Scope,
    residual_params=None,
    excluded: Optional[Set[Tuple[int, int]]] = None,
    dtype=np.float64,
    caps: Optional[dict] = None,
    synthesized_relpose: Optional[list] = None,
    relpose_huber_override: Optional[float] = None,
    to_device: bool = True,
    row_registry: Optional[dict] = None,
) -> Problem:
    """Gather the window into device tables.

    ``residual_params``: config.ResidualParams for Huber deltas (optional).
    ``synthesized_relpose``: list of (before_frame, after_frame, rel_pose6,
    cov6x6) tuples that REPLACE the pose graph's relpose factors — used by
    runPgoPlusEllipsoids, which builds chain factors from current estimates
    (pose_graph_plus_objects_optimizer.h:94-131) rather than from odometry.
    ``relpose_huber_override``: PGO uses its own relpose Huber delta (5.0).
    ``to_device=False``: return numpy arrays (for device_sync diff-upload).
    ``row_registry``: session dict giving features/objects stable
    first-appearance rows (see _registry_rows).
    """
    if not to_device:
        with T.host_build():
            return _build_problem_impl(
                pg, scope, residual_params, excluded, dtype, caps,
                synthesized_relpose, relpose_huber_override, row_registry,
            )
    return _build_problem_impl(
        pg, scope, residual_params, excluded, dtype, caps,
        synthesized_relpose, relpose_huber_override, row_registry,
    )


def _build_problem_impl(
    pg: PoseGraph,
    scope: Scope,
    residual_params,
    excluded,
    dtype,
    caps,
    synthesized_relpose,
    relpose_huber_override,
    row_registry,
) -> Problem:
    cams, cam_idx_map = camera_bundle_from_pose_graph(pg, dtype)

    frames = [
        f for f in pg.frame_ids() if scope.min_frame_id <= f <= scope.max_frame_id
    ]
    pose_row_of = {f: i for i, f in enumerate(frames)}

    # --- factor rows in scope (ALL candidates; inclusion via weights) ------
    reproj_rows = np.array(
        pg.visual_factor_ids_in_window(scope.min_frame_id, scope.max_frame_id),
        dtype=np.int64,
    )
    bbox_rows = np.array(
        pg.obj_obs_ids_in_window(scope.min_frame_id, scope.max_frame_id),
        dtype=np.int64,
    )
    if synthesized_relpose is None:
        relpose_rows = np.array(
            pg.relpose_ids_in_window(scope.min_frame_id, scope.max_frame_id),
            dtype=np.int64,
        )
    else:
        relpose_rows = np.array([], dtype=np.int64)

    # Landmark rows: every feature/object referenced by a candidate factor.
    vf_cols = pg.visual_factor_columns()
    oo_cols = pg.object_observation_columns()
    cur_feat = np.unique(vf_cols["feature_id"][reproj_rows]).tolist()
    cur_obj = set(np.unique(oo_cols["object_id"][bbox_rows]).tolist())
    if scope.force_include_ltm_objs:
        cur_obj |= pg.ltm_object_ids
    cur_obj = sorted(cur_obj)
    if row_registry is not None:
        feat_ids = _registry_rows(row_registry, "feat", cur_feat)
        obj_ids = _registry_rows(row_registry, "obj", cur_obj)
    else:
        feat_ids = cur_feat
        obj_ids = cur_obj
    point_row_of = {f: i for i, f in enumerate(feat_ids)}
    obj_row_of = {o: i for i, o in enumerate(obj_ids)}
    # Tombstones: registry rows whose id left the pose graph (merged-away
    # objects). They keep their row (zero state, not free, no factors).
    dead_obj = (
        [i for i, o in enumerate(obj_ids) if o not in pg.objects]
        if row_registry is not None
        else []
    )

    # Object-only factor rows for the candidate objects.
    shape_rows = []
    for o in obj_ids:
        shape_rows.extend(pg.shape_priors_by_object.get(o, []))
    shape_rows = np.array(sorted(shape_rows), dtype=np.int64)
    ltm_rows = []
    for o in obj_ids:
        ltm_rows.extend(pg.ltm_factors_by_object.get(o, []))
    ltm_rows = np.array(sorted(ltm_rows), dtype=np.int64)

    # --- inclusion weights -------------------------------------------------
    rp_w, bb_w, sh_w, rl_w, lt_w, included_objects, _ = compute_inclusion_weights(
        pg, scope, reproj_rows, bbox_rows, relpose_rows, shape_rows, ltm_rows, excluded
    )
    if synthesized_relpose is not None:
        rl_w = np.ones(len(synthesized_relpose))

    caps = dict(caps or {})
    # Pinned caps are MINIMUMS (session high-water marks for jit-signature
    # stability); the window's actual needs always win.
    rp_cap = max(caps.get("reproj", 0), _bucket(len(reproj_rows)))
    bb_cap = max(caps.get("bbox", 0), _bucket(len(bbox_rows)))
    sh_cap = max(caps.get("shape", 0), _bucket(len(shape_rows)))
    n_rl = len(synthesized_relpose) if synthesized_relpose is not None else len(relpose_rows)
    rl_cap = max(caps.get("relpose", 0), _bucket(n_rl))
    lt_cap = max(caps.get("ltm", 0), _bucket(len(ltm_rows)))

    # --- state arrays ------------------------------------------------------
    # Bucketed like the factor tables: otherwise every window with a new
    # feature count is a fresh jit signature. Padding rows are zeros with
    # free=False — no factor references them, their H blocks hit the
    # singular-guard, and write-back skips non-free rows.
    pose_cap = max(caps.get("n_pose", 0), _bucket(max(len(frames), 1), minimum=8))
    point_cap = max(caps.get("n_point", 0), _bucket(max(len(feat_ids), 1)))
    obj_cap = max(caps.get("n_obj", 0), _bucket(max(len(obj_ids), 1), minimum=8))

    def _pad_rows(rows, cap, width):
        out = np.zeros((cap, width))
        if len(rows):
            out[: len(rows)] = np.stack(rows)
        return out

    poses = _pad_rows([pg.robot_poses[f] for f in frames], pose_cap, 6)
    points = _pad_rows([pg.features[f] for f in feat_ids], point_cap, 3)
    _zeros7 = np.zeros(7)
    objects = _pad_rows(
        [
            pg.objects[o].ellipsoid if o in pg.objects else _zeros7
            for o in obj_ids
        ],
        obj_cap,
        7,
    )
    state = T.BAState(
        poses=_asarray(poses.astype(dtype)),
        points=_asarray(points.astype(dtype)),
        objects=_asarray(objects.astype(dtype)),
    )

    # --- vectorized row-id -> table-row lookups -----------------------------
    # (sorted ids + searchsorted instead of Python dict lookups per factor)
    frames_arr = np.asarray(frames, dtype=np.int64)
    feat_arr = np.asarray(feat_ids, dtype=np.int64)
    obj_arr = np.asarray(obj_ids, dtype=np.int64)
    # Single source of truth for camera-row order: the bundle's own id map
    # (sorted ids, so searchsorted below is valid).
    cam_ids_sorted = np.fromiter(
        (c for c, _ in sorted(cam_idx_map.items(), key=lambda kv: kv[1])),
        dtype=np.int64,
        count=len(cam_idx_map),
    )

    def rows_of(row_ids, ids):
        """Dict-lookup replacement; membership-checked so a factor that
        references a missing pose/feature/object/camera fails loudly at
        build time (like the old per-factor dict KeyError) instead of
        silently indexing a wrong row. ``row_ids`` is the id of each table
        row in ROW order (registry order when a row_registry is active —
        not necessarily sorted)."""
        ids = np.asarray(ids)
        if len(ids) == 0:
            return np.zeros(0, dtype=np.int64)
        if len(row_ids) == 0:
            raise KeyError(
                f"factors reference ids {np.unique(ids)[:10].tolist()} but the "
                "window has no rows of that kind"
            )
        row_ids = np.asarray(row_ids, dtype=np.int64)
        order = np.argsort(row_ids, kind="stable")
        sorted_ids = row_ids[order]
        idx = np.searchsorted(sorted_ids, ids)
        clipped = np.minimum(idx, len(sorted_ids) - 1)
        bad = sorted_ids[clipped] != ids
        if bad.any():
            raise KeyError(
                f"factor references ids absent from the window tables: "
                f"{np.unique(ids[bad])[:10].tolist()}"
            )
        return order[clipped].astype(np.int64)

    # --- reprojection table ------------------------------------------------
    fx = np.asarray(cams.fx)
    fy = np.asarray(cams.fy)
    cx = np.asarray(cams.cx)
    cy = np.asarray(cams.cy)
    rp_pose = rows_of(frames_arr, vf_cols["frame_id"][reproj_rows])
    rp_point = rows_of(feat_arr, vf_cols["feature_id"][reproj_rows])
    rp_cam = rows_of(cam_ids_sorted, vf_cols["camera_id"][reproj_rows])
    px = vf_cols["pixel"][reproj_rows].reshape(-1, 2)
    std = vf_cols["std"][reproj_rows]
    rp_obs = np.stack(
        [(px[:, 0] - cx[rp_cam]) / fx[rp_cam], (px[:, 1] - cy[rp_cam]) / fy[rp_cam]],
        axis=1,
    )
    rp_mult = np.stack([fx[rp_cam] / std, fy[rp_cam] / std], axis=1)
    reproj = T.make_reprojection_factors(
        rp_pose, rp_point, rp_cam, rp_obs, rp_mult, capacity=rp_cap, dtype=dtype
    )

    # --- bbox table --------------------------------------------------------
    bb_obj = rows_of(obj_arr, oo_cols["object_id"][bbox_rows])
    bb_pose = rows_of(frames_arr, oo_cols["frame_id"][bbox_rows])
    bb_cam = rows_of(cam_ids_sorted, oo_cols["camera_id"][bbox_rows])
    crn = oo_cols["corners"][bbox_rows].reshape(-1, 4)
    bb_corners = np.stack(
        [
            (crn[:, 0] - cx[bb_cam]) / fx[bb_cam],
            (crn[:, 1] - cx[bb_cam]) / fx[bb_cam],
            (crn[:, 2] - cy[bb_cam]) / fy[bb_cam],
            (crn[:, 3] - cy[bb_cam]) / fy[bb_cam],
        ],
        axis=1,
    )
    # sqrt-information (cached per factor) times the rectification scale:
    # right-multiplying by diag(fx,fx,fy,fy) scales columns.
    scale_cols = np.stack(
        [fx[bb_cam], fx[bb_cam], fy[bb_cam], fy[bb_cam]], axis=1
    )
    bb_si = oo_cols["sqrt_inf"][bbox_rows].reshape(-1, 4, 4) * scale_cols[:, None, :]
    bbox = T.make_bounding_box_factors(
        bb_obj, bb_pose, bb_cam, bb_corners, bb_si, capacity=bb_cap, dtype=dtype
    )

    # --- shape prior table -------------------------------------------------
    sp_cols = pg.shape_prior_columns()
    sp_obj = rows_of(obj_arr, np.maximum(sp_cols["object_id"][shape_rows], 0))
    shape = T.make_shape_prior_factors(
        sp_obj,
        sp_cols["mean"][shape_rows].reshape(-1, 3),
        sp_cols["sqrt_inf"][shape_rows].reshape(-1, 3, 3),
        capacity=sh_cap, dtype=dtype,
    )

    # --- relpose table -----------------------------------------------------
    if synthesized_relpose is not None:
        rl_b_ids = np.array([s[0] for s in synthesized_relpose], dtype=np.int64)
        rl_a_ids = np.array([s[1] for s in synthesized_relpose], dtype=np.int64)
        rel = np.array([s[2] for s in synthesized_relpose], dtype=np.float64).reshape(
            -1, 6
        )
        covs = np.array([s[3] for s in synthesized_relpose], dtype=np.float64).reshape(
            -1, 6, 6
        )
        rl_t = rel[:, :3]
        # scipy on host — a per-factor jnp exp_so3 here costs a device
        # round-trip per relpose factor in the window builder.
        rl_r = (
            Rotation.from_rotvec(rel[:, 3:6]).as_matrix().reshape(-1, 3, 3)
            if len(rel)
            else np.zeros((0, 3, 3))
        )
        rl_si = batched_sqrt_inf(covs)
    else:
        rl_cols = pg.relpose_factor_columns()
        rl_b_ids = rl_cols["before"][relpose_rows]
        rl_a_ids = rl_cols["after"][relpose_rows]
        rl_t = rl_cols["rel_t"][relpose_rows].reshape(-1, 3)
        rl_r = rl_cols["rel_r"][relpose_rows].reshape(-1, 3, 3)
        rl_si = rl_cols["sqrt_inf"][relpose_rows].reshape(-1, 6, 6)
    relpose = T.make_relative_pose_factors(
        rows_of(frames_arr, rl_b_ids),
        rows_of(frames_arr, rl_a_ids),
        rl_t, rl_r, rl_si,
        capacity=rl_cap, dtype=dtype,
    )

    # --- LTM prior table ---------------------------------------------------
    lt_cols = pg.ltm_factor_columns()
    ltm = T.make_ltm_prior_factors(
        rows_of(obj_arr, lt_cols["object_id"][ltm_rows]),
        lt_cols["mean"][ltm_rows].reshape(-1, 7),
        lt_cols["sqrt_inf"][ltm_rows].reshape(-1, 7, 7),
        capacity=lt_cap, dtype=dtype,
    )

    tables = T.FactorTables(
        reproj=reproj,
        bbox=bbox,
        shape=shape,
        relpose=relpose,
        ltm=ltm,
        param_prior=T.empty_param_prior_factors(dtype=dtype),
    )

    # --- free masks --------------------------------------------------------
    n_pose = state.poses.shape[0]
    pose_free = np.ones(n_pose, dtype=bool)
    pose_free[len(frames):] = False  # state-capacity padding rows
    if scope.fix_poses:
        pose_free[:] = False
    else:
        if scope.min_frame_id == 0:
            if 0 in pose_row_of:
                pose_free[pose_row_of[0]] = False
        else:
            n_const = max(1, scope.poses_prior_to_window_to_keep_constant)
            for k in range(n_const):
                fr = scope.min_frame_id + k
                if fr in pose_row_of:
                    pose_free[pose_row_of[fr]] = False
    point_free = np.ones(state.points.shape[0], dtype=bool)
    point_free[len(feat_ids):] = False
    if scope.fix_visual_features or not feat_ids:
        point_free[:] = False
    obj_free = np.ones(state.objects.shape[0], dtype=bool)
    obj_free[len(obj_ids):] = False
    if scope.fix_objects or not obj_ids:
        obj_free[:] = False
    else:
        if scope.fix_ltm_objects:
            for o in obj_ids:
                if o in pg.ltm_object_ids:
                    obj_free[obj_row_of[o]] = False
        for i in dead_obj:  # merged-away registry tombstones
            obj_free[i] = False
    free = T.FreeMasks(
        poses=_asarray(pose_free),
        points=_asarray(point_free),
        objects=_asarray(obj_free),
    )

    # --- weights -----------------------------------------------------------
    def padv(v, cap):
        out = np.zeros(cap, dtype=dtype)
        out[: len(v)] = v
        return _asarray(out)

    weights = schur_mod.FactorWeights(
        reproj=padv(rp_w, rp_cap),
        bbox=padv(bb_w, bb_cap),
        shape=padv(sh_w, sh_cap),
        relpose=padv(rl_w, rl_cap),
        ltm=padv(lt_w, lt_cap),
    )

    plan_caps = {
        k: caps[k]
        for k in (
            "pt_pair",
            "pt_cross",
            "pt_dest",
            "pt_slot_land",
            "pt_slot_c",
            "ob_pair",
            "ob_cross",
            "ob_dest",
            "ob_slot_land",
            "ob_slot_c",
            "pt_band_lg",
            "rel_band_lg",
        )
        if k in caps
    }
    plan = schur_mod.build_schur_plan_host(
        rp_pose, rp_point, rp_cap, bb_pose, bb_obj, bb_cap, plan_caps or None,
        n_pose=int(state.poses.shape[0]),
        rl_before=rows_of(frames_arr, rl_b_ids),
        rl_after=rows_of(frames_arr, rl_a_ids),
        rl_cap=rl_cap,
    )

    # Fused two-phase auxiliary arrays (object LTM membership per row,
    # shape tombstone mask) — tiny, synced with the tables.
    is_ltm_np = np.zeros(obj_cap, dtype=bool)
    for o in obj_ids:
        if o in pg.ltm_object_ids:
            is_ltm_np[obj_row_of[o]] = True
    shape_live_np = np.zeros(sh_cap, dtype=bool)
    if len(shape_rows):
        shape_live_np[: len(shape_rows)] = (
            pg.shape_prior_columns()["object_id"][shape_rows] >= 0
        )
    aux = TwoPhaseAux(
        is_ltm_obj=_asarray(is_ltm_np), shape_live=_asarray(shape_live_np)
    )

    if residual_params is not None:
        huber = schur_mod.HuberParams(
            reproj=residual_params.reprojection_error_huber_loss_param,
            bbox=residual_params.object_residual_params.object_observation_huber_loss_param,
            shape=residual_params.object_residual_params.shape_dim_prior_factor_huber_loss_param,
            relpose=(
                relpose_huber_override
                if relpose_huber_override is not None
                else residual_params.relative_pose_factor_huber_loss
            ),
            ltm=residual_params.ltm_pair_huber_loss_param,
            invalid_ellipse_error=residual_params.object_residual_params.invalid_ellipsoid_error_val,
        )
    else:
        huber = schur_mod.HuberParams(
            relpose=relpose_huber_override if relpose_huber_override is not None else 1.0
        )

    return Problem(
        state=state,
        cams=cams,
        tables=tables,
        plan=plan,
        free=free,
        weights=weights,
        huber=huber,
        aux=aux,
        pose_rows=np.array(frames, dtype=np.int64),
        point_rows=np.array(feat_ids, dtype=np.int64),
        obj_rows=np.array(obj_ids, dtype=np.int64),
        reproj_rows=reproj_rows,
        bbox_rows=bbox_rows,
        relpose_rows=relpose_rows,
        shape_rows=shape_rows,
        ltm_rows=ltm_rows,
        scope=scope,
        base_weights_np={
            "reproj": rp_w,
            "bbox": bb_w,
            "shape": sh_w,
            "relpose": rl_w,
            "ltm": lt_w,
        },
    )


def observed_caps(problem: "Problem") -> dict:
    """The capacities a built Problem actually used, as a caps dict.

    Callers that build problems repeatedly (the per-frame runner, PGO)
    max-accumulate these into a session pool and pass the pool back as
    ``caps`` — capacities then grow monotonically, so the jit signature
    changes only on high-water growth (O(log) recompiles per session)
    instead of per window."""
    p, t = problem.plan, problem.tables
    return {
        "reproj": t.reproj.mask.shape[0],
        "bbox": t.bbox.mask.shape[0],
        "shape": t.shape.mask.shape[0],
        "relpose": t.relpose.mask.shape[0],
        "ltm": t.ltm.mask.shape[0],
        "n_pose": problem.state.poses.shape[0],
        "n_point": problem.state.points.shape[0],
        "n_obj": problem.state.objects.shape[0],
        "pt_pair": p.pt_pair_pose.shape[0],
        "pt_cross": p.pt_cross_a.shape[0],
        "pt_dest": p.pt_dest_a.shape[0],
        "pt_slot_land": p.pt_slot_gather.shape[0],
        "pt_slot_c": p.pt_slot_gather.shape[1],
        "ob_pair": p.ob_pair_pose.shape[0],
        "ob_cross": p.ob_cross_a.shape[0],
        "ob_dest": p.ob_dest_a.shape[0],
        "ob_slot_land": p.ob_slot_gather.shape[0],
        "ob_slot_c": p.ob_slot_gather.shape[1],
        "pt_band_lg": (
            p.pt_band_local_pose.shape[1]
            if p.pt_band_local_pose is not None
            else 0
        ),
        "rel_band_lg": (
            p.rel_band_local_pose.shape[1]
            if p.rel_band_local_pose is not None
            else 0
        ),
    }


def update_caps_pool(pool: dict, problem: "Problem") -> dict:
    """Max-accumulate a Problem's observed capacities into ``pool``."""
    for k, v in observed_caps(problem).items():
        pool[k] = max(pool.get(k, 0), int(v))
    return pool


def reweight_for_exclusions(
    pg: PoseGraph, problem: Problem, excluded: Set[Tuple[int, int]]
) -> schur_mod.FactorWeights:
    """Phase-2 weights: recompute inclusion with outliers removed (the
    reference rebuilds the problem with the exclusion set; we only swap the
    weight vectors — same math, no rebuild)."""
    rp_w, bb_w, sh_w, rl_w, lt_w, _, _ = compute_inclusion_weights(
        pg,
        problem.scope,
        problem.reproj_rows,
        problem.bbox_rows,
        problem.relpose_rows,
        problem.shape_rows,
        problem.ltm_rows,
        excluded,
    )
    dtype = problem.state.poses.dtype

    def padv(v, cap):
        out = np.zeros(cap, dtype=dtype)
        out[: len(v)] = v
        return _asarray(out)

    return schur_mod.FactorWeights(
        reproj=padv(rp_w, problem.tables.reproj.capacity),
        bbox=padv(bb_w, problem.tables.bbox.capacity),
        shape=padv(sh_w, problem.tables.shape.capacity),
        relpose=padv(rl_w, problem.tables.relpose.capacity),
        ltm=padv(lt_w, problem.tables.ltm.capacity),
    )


def write_back(pg: PoseGraph, problem: Problem, state: T.BAState):
    """Write optimized values back into the pose graph (free blocks only —
    constant blocks are unchanged by construction but we skip them anyway).

    Returns the fetched host (poses, points, objects) so callers can adopt
    them into a DeviceSync cache (the solved state then diffs clean against
    the next build)."""
    # ONE batched device->host transfer (six sequential np.asarray reads
    # cost six round trips).
    import jax

    poses, points, objects, pose_free, point_free, obj_free = jax.device_get((
        state.poses, state.points, state.objects,
        problem.free.poses, problem.free.points, problem.free.objects,
    ))
    for i, frame in enumerate(problem.pose_rows):
        if pose_free[i]:
            pg.robot_poses[int(frame)] = poses[i].copy()
    for i, feat in enumerate(problem.point_rows):
        if point_free[i]:
            pg.features[int(feat)] = points[i].copy()
    for i, obj in enumerate(problem.obj_rows):
        if obj_free[i]:
            pg.objects[int(obj)].ellipsoid = objects[i].copy()
    return poses, points, objects
