"""Long-term object map: extraction, serialization, next-session seeding.

Re-design of the reference LTM subsystem
(``long_term_object_map.h``, ``long_term_object_map_extraction.h/.cpp``,
``long_term_map_factor_creator.h``):

  extraction (end of session):
    - drop features whose min distance to any observing pose exceeds
      ``far_feature_threshold`` (75m) (extraction.cpp:122-183)
    - full-trajectory problem with shape priors EXCLUDED and LTM objects
      force-included (extraction.cpp:68-79)
    - per-object 7x7 marginal covariance from the undamped robustified
      Hessian (Schur point-elimination + dense inverse on device — replaces
      ceres::Covariance + SuiteSparseQR)
    - rank deficiency repair: Jacobian columns with norm < min_col_norm get a
      weak scalar prior with 1/std = sqrt(min_col_norm - col_norm), then
      retry (extraction.cpp:761-922)
    - on failure, fall back to the previous session's map
      (offline_object_visual_slam_main.cpp:1058-1068)

  next session:
    - LTM ellipsoids pre-inserted in the pose graph with known ids
      (main.cpp:200-229) and one unary prior factor per observed LTM object
      (long_term_map_factor_creator.h:246-323)
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from obvi_slam_tpu import config as cfg
from obvi_slam_tpu import solver as slv
from obvi_slam_tpu.pose_graph import PoseGraph
from obvi_slam_tpu.solver.problem import Scope, build_problem
from obvi_slam_tpu.timing import timer

logger = logging.getLogger(__name__)


@dataclass
class LongTermObjectMap:
    """IndependentEllipsoidsLongTermObjectMap (long_term_object_map.h:83-104)."""

    # obj_id -> (semantic_class, ellipsoid 7-vec)
    ellipsoids: Dict[int, tuple] = field(default_factory=dict)
    # obj_id -> 7x7 covariance
    covariances: Dict[int, np.ndarray] = field(default_factory=dict)
    # obj_id -> frontend appearance payload (empty dict for feature-based FE)
    front_end_data: Dict[int, dict] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "ellipsoids": {
                str(k): [cls, np.asarray(e).tolist()]
                for k, (cls, e) in self.ellipsoids.items()
            },
            "covariances": {
                str(k): np.asarray(c).tolist() for k, c in self.covariances.items()
            },
            "front_end_data": {str(k): v for k, v in self.front_end_data.items()},
        }

    @classmethod
    def from_json(cls, d: dict) -> "LongTermObjectMap":
        return cls(
            ellipsoids={
                int(k): (v[0], np.array(v[1])) for k, v in d["ellipsoids"].items()
            },
            covariances={
                int(k): np.array(v) for k, v in d["covariances"].items()
            },
            front_end_data={int(k): v for k, v in d["front_end_data"].items()},
        )

    def save(self, path: str):
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path: str) -> "LongTermObjectMap":
        with open(path) as f:
            return cls.from_json(json.load(f))


def far_feature_ids(pg: PoseGraph, threshold: float):
    """Features whose MIN distance to any observing pose exceeds threshold
    (extraction.cpp:122-183)."""
    far = set()
    for feat_id, pos in pg.features.items():
        min_dist = np.inf
        for fid in pg.visual_factors_by_feature.get(feat_id, []):
            frame = pg.visual_factors[fid].frame_id
            pose = pg.get_robot_pose(frame)
            if pose is None:
                continue
            min_dist = min(min_dist, float(np.linalg.norm(pos - pose[:3])))
        if min_dist > threshold:
            far.add(feat_id)
    return far


def find_rank_deficiencies(red_h, state_np, min_col_norm):
    """Null-space identification on the reduced (poses+objects) Hessian.

    Device-side counterpart of the reference's SuiteSparseQR rank analysis
    (``findRankDeficiencies``, long_term_object_map_extraction.cpp:507-760):
    instead of QR-factoring J^T and reading off deficient columns, we
    eigendecompose the symmetric reduced Hessian H = J^T J (points already
    eliminated) and treat eigenvectors of near-zero eigenvalues as the null
    space. Unlike a per-column norm check, this sees deficiencies that are
    linear COMBINATIONS of columns (e.g. a pose observed only through one
    bounding-box factor: every column has healthy norm, but rank(J_block) <
    #params).

    An eigendirection is deficient when sqrt(lambda) — the effective Jacobian
    column norm along that direction — is below ``min_col_norm``, or when
    lambda is numerically zero relative to the spectrum (eigh noise floor).
    Each participating parameter (|v_i| above 10% of the eigenvector's max)
    gets a weak scalar prior with the reference's repair strength
    1/std = sqrt(min_col_norm - col_norm) (extraction.cpp:816-876), floored
    at sqrt(min_col_norm/2) so numerically-null directions are still lifted.

    Runs on host in f64 (once per session; the device solve dominates
    extraction time). Returns [(kind_code, row, param_idx, mean, inv_std)].
    """
    dim = red_h.shape[0]
    n_pose = state_np["pose"].shape[0]
    lam, vec = np.linalg.eigh(0.5 * (red_h + red_h.T))
    lam_max = float(lam[-1]) if dim else 0.0
    thr = max(min_col_norm**2, lam_max * 1e-12)
    deficient = {}
    for k in range(dim):
        if lam[k] >= thr:
            break
        col_norm = float(np.sqrt(max(lam[k], 0.0)))
        inv_std = float(
            np.sqrt(max(min_col_norm - col_norm, 0.5 * min_col_norm))
        )
        v = np.abs(vec[:, k])
        involved = np.nonzero(v > 0.1 * v.max())[0]
        for idx in involved:
            idx = int(idx)
            if idx < n_pose * 6:
                key = (0, idx // 6, idx % 6)
                mean = float(state_np["pose"][idx // 6, idx % 6])
            else:
                o = idx - n_pose * 6
                key = (2, o // 7, o % 7)
                mean = float(state_np["object"][o // 7, o % 7])
            # Strongest repair wins if a param joins several null directions.
            prev = deficient.get(key)
            if prev is None or prev[1] < inv_std:
                deficient[key] = (mean, inv_std)
    return [
        (k[0], k[1], k[2], mean, inv_std)
        for k, (mean, inv_std) in sorted(deficient.items())
    ]


def extract_long_term_object_map(
    pg: PoseGraph,
    config: cfg.FullOVSLAMConfig,
    front_end_data: Optional[Dict[int, dict]] = None,
    prev_ltm: Optional[LongTermObjectMap] = None,
    dtype=np.float64,
    caps: Optional[dict] = None,
) -> Optional[LongTermObjectMap]:
    """extractLongTermObjectMap (long_term_object_map_extraction.h:433-527).

    ``caps``: session capacity pool (the runner's "global" pool) so the
    extraction problem shares the session's presized jit signature — the
    marginal-covariance program can then be pre-compiled during the online
    phase instead of cold-compiling at the end of the run."""
    with timer("ltm_extraction"):
        ltm = _extract(pg, config, front_end_data, dtype, caps)
    if ltm is None:
        if (
            config.ltm_tunable_params.fallback_to_prev_for_failed_extraction
            and prev_ltm is not None
        ):
            logger.warning("LTM extraction failed; falling back to previous map")
            return prev_ltm
        return None
    return ltm


def _extraction_scope(max_frame, config) -> Scope:
    """The extraction problem's scope (extraction.cpp:68-79): whole
    trajectory, shape priors excluded, LTM objects force-included."""
    en = config.optimization_factors_enabled_params
    return Scope(
        min_frame_id=0,
        max_frame_id=max_frame,
        include_object_factors=True,
        include_visual_factors=True,
        poses_prior_to_window_to_keep_constant=en.poses_prior_to_window_to_keep_constant,
        min_object_observations=en.min_object_observations,
        min_low_level_feature_observations=en.min_low_level_feature_observations,
        min_low_level_feature_observations_per_frame=en.min_low_level_feature_observations_per_frame,
        force_include_ltm_objs=True,
        include_shape_priors=False,  # extraction.cpp:68-69
    )


def warm_marginal_covariance_program(pg, config, caps, dtype=np.float64):
    """Prepare an ahead-of-time compile of the extraction's
    marginal-covariance program at the presized session signature.

    Returns a zero-arg callable meant for a background thread at session
    START (the CLI does this): with the caps pool presized from raw session
    counts (runner.presize_session_caps) the end-of-session extraction
    problem's shapes are already known, so a zero-row dummy problem built at
    those capacities compiles the IDENTICAL program. The extraction then
    hits the in-process jit cache instead of cold-compiling after the whole
    run.

    The dummy problem is built HERE, on the caller's thread (the pose graph
    is mutated by the frame loop and must not be read concurrently); the
    returned callable touches only its own arrays and the jax compile
    caches, so it is safe to run concurrently with the optimization loop."""
    problem = build_problem(
        pg,
        _extraction_scope(max(pg.max_frame_id(), 0), config),
        config.ltm_solver_residual_params,
        dtype=dtype,
        caps=caps,
    )

    def compile_now():
        covs, h_diag, ok, _ = slv.schur.compute_marginal_covariances(
            problem.state,
            problem.cams,
            problem.tables,
            problem.plan,
            problem.free,
            problem.weights,
            problem.huber,
            return_reduced_hessian=True,
        )
        bool(ok)  # fence: force execution so the compile fully lands

    return compile_now


def _ensure_psd_covs(covs, red_h, n_pose, min_col_norm):
    """Guarantee PSD object covariance blocks before they are serialized.

    The device path inverts the reduced system densely; when the system is
    rank-deficient past what the repair loop identified, that inverse is
    garbage with large mixed-sign eigenvalues (observed: -2e11 vs +6e14 on
    a rank-3-deficient 8-frame session) — downstream whitening
    (pose_graph.batched_sqrt_inf) would raise when the next session seeds
    from the map. If any block is non-PSD beyond f64 roundoff, recompute
    ALL object blocks from the reduced Hessian's eigendecomposition with
    near-null eigenvalues clamped to min_col_norm**2 — numerically
    identical to priors of strength min_col_norm on exactly the null
    directions (the reference's repair semantics,
    extraction.cpp:816-922), and PSD by construction."""
    if covs.size == 0:
        return covs
    finite = np.all(np.isfinite(covs))
    if finite:
        sym = 0.5 * (covs + np.transpose(covs, (0, 2, 1)))
        w = np.linalg.eigvalsh(sym)
        # Healthy PSD inverses carry only O(eps)-relative negative
        # eigenvalues from roundoff.
        tol = -1e-12 * np.abs(w).max(axis=-1, keepdims=True)
        if not np.any(w <= tol):
            return covs
    logger.warning(
        "LTM covariances non-PSD from dense inverse; recomputing via "
        "clamped eigen pseudo-inverse of the reduced Hessian"
    )
    if not np.all(np.isfinite(red_h)):
        return None
    lam, vec = np.linalg.eigh(0.5 * (red_h + red_h.T))
    thr = float(min_col_norm) ** 2
    lam_inv = 1.0 / np.maximum(lam, thr)
    cov_full = (vec * lam_inv) @ vec.T
    n_obj = covs.shape[0]
    out = np.empty_like(covs)
    base = n_pose * 6
    for i in range(n_obj):
        blk = cov_full[base + 7 * i : base + 7 * (i + 1),
                       base + 7 * i : base + 7 * (i + 1)]
        out[i] = 0.5 * (blk + blk.T)
    return out


def _extract(pg, config, front_end_data, dtype, caps=None):
    max_frame = pg.max_frame_id()
    if max_frame < 0 or not pg.objects:
        return LongTermObjectMap(
            ellipsoids={
                o: (n.semantic_class, n.ellipsoid.copy()) for o, n in pg.objects.items()
            },
            covariances={},
            front_end_data=front_end_data or {},
        )

    scope = _extraction_scope(max_frame, config)
    problem = build_problem(
        pg, scope, config.ltm_solver_residual_params, dtype=dtype, caps=caps
    )

    # Far-feature filter: zero the weights of their reprojection factors.
    far = far_feature_ids(pg, config.ltm_tunable_params.far_feature_threshold)
    weights = problem.weights
    if far:
        rp_w = np.asarray(weights.reproj).copy()
        for i, fid in enumerate(problem.reproj_rows):
            if pg.visual_factors[fid].feature_id in far:
                rp_w[i] = 0.0
        import jax.numpy as jnp

        weights = weights._replace(reproj=jnp.asarray(rp_w))

    covs, h_diag, ok, red_h = slv.schur.compute_marginal_covariances(
        problem.state,
        problem.cams,
        problem.tables,
        problem.plan,
        problem.free,
        weights,
        problem.huber,
        return_reduced_hessian=True,
    )
    ok = bool(ok)

    min_col_norm = config.ltm_tunable_params.min_col_norm
    state_np = {
        "pose": np.asarray(problem.state.poses),
        "object": np.asarray(problem.state.objects),
    }
    deficient = find_rank_deficiencies(
        np.asarray(red_h, np.float64), state_np, min_col_norm
    )

    if (not ok) or deficient:
        # Repair ONLY the identified null-space params with weak scalar
        # priors and retry (extraction.cpp:761-922). No global ridge and no
        # all-object-params rescue: those silently shrink every reported
        # covariance; if the eigen analysis found nothing and the inverse is
        # still non-finite, extraction genuinely failed -> previous-map
        # fallback (main.cpp:1058-1068).
        if not deficient:
            return None
        from obvi_slam_tpu import types as T

        pp = T.make_param_prior_factors(
            [d[0] for d in deficient],
            [d[1] for d in deficient],
            [d[2] for d in deficient],
            [d[3] for d in deficient],
            [d[4] for d in deficient],
            dtype=dtype,
        )
        tables = problem.tables._replace(param_prior=pp)
        covs, h_diag, ok = slv.schur.compute_marginal_covariances(
            problem.state,
            problem.cams,
            tables,
            problem.plan,
            problem.free,
            weights,
            problem.huber,
        )
        if not bool(ok):
            return None

    covs = np.asarray(covs)
    covs = _ensure_psd_covs(
        covs, np.asarray(red_h, np.float64), state_np["pose"].shape[0],
        min_col_norm,
    )
    if covs is None:
        return None
    ellipsoids = {}
    covariances = {}
    obj_row_of = {int(o): i for i, o in enumerate(problem.obj_rows)}
    for obj_id, node in pg.objects.items():
        ellipsoids[obj_id] = (node.semantic_class, node.ellipsoid.copy())
        if obj_id in obj_row_of:
            covariances[obj_id] = covs[obj_row_of[obj_id]]
        else:
            # Object had no factors in the extraction problem (shouldn't
            # happen with force-include, but stay safe).
            covariances[obj_id] = np.eye(7)
    return LongTermObjectMap(
        ellipsoids=ellipsoids,
        covariances=covariances,
        front_end_data=front_end_data or {},
    )


def seed_pose_graph_from_ltm(pg: PoseGraph, ltm: LongTermObjectMap):
    """Pre-insert LTM ellipsoids with known ids + one unary prior factor each
    (main.cpp:200-229 + long_term_map_factor_creator.h:246-323)."""
    for obj_id, (semantic_class, ellipsoid) in ltm.ellipsoids.items():
        pg.add_ltm_object(obj_id, ellipsoid, semantic_class)
        cov = ltm.covariances.get(obj_id)
        if cov is not None:
            pg.add_ltm_factor(obj_id, ellipsoid, cov)
