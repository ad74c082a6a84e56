"""Configuration system: a dataclass mirror of FullOVSLAMConfig.

Reads the reference's JSON config files directly (schema v12-14,
``include/refactoring/configuration/full_ov_slam_config.h:155-239``,
serialized by OpenCV FileStorage — plain JSON with ``{Rows, Cols, Data}``
matrix blobs and string-encoded uint64s, e.g. ``config/base7a_1_fallback_a_2.json``).

Field names follow the reference (minus the trailing underscore) so the 130+
existing experiment configs remain the single source of tuning truth.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


def _mat(node) -> np.ndarray:
    """Decode an OpenCV FileStorage matrix node {Rows, Cols, Data}."""
    if isinstance(node, dict) and "Data" in node:
        return np.array(node["Data"], dtype=np.float64).reshape(
            int(node["Rows"]), int(node["Cols"])
        )
    return np.asarray(node, dtype=np.float64)


def _mat_to_node(m: np.ndarray) -> dict:
    m = np.atleast_2d(np.asarray(m, dtype=np.float64))
    return {"Rows": int(m.shape[0]), "Cols": int(m.shape[1]), "Data": m.ravel().tolist()}


def _i(v) -> int:
    return int(v)


def _b(v) -> bool:
    return bool(int(v))


@dataclass
class OptimizationSolverParams:
    """optimization_solver_params.h:17-23."""

    max_num_iterations: int = 100
    allow_non_monotonic_steps: bool = False
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16

    @classmethod
    def from_json(cls, d):
        return cls(
            max_num_iterations=_i(d["max_num_iterations"]),
            allow_non_monotonic_steps=_b(d["allow_non_monotonic_steps"]),
            function_tolerance=float(d["function_tolerance"]),
            gradient_tolerance=float(d["gradient_tolerance"]),
            parameter_tolerance=float(d["parameter_tolerance"]),
            initial_trust_region_radius=float(d["initial_trust_region_radius"]),
            max_trust_region_radius=float(d["max_trust_region_radius"]),
        )

    def to_json(self):
        return {
            "max_num_iterations": self.max_num_iterations,
            "allow_non_monotonic_steps": int(self.allow_non_monotonic_steps),
            "function_tolerance": self.function_tolerance,
            "gradient_tolerance": self.gradient_tolerance,
            "parameter_tolerance": self.parameter_tolerance,
            "initial_trust_region_radius": self.initial_trust_region_radius,
            "max_trust_region_radius": self.max_trust_region_radius,
        }


@dataclass
class OptimizationIterationParams:
    allow_reversion_after_detecting_jumps: bool = True
    consecutive_pose_transl_tol: float = 1.0
    consecutive_pose_orient_tol: float = math.pi
    feature_outlier_percentage: float = 0.1
    phase_one_opt_params: OptimizationSolverParams = field(
        default_factory=OptimizationSolverParams
    )
    phase_two_opt_params: OptimizationSolverParams = field(
        default_factory=OptimizationSolverParams
    )

    @classmethod
    def from_json(cls, d):
        return cls(
            allow_reversion_after_detecting_jumps=_b(
                d["allow_reversion_after_detecting_jumps"]
            ),
            consecutive_pose_transl_tol=float(d["consecutive_pose_transl_tol"]),
            consecutive_pose_orient_tol=float(d["consecutive_pose_orient_tol"]),
            feature_outlier_percentage=float(d["feature_outlier_percentage"]),
            phase_one_opt_params=OptimizationSolverParams.from_json(
                d["phase_one_opt_params"]
            ),
            phase_two_opt_params=OptimizationSolverParams.from_json(
                d["phase_two_opt_params"]
            ),
        )

    def to_json(self):
        return {
            "allow_reversion_after_detecting_jumps": int(
                self.allow_reversion_after_detecting_jumps
            ),
            "consecutive_pose_transl_tol": self.consecutive_pose_transl_tol,
            "consecutive_pose_orient_tol": self.consecutive_pose_orient_tol,
            "feature_outlier_percentage": self.feature_outlier_percentage,
            "phase_one_opt_params": self.phase_one_opt_params.to_json(),
            "phase_two_opt_params": self.phase_two_opt_params.to_json(),
        }


@dataclass
class VisualFeatureParams:
    reprojection_error_std_dev: float = 1.0
    min_visual_feature_parallax_pixel_requirement: float = 5.0
    min_visual_feature_parallax_robot_transl_requirement: float = 0.1
    min_visual_feature_parallax_robot_orient_requirement: float = 0.05
    enforce_min_pixel_parallax_requirement: bool = True
    enforce_min_robot_pose_parallax_requirement: bool = False
    inlier_epipolar_err_thresh: float = 8.0
    check_past_n_frames_for_epipolar_err: int = 5
    enforce_epipolar_error_requirement: bool = True

    @classmethod
    def from_json(cls, d):
        return cls(
            reprojection_error_std_dev=float(d["reprojection_error_std_dev"]),
            min_visual_feature_parallax_pixel_requirement=float(
                d["min_visual_feature_parallax_pixel_requirement"]
            ),
            min_visual_feature_parallax_robot_transl_requirement=float(
                d["min_visual_feature_parallax_robot_transl_requirement"]
            ),
            min_visual_feature_parallax_robot_orient_requirement=float(
                d["min_visual_feature_parallax_robot_orient_requirement"]
            ),
            enforce_min_pixel_parallax_requirement=_b(
                d["enforce_min_pixel_parallax_requirement"]
            ),
            enforce_min_robot_pose_parallax_requirement=_b(
                d["enforce_min_robot_pose_parallax_requirement"]
            ),
            inlier_epipolar_err_thresh=float(d["inlier_epipolar_err_thresh"]),
            check_past_n_frames_for_epipolar_err=_i(
                d["check_past_n_frames_for_epipolar_err"]
            ),
            enforce_epipolar_error_requirement=_b(
                d["enforce_epipolar_error_requirement_"]
            ),
        )


@dataclass
class RelativePoseCovParams:
    """generateOdomCov multipliers (optimization_runner.h:341-352)."""

    transl_error_mult_for_transl_error: float = 0.025
    transl_error_mult_for_rot_error: float = 0.025
    rot_error_mult_for_transl_error: float = 0.025
    rot_error_mult_for_rot_error: float = 0.025

    @classmethod
    def from_json(cls, d):
        return cls(
            transl_error_mult_for_transl_error=float(
                d["transl_error_mult_for_transl_error"]
            ),
            transl_error_mult_for_rot_error=float(d["transl_error_mult_for_rot_error"]),
            rot_error_mult_for_transl_error=float(d["rot_error_mult_for_transl_error"]),
            rot_error_mult_for_rot_error=float(d["rot_error_mult_for_rot_error"]),
        )


@dataclass
class ObjectResidualParams:
    object_observation_huber_loss_param: float = 0.5
    shape_dim_prior_factor_huber_loss_param: float = 10.0
    invalid_ellipsoid_error_val: float = 1e6

    @classmethod
    def from_json(cls, d):
        return cls(
            object_observation_huber_loss_param=float(
                d["object_observation_huber_loss_param"]
            ),
            shape_dim_prior_factor_huber_loss_param=float(
                d["shape_dim_prior_factor_huber_loss_param"]
            ),
            invalid_ellipsoid_error_val=float(d["invalid_ellipsoid_error_val"]),
        )


@dataclass
class ResidualParams:
    """object_visual_pose_graph_residual_params."""

    object_residual_params: ObjectResidualParams = field(
        default_factory=ObjectResidualParams
    )
    reprojection_error_huber_loss_param: float = 1.0
    ltm_pair_huber_loss_param: float = 1.0
    relative_pose_factor_huber_loss: float = 1.0
    relative_pose_cov_params: RelativePoseCovParams = field(
        default_factory=RelativePoseCovParams
    )

    @classmethod
    def from_json(cls, d):
        return cls(
            object_residual_params=ObjectResidualParams.from_json(
                d["object_residual_params"]
            ),
            reprojection_error_huber_loss_param=float(
                d["visual_residual_params"]["reprojection_error_huber_loss_param"]
            ),
            ltm_pair_huber_loss_param=float(
                d["long_term_map_params"]["pair_huber_loss_param"]
            ),
            relative_pose_factor_huber_loss=float(
                d["relative_pose_factor_huber_loss"]
            ),
            relative_pose_cov_params=RelativePoseCovParams.from_json(
                d["relative_pose_cov_params"]
            ),
        )


@dataclass
class PgoSolverParams:
    relative_pose_factor_huber_loss: float = 5.0
    enable_visual_feats_only_opt_post_pgo: bool = True
    enable_visual_non_opt_feature_adjustment_post_pgo: bool = True
    relative_pose_cov_params: RelativePoseCovParams = field(
        default_factory=RelativePoseCovParams
    )
    pgo_optimization_solver_params: OptimizationSolverParams = field(
        default_factory=OptimizationSolverParams
    )
    final_pgo_optimization_solver_params: OptimizationSolverParams = field(
        default_factory=OptimizationSolverParams
    )
    post_pgo_vf_adjustment_solver_params: OptimizationSolverParams = field(
        default_factory=OptimizationSolverParams
    )
    final_post_pgo_vf_adjustment_solver_params: OptimizationSolverParams = field(
        default_factory=OptimizationSolverParams
    )
    pre_pgo_tracking_solver_params: OptimizationSolverParams = field(
        default_factory=OptimizationSolverParams
    )

    @classmethod
    def from_json(cls, d, local_phase_two=None, final_phase_two=None):
        """Older schemas (v12) lack the tracking / vf-adjustment solver params;
        write_configuration.cpp:229-234 derives them from local/final
        phase-two params, which we replicate as the fallback."""
        fallback_local = (
            OptimizationSolverParams.from_json(d["post_pgo_vf_adjustment_solver_params"])
            if "post_pgo_vf_adjustment_solver_params" in d
            else (local_phase_two or OptimizationSolverParams())
        )
        fallback_final = (
            OptimizationSolverParams.from_json(
                d["final_post_pgo_vf_adjustment_solver_params"]
            )
            if "final_post_pgo_vf_adjustment_solver_params" in d
            else (final_phase_two or OptimizationSolverParams())
        )
        tracking = (
            OptimizationSolverParams.from_json(d["pre_pgo_tracking_solver_params"])
            if "pre_pgo_tracking_solver_params" in d
            else (local_phase_two or OptimizationSolverParams())
        )
        return cls(
            relative_pose_factor_huber_loss=float(d["relative_pose_factor_huber_loss"]),
            enable_visual_feats_only_opt_post_pgo=_b(
                d["enable_visual_feats_only_opt_post_pgo"]
            ),
            enable_visual_non_opt_feature_adjustment_post_pgo=_b(
                d["enable_visual_non_opt_feature_adjustment_post_pgo"]
            ),
            relative_pose_cov_params=RelativePoseCovParams.from_json(
                d["relative_pose_cov_params"]
            ),
            pgo_optimization_solver_params=OptimizationSolverParams.from_json(
                d["pgo_optimization_solver_params"]
            ),
            final_pgo_optimization_solver_params=OptimizationSolverParams.from_json(
                d["final_pgo_optimization_solver_params"]
            ),
            post_pgo_vf_adjustment_solver_params=fallback_local,
            final_post_pgo_vf_adjustment_solver_params=fallback_final,
            pre_pgo_tracking_solver_params=tracking,
        )


@dataclass
class LtmTunableParams:
    far_feature_threshold: float = 75.0
    min_col_norm: float = 5e-9
    fallback_to_prev_for_failed_extraction: bool = True

    @classmethod
    def from_json(cls, d):
        # fallback_to_prev... appeared in schema v12 (older configs lack it;
        # the reference defaults it to true).
        return cls(
            far_feature_threshold=float(d["far_feature_threshold"]),
            min_col_norm=float(d["min_col_norm"]),
            fallback_to_prev_for_failed_extraction=_b(
                d.get("fallback_to_prev_for_failed_extraction", 1)
            ),
        )


@dataclass
class ShapeDimensionPrior:
    semantic_class: str
    mean: np.ndarray  # (3,)
    covariance: np.ndarray  # (3, 3)


@dataclass
class GeometricSimilarityScorerParams:
    max_merge_distance: float = 4.0
    x_y_only_merge: bool = True

    @classmethod
    def from_json(cls, d):
        # x_y_only_merge appeared after schema v11; reference default False.
        return cls(
            max_merge_distance=float(d["max_merge_distance"]),
            x_y_only_merge=_b(d.get("x_y_only_merge", 0)),
        )


@dataclass
class PendingObjectEstimatorParams:
    object_residual_params: ObjectResidualParams = field(
        default_factory=lambda: ObjectResidualParams(invalid_ellipsoid_error_val=1e3)
    )
    solver_params: OptimizationSolverParams = field(
        default_factory=lambda: OptimizationSolverParams(max_num_iterations=500)
    )

    @classmethod
    def from_json(cls, d):
        return cls(
            object_residual_params=ObjectResidualParams.from_json(
                d["object_residual_params"]
            ),
            solver_params=OptimizationSolverParams.from_json(d["solver_params"]),
        )


@dataclass
class FeatureBasedBbAssociationParams:
    """feature_based_bounding_box_front_end.h:44-86."""

    min_observations_for_local_est: int = 3
    min_observations: int = 10
    discard_candidate_after_num_frames: int = 40
    min_bb_confidence: float = 0.2
    required_min_conf_for_initialization: float = 0.0
    min_overlapping_features_for_match: float = 3.0
    feature_validity_window: int = 20
    bounding_box_inflation_size: float = 10.0
    pending_obj_estimator_params: PendingObjectEstimatorParams = field(
        default_factory=PendingObjectEstimatorParams
    )

    @classmethod
    def from_json(cls, d):
        return cls(
            min_observations_for_local_est=_i(d["min_observations_for_local_est"]),
            min_observations=_i(d["min_observations"]),
            discard_candidate_after_num_frames=_i(
                d["discard_candidate_after_num_frames"]
            ),
            min_bb_confidence=float(d["min_bb_confidence"]),
            required_min_conf_for_initialization=float(
                d["required_min_conf_for_initialization"]
            ),
            min_overlapping_features_for_match=float(
                d["min_overlapping_features_for_match"]
            ),
            feature_validity_window=_i(d["feature_validity_window"]),
            bounding_box_inflation_size=float(d["bounding_box_inflation_size"]),
            pending_obj_estimator_params=PendingObjectEstimatorParams.from_json(
                d["pending_obj_estimator_params"]
            ),
        )


@dataclass
class BoundingBoxCovGenParams:
    """bounding_box_front_end_creation_utils.h:14-103."""

    bounding_box_cov: np.ndarray = field(
        default_factory=lambda: np.diag([900.0] * 4)
    )
    near_edge_threshold: float = 25.0
    image_boundary_variance: float = 4e4

    @classmethod
    def from_json(cls, d):
        return cls(
            bounding_box_cov=_mat(d["bounding_box_cov"]),
            near_edge_threshold=float(d["near_edge_threshold"]),
            image_boundary_variance=float(d["image_boundary_variance"]),
        )


@dataclass
class SlidingWindowParams:
    global_ba_frequency: int = 30
    local_ba_window_size: int = 50

    @classmethod
    def from_json(cls, d):
        return cls(
            global_ba_frequency=_i(d["global_ba_frequency"]),
            local_ba_window_size=_i(d["local_ba_window_size"]),
        )


@dataclass
class OptimizationFactorsEnabledParams:
    """optimization_factors_enabled_params.h:12-51."""

    min_low_level_feature_observations_per_frame: int = 50
    include_object_factors: bool = True
    include_visual_factors: bool = True
    fix_poses: bool = False
    fix_objects: bool = False
    fix_visual_features: bool = False
    fix_ltm_objects: bool = False
    use_pom: bool = False
    poses_prior_to_window_to_keep_constant: int = 1
    min_object_observations: int = 1
    min_low_level_feature_observations: int = 3
    use_pose_graph_on_global_ba: bool = False
    use_visual_features_on_global_ba: bool = False
    use_pose_graph_on_final_global_ba: bool = False
    use_visual_features_on_final_global_ba: bool = False

    @classmethod
    def from_json(cls, d):
        return cls(
            min_low_level_feature_observations_per_frame=_i(
                d["min_low_level_feature_observations_per_frame"]
            ),
            include_object_factors=_b(d["include_object_factors"]),
            include_visual_factors=_b(d["include_visual_factors"]),
            fix_poses=_b(d["fix_poses"]),
            fix_objects=_b(d["fix_objects"]),
            fix_visual_features=_b(d["fix_visual_features"]),
            fix_ltm_objects=_b(d["fix_ltm_objects"]),
            use_pom=_b(d["use_pom"]),
            poses_prior_to_window_to_keep_constant=_i(
                d["poses_prior_to_window_to_keep_constant"]
            ),
            min_object_observations=_i(d["min_object_observations"]),
            min_low_level_feature_observations=_i(
                d["min_low_level_feature_observations"]
            ),
            use_pose_graph_on_global_ba=_b(d["use_pose_graph_on_global_ba"]),
            use_visual_features_on_global_ba=_b(d["use_visual_features_on_global_ba"]),
            use_pose_graph_on_final_global_ba=_b(
                d["use_pose_graph_on_final_global_ba"]
            ),
            use_visual_features_on_final_global_ba=_b(
                d["use_visual_features_on_final_global_ba"]
            ),
        )


@dataclass
class LimitTrajectoryEvaluationParams:
    should_limit_trajectory_evaluation: bool = False
    max_frame_id: int = 1

    @classmethod
    def from_json(cls, d):
        return cls(
            should_limit_trajectory_evaluation=_b(
                d["should_limit_trajectory_evaluation"]
            ),
            max_frame_id=_i(d["max_frame_id"]),
        )


@dataclass
class SparsifierParams:
    max_pose_inc_threshold_transl: float = 0.2
    max_pose_inc_threshold_rot: float = 0.1

    @classmethod
    def from_json(cls, d):
        return cls(
            max_pose_inc_threshold_transl=float(d["max_pose_inc_threshold_transl"]),
            max_pose_inc_threshold_rot=float(d["max_pose_inc_threshold_rot"]),
        )


@dataclass
class FullOVSLAMConfig:
    """Mirror of full_ov_slam_config.h:155-239 (schema v12-14)."""

    config_schema_version: int = 14
    config_version_id: str = "default"
    visual_feature_params: VisualFeatureParams = field(
        default_factory=VisualFeatureParams
    )
    local_ba_iteration_params: OptimizationIterationParams = field(
        default_factory=OptimizationIterationParams
    )
    global_ba_iteration_params: OptimizationIterationParams = field(
        default_factory=OptimizationIterationParams
    )
    final_ba_iteration_params: OptimizationIterationParams = field(
        default_factory=OptimizationIterationParams
    )
    pgo_solver_params: PgoSolverParams = field(default_factory=PgoSolverParams)
    ltm_tunable_params: LtmTunableParams = field(default_factory=LtmTunableParams)
    ltm_solver_residual_params: ResidualParams = field(default_factory=ResidualParams)
    ltm_solver_params: OptimizationSolverParams = field(
        default_factory=OptimizationSolverParams
    )
    shape_dimension_priors: List[ShapeDimensionPrior] = field(default_factory=list)
    camera_topic_to_camera_id: Dict[str, int] = field(default_factory=dict)
    geometric_similarity_scorer_params: GeometricSimilarityScorerParams = field(
        default_factory=GeometricSimilarityScorerParams
    )
    feature_based_bb_association_params: FeatureBasedBbAssociationParams = field(
        default_factory=FeatureBasedBbAssociationParams
    )
    post_session_object_merge_params: GeometricSimilarityScorerParams = field(
        default_factory=lambda: GeometricSimilarityScorerParams(max_merge_distance=2.0)
    )
    bounding_box_covariance_generator_params: BoundingBoxCovGenParams = field(
        default_factory=BoundingBoxCovGenParams
    )
    sliding_window_params: SlidingWindowParams = field(
        default_factory=SlidingWindowParams
    )
    optimization_factors_enabled_params: OptimizationFactorsEnabledParams = field(
        default_factory=OptimizationFactorsEnabledParams
    )
    object_visual_pose_graph_residual_params: ResidualParams = field(
        default_factory=ResidualParams
    )
    limit_traj_eval_params: LimitTrajectoryEvaluationParams = field(
        default_factory=LimitTrajectoryEvaluationParams
    )
    sparsifier_params: SparsifierParams = field(default_factory=SparsifierParams)


def read_config(path: str) -> FullOVSLAMConfig:
    """Load a reference-format config JSON (readConfiguration equivalent,
    config_file_storage_io.h)."""
    with open(path) as f:
        d = json.load(f)["config"]

    shape_priors = []
    for entry in d["shape_dimension_priors"]["dimension_prior_label"]:
        shape_priors.append(
            ShapeDimensionPrior(
                semantic_class=entry["semantic_class"],
                mean=_mat(entry["obj_dim_mean"]).ravel(),
                covariance=_mat(entry["dim_covariance"]),
            )
        )

    cam_map = {
        e["camera_topic"]: _i(e["camera_id"])
        for e in d["camera_info"]["camera_topic_to_camera_id"]
    }

    bb_fe = d["bounding_box_front_end_params"]
    local_iter = OptimizationIterationParams.from_json(d["local_ba_iteration_params"])
    final_iter = OptimizationIterationParams.from_json(d["final_ba_iteration_params"])
    return FullOVSLAMConfig(
        config_schema_version=_i(d["config_schema_version"]),
        config_version_id=str(d["config_version_id"]),
        visual_feature_params=VisualFeatureParams.from_json(d["visual_feature_params"]),
        local_ba_iteration_params=local_iter,
        global_ba_iteration_params=OptimizationIterationParams.from_json(
            d["global_ba_iteration_params"]
        ),
        final_ba_iteration_params=final_iter,
        pgo_solver_params=PgoSolverParams.from_json(
            d["pgo_solver_params"],
            local_phase_two=local_iter.phase_two_opt_params,
            final_phase_two=final_iter.phase_two_opt_params,
        ),
        ltm_tunable_params=LtmTunableParams.from_json(d["ltm_tunable_params"]),
        ltm_solver_residual_params=ResidualParams.from_json(
            d["ltm_solver_residual_params"]
        ),
        ltm_solver_params=OptimizationSolverParams.from_json(d["ltm_solver_params"]),
        shape_dimension_priors=shape_priors,
        camera_topic_to_camera_id=cam_map,
        geometric_similarity_scorer_params=GeometricSimilarityScorerParams.from_json(
            bb_fe["geometric_similarity_scorer_params"]
        ),
        feature_based_bb_association_params=FeatureBasedBbAssociationParams.from_json(
            bb_fe["feature_based_bb_association_params"]
        ),
        post_session_object_merge_params=GeometricSimilarityScorerParams.from_json(
            bb_fe["post_session_object_merge_params"]
        ),
        bounding_box_covariance_generator_params=BoundingBoxCovGenParams.from_json(
            d["bounding_box_covariance_generator_params"]
        ),
        sliding_window_params=SlidingWindowParams.from_json(d["sliding_window_params"]),
        optimization_factors_enabled_params=OptimizationFactorsEnabledParams.from_json(
            d["optimization_factors_enabled_params"]
        ),
        object_visual_pose_graph_residual_params=ResidualParams.from_json(
            d["object_visual_pose_graph_residual_params"]
        ),
        limit_traj_eval_params=LimitTrajectoryEvaluationParams.from_json(
            d["limit_traj_eval_params"]
        ),
        sparsifier_params=SparsifierParams.from_json(d["sparsifier_params"]),
    )


def default_shape_priors() -> List[ShapeDimensionPrior]:
    """Per-class ellipsoid dimension priors (mean, std per axis in metres) of
    write_configuration.cpp's semantic classes."""
    defaults = [
        ("chair", [0.62, 0.62, 0.975], [0.05, 0.05, 0.05]),
        ("bench", [1.0, 2.5, 1.5], [1.5, 2.0, 1.5]),
        ("roadblock", [0.29, 0.29, 0.48], [0.001, 0.001, 0.01]),
        ("treetrunk", [0.4, 0.4, 2.0], [0.2, 0.2, 3.0]),
        ("lamppost", [0.3, 0.3, 4.0], [0.15, 0.15, 3.0]),
        ("trashcan", [0.73, 0.73, 1.2], [0.15, 0.15, 0.2]),
    ]
    return [
        ShapeDimensionPrior(cls, np.array(mean), np.diag(np.array(std) ** 2))
        for cls, mean, std in defaults
    ]


def object_session_config(pgo: bool = True) -> FullOVSLAMConfig:
    """Config for the seeded synthetic object session (``synthetic.
    make_object_session``), built in-repo from ``FullOVSLAMConfig()``.

    From the paper config (SURVEY.md §5, ``base7a_1_fallback_a_2.json``):
    local-BA phase-one function tolerance 1e-3, global/final 1e-6.

    Assumed (not in SURVEY §5), sized for a tens-of-frames synthetic session:
      - sliding window 8 frames, global BA every 7 frames;
      - LM iteration caps 25 (phase one) / 30 (phase two) for local, global
        and final BA (the paper's 50 / 250 / 300 are cut for session length);
      - PGO on global and final BA when ``pgo``; visual features on both;
      - min observations: 10 features per frame, 3 per feature, 3 per
        object; bb frontend min_observations 5, 3 for local estimation,
        3 overlapping features per match; pending-object mini-BA 30 iters;
      - every other value is the ``FullOVSLAMConfig`` dataclass default, and
        the shape priors are ``default_shape_priors()``.
    """
    c = FullOVSLAMConfig(config_version_id="synthetic_object_session")
    c.shape_dimension_priors = default_shape_priors()
    c.sliding_window_params = SlidingWindowParams(
        global_ba_frequency=7, local_ba_window_size=8
    )
    en = c.optimization_factors_enabled_params
    en.use_pose_graph_on_global_ba = pgo
    en.use_pose_graph_on_final_global_ba = pgo
    en.use_visual_features_on_global_ba = True
    en.use_visual_features_on_final_global_ba = True
    en.min_low_level_feature_observations_per_frame = 10
    en.min_low_level_feature_observations = 3
    en.min_object_observations = 3
    fe = c.feature_based_bb_association_params
    fe.min_observations = 5
    fe.min_observations_for_local_est = 3
    fe.min_overlapping_features_for_match = 3.0
    fe.pending_obj_estimator_params.solver_params.max_num_iterations = 30
    for it, ftol in (
        (c.local_ba_iteration_params, 1e-3),
        (c.global_ba_iteration_params, 1e-6),
        (c.final_ba_iteration_params, 1e-6),
    ):
        it.phase_one_opt_params.max_num_iterations = 25
        it.phase_one_opt_params.function_tolerance = ftol
        it.phase_two_opt_params.max_num_iterations = 30
    return c


def shape_prior_map(config: FullOVSLAMConfig) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    return {
        p.semantic_class: (p.mean, p.covariance) for p in config.shape_dimension_priors
    }


def write_config(config: FullOVSLAMConfig, path: str):
    """Inverse of read_config: emit the reference JSON schema
    (write_configuration.cpp equivalent)."""

    def iter_params(p: OptimizationIterationParams):
        return p.to_json()

    def residual_params(r: ResidualParams):
        return {
            "object_residual_params": {
                "object_observation_huber_loss_param": r.object_residual_params.object_observation_huber_loss_param,
                "shape_dim_prior_factor_huber_loss_param": r.object_residual_params.shape_dim_prior_factor_huber_loss_param,
                "invalid_ellipsoid_error_val": r.object_residual_params.invalid_ellipsoid_error_val,
            },
            "visual_residual_params": {
                "reprojection_error_huber_loss_param": r.reprojection_error_huber_loss_param
            },
            "long_term_map_params": {
                "pair_huber_loss_param": r.ltm_pair_huber_loss_param
            },
            "relative_pose_factor_huber_loss": r.relative_pose_factor_huber_loss,
            "relative_pose_cov_params": {
                "transl_error_mult_for_transl_error": r.relative_pose_cov_params.transl_error_mult_for_transl_error,
                "transl_error_mult_for_rot_error": r.relative_pose_cov_params.transl_error_mult_for_rot_error,
                "rot_error_mult_for_transl_error": r.relative_pose_cov_params.rot_error_mult_for_transl_error,
                "rot_error_mult_for_rot_error": r.relative_pose_cov_params.rot_error_mult_for_rot_error,
            },
        }

    vf = config.visual_feature_params
    pgo = config.pgo_solver_params
    fe = config.feature_based_bb_association_params
    d = {
        "config": {
            "config_schema_version": config.config_schema_version,
            "config_version_id": config.config_version_id,
            "visual_feature_params": {
                "reprojection_error_std_dev": vf.reprojection_error_std_dev,
                "min_visual_feature_parallax_pixel_requirement": vf.min_visual_feature_parallax_pixel_requirement,
                "min_visual_feature_parallax_robot_transl_requirement": vf.min_visual_feature_parallax_robot_transl_requirement,
                "min_visual_feature_parallax_robot_orient_requirement": vf.min_visual_feature_parallax_robot_orient_requirement,
                "enforce_min_pixel_parallax_requirement": int(vf.enforce_min_pixel_parallax_requirement),
                "enforce_min_robot_pose_parallax_requirement": int(vf.enforce_min_robot_pose_parallax_requirement),
                "inlier_epipolar_err_thresh": vf.inlier_epipolar_err_thresh,
                "check_past_n_frames_for_epipolar_err": vf.check_past_n_frames_for_epipolar_err,
                "enforce_epipolar_error_requirement_": int(vf.enforce_epipolar_error_requirement),
            },
            "local_ba_iteration_params": iter_params(config.local_ba_iteration_params),
            "global_ba_iteration_params": iter_params(config.global_ba_iteration_params),
            "final_ba_iteration_params": iter_params(config.final_ba_iteration_params),
            "pgo_solver_params": {
                "relative_pose_factor_huber_loss": pgo.relative_pose_factor_huber_loss,
                "enable_visual_feats_only_opt_post_pgo": int(pgo.enable_visual_feats_only_opt_post_pgo),
                "enable_visual_non_opt_feature_adjustment_post_pgo": int(pgo.enable_visual_non_opt_feature_adjustment_post_pgo),
                "relative_pose_cov_params": {
                    "transl_error_mult_for_transl_error": pgo.relative_pose_cov_params.transl_error_mult_for_transl_error,
                    "transl_error_mult_for_rot_error": pgo.relative_pose_cov_params.transl_error_mult_for_rot_error,
                    "rot_error_mult_for_transl_error": pgo.relative_pose_cov_params.rot_error_mult_for_transl_error,
                    "rot_error_mult_for_rot_error": pgo.relative_pose_cov_params.rot_error_mult_for_rot_error,
                },
                "pgo_optimization_solver_params": pgo.pgo_optimization_solver_params.to_json(),
                "final_pgo_optimization_solver_params": pgo.final_pgo_optimization_solver_params.to_json(),
                "post_pgo_vf_adjustment_solver_params": pgo.post_pgo_vf_adjustment_solver_params.to_json(),
                "final_post_pgo_vf_adjustment_solver_params": pgo.final_post_pgo_vf_adjustment_solver_params.to_json(),
                "pre_pgo_tracking_solver_params": pgo.pre_pgo_tracking_solver_params.to_json(),
            },
            "ltm_tunable_params": {
                "far_feature_threshold": config.ltm_tunable_params.far_feature_threshold,
                "min_col_norm": config.ltm_tunable_params.min_col_norm,
                "fallback_to_prev_for_failed_extraction": int(config.ltm_tunable_params.fallback_to_prev_for_failed_extraction),
            },
            "ltm_solver_residual_params": residual_params(config.ltm_solver_residual_params),
            "ltm_solver_params": config.ltm_solver_params.to_json(),
            "shape_dimension_priors": {
                "dimension_prior_label": [
                    {
                        "semantic_class": p.semantic_class,
                        "obj_dim_mean": _mat_to_node(p.mean.reshape(3, 1)),
                        "dim_covariance": _mat_to_node(p.covariance),
                    }
                    for p in config.shape_dimension_priors
                ]
            },
            "camera_info": {
                "camera_topic_to_camera_id": [
                    {"camera_topic": topic, "camera_id": str(cam_id)}
                    for topic, cam_id in config.camera_topic_to_camera_id.items()
                ]
            },
            "bounding_box_front_end_params": {
                "geometric_similarity_scorer_params": {
                    "max_merge_distance": config.geometric_similarity_scorer_params.max_merge_distance,
                    "x_y_only_merge": int(config.geometric_similarity_scorer_params.x_y_only_merge),
                },
                "feature_based_bb_association_params": {
                    "min_observations_for_local_est": fe.min_observations_for_local_est,
                    "min_observations": fe.min_observations,
                    "discard_candidate_after_num_frames": str(fe.discard_candidate_after_num_frames),
                    "min_bb_confidence": fe.min_bb_confidence,
                    "required_min_conf_for_initialization": fe.required_min_conf_for_initialization,
                    "min_overlapping_features_for_match": fe.min_overlapping_features_for_match,
                    "feature_validity_window": str(fe.feature_validity_window),
                    "pending_obj_estimator_params": {
                        "object_residual_params": {
                            "object_observation_huber_loss_param": fe.pending_obj_estimator_params.object_residual_params.object_observation_huber_loss_param,
                            "shape_dim_prior_factor_huber_loss_param": fe.pending_obj_estimator_params.object_residual_params.shape_dim_prior_factor_huber_loss_param,
                            "invalid_ellipsoid_error_val": fe.pending_obj_estimator_params.object_residual_params.invalid_ellipsoid_error_val,
                        },
                        "solver_params": fe.pending_obj_estimator_params.solver_params.to_json(),
                    },
                    "bounding_box_inflation_size": fe.bounding_box_inflation_size,
                },
                "post_session_object_merge_params": {
                    "max_merge_distance": config.post_session_object_merge_params.max_merge_distance,
                    "x_y_only_merge": int(config.post_session_object_merge_params.x_y_only_merge),
                },
            },
            "bounding_box_covariance_generator_params": {
                "bounding_box_cov": _mat_to_node(config.bounding_box_covariance_generator_params.bounding_box_cov),
                "near_edge_threshold": config.bounding_box_covariance_generator_params.near_edge_threshold,
                "image_boundary_variance": config.bounding_box_covariance_generator_params.image_boundary_variance,
            },
            "sliding_window_params": {
                "global_ba_frequency": str(config.sliding_window_params.global_ba_frequency),
                "local_ba_window_size": str(config.sliding_window_params.local_ba_window_size),
            },
            "optimization_factors_enabled_params": {
                "min_low_level_feature_observations_per_frame": config.optimization_factors_enabled_params.min_low_level_feature_observations_per_frame,
                "include_object_factors": int(config.optimization_factors_enabled_params.include_object_factors),
                "include_visual_factors": int(config.optimization_factors_enabled_params.include_visual_factors),
                "fix_poses": int(config.optimization_factors_enabled_params.fix_poses),
                "fix_objects": int(config.optimization_factors_enabled_params.fix_objects),
                "fix_visual_features": int(config.optimization_factors_enabled_params.fix_visual_features),
                "fix_ltm_objects": int(config.optimization_factors_enabled_params.fix_ltm_objects),
                "use_pom": int(config.optimization_factors_enabled_params.use_pom),
                "poses_prior_to_window_to_keep_constant": config.optimization_factors_enabled_params.poses_prior_to_window_to_keep_constant,
                "min_object_observations": config.optimization_factors_enabled_params.min_object_observations,
                "min_low_level_feature_observations": config.optimization_factors_enabled_params.min_low_level_feature_observations,
                "use_pose_graph_on_global_ba": int(config.optimization_factors_enabled_params.use_pose_graph_on_global_ba),
                "use_visual_features_on_global_ba": int(config.optimization_factors_enabled_params.use_visual_features_on_global_ba),
                "use_pose_graph_on_final_global_ba": int(config.optimization_factors_enabled_params.use_pose_graph_on_final_global_ba),
                "use_visual_features_on_final_global_ba": int(config.optimization_factors_enabled_params.use_visual_features_on_final_global_ba),
            },
            "object_visual_pose_graph_residual_params": residual_params(config.object_visual_pose_graph_residual_params),
            "limit_traj_eval_params": {
                "should_limit_trajectory_evaluation": int(config.limit_traj_eval_params.should_limit_trajectory_evaluation),
                "max_frame_id": config.limit_traj_eval_params.max_frame_id,
            },
            "sparsifier_params": {
                "max_pose_inc_threshold_transl": config.sparsifier_params.max_pose_inc_threshold_transl,
                "max_pose_inc_threshold_rot": config.sparsifier_params.max_pose_inc_threshold_rot,
            },
        }
    }
    with open(path, "w") as f:
        json.dump(d, f, indent=4)
