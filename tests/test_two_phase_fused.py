"""Fused two-phase (device outlier selection + factor re-selection) vs the
host pass (runner residual readback + compute_inclusion_weights)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from obvi_slam_tpu import factors as fac
from obvi_slam_tpu.pose_graph import (
    OBJECT_OBSERVATION_FACTOR,
    REPROJECTION_FACTOR,
)
from obvi_slam_tpu.solver import two_phase as tp
from obvi_slam_tpu.solver.problem import (
    Scope,
    build_problem,
    reweight_for_exclusions,
)

from obvi_slam_tpu.synthetic import make_object_session
from test_runner_e2e import small_config


def _object_problem():
    """A pose graph with objects + features via the real frontends."""
    from obvi_slam_tpu.config import shape_prior_map
    from obvi_slam_tpu.frontend import VisualFeatureFrontend
    from obvi_slam_tpu.pose_graph import PoseGraph

    from test_bb_frontend import make_bb_frontend_hook, make_frontend, object_config

    data, gt_poses, _ = make_object_session(n_frames=10, seed=7)
    config = object_config()
    pg = PoseGraph(data.cameras, shape_prior_map(config))
    vf = VisualFeatureFrontend(
        gba_checker=lambda f: True,
        reprojection_error_provider=lambda *a: 2.0,
        inlier_epipolar_err_thresh=config.visual_feature_params.inlier_epipolar_err_thresh,
        check_past_n_frames=5,
    )
    for i in range(10):
        pg.add_frame(i, data.get_robot_pose_estimate(i))
    fe = make_frontend(pg, config)
    hook = make_bb_frontend_hook(fe)
    for i in range(10):
        vf.add_visual_feature_observations(data, pg, 0, i)
        hook(data, pg, i)
    scope = Scope(
        min_frame_id=0, max_frame_id=9,
        min_low_level_feature_observations=3,
        min_low_level_feature_observations_per_frame=10,
        min_object_observations=3,
    )
    problem = build_problem(pg, scope, dtype=np.float64)
    return pg, problem, scope


class TestDeviceReweightParity:
    def test_matches_host_cascade(self):
        pg, problem, scope = _object_problem()
        assert len(problem.bbox_rows) > 0, "need object factors for the test"

        # Residuals at a perturbed state (any state works; ranking only
        # needs values).
        rng = np.random.default_rng(3)
        state = problem.state._replace(
            poses=problem.state.poses
            + jnp.asarray(rng.normal(size=problem.state.poses.shape) * 0.01)
        )
        res = fac.all_residuals(
            state, problem.cams, problem.tables,
            problem.huber.invalid_ellipse_error,
        )

        pct = 0.1
        # Host pass (runner logic).
        excluded = set()
        for ftype, key, rows, w in (
            (REPROJECTION_FACTOR, "reproj", problem.reproj_rows,
             problem.base_weights_np["reproj"]),
            (OBJECT_OBSERVATION_FACTOR, "bbox", problem.bbox_rows,
             problem.base_weights_np["bbox"]),
        ):
            r = np.asarray(res[key])[: len(rows)]
            sq = np.sum(r * r, axis=1)
            live = np.nonzero(w > 0)[0]
            n_out = int(len(live) * pct)
            if n_out > 0:
                worst = live[np.argsort(-sq[live])[:n_out]]
                for i in worst:
                    excluded.add((ftype, int(rows[i])))
        w2_host = reweight_for_exclusions(pg, problem, excluded)

        # Device pass.
        cfg = tp.TwoPhaseConfig(
            feature_outlier_percentage=pct,
            min_low_level_feature_observations=scope.min_low_level_feature_observations,
            min_low_level_feature_observations_per_frame=scope.min_low_level_feature_observations_per_frame,
            min_object_observations=scope.min_object_observations,
            include_visual_factors=True,
            include_object_factors=True,
            include_shape_priors=True,
            fix_objects=False,
            fix_ltm_objects=False,
            force_include_ltm_objs=False,
        )
        w2_dev = tp.reweight_on_device(
            problem.tables, problem.weights, res["reproj"], res["bbox"],
            problem.aux, cfg,
            n_pose=problem.state.poses.shape[0],
            n_point=problem.state.points.shape[0],
        )
        for name in ("reproj", "bbox", "shape", "relpose", "ltm"):
            np.testing.assert_array_equal(
                np.asarray(getattr(w2_dev, name)),
                np.asarray(getattr(w2_host, name)),
                err_msg=name,
            )

    def test_outlier_mask_matches_numpy_ranking(self):
        rng = np.random.default_rng(0)
        sq = rng.uniform(size=200).astype(np.float32)
        live_np = rng.uniform(size=200) > 0.3
        pct = 0.12
        live_idx = np.nonzero(live_np)[0]
        n_out = int(len(live_idx) * pct)
        worst = set(live_idx[np.argsort(-sq[live_idx])[:n_out]].tolist())
        mask = np.asarray(
            tp._outlier_mask(jnp.asarray(sq), jnp.asarray(live_np), pct)
        )
        assert set(np.nonzero(mask)[0].tolist()) == worst
