"""Tests for the PGO-plus-ellipsoids pass (pose_graph_plus_objects_optimizer.h
semantics, ours in obvi_slam_tpu/pgo.py): the paper config runs this on every
global-BA frame (base7a_1_fallback_a_2.json: use_pose_graph_on_global_ba=1),
so it needs direct coverage — tracking solve, synthesized consecutive relpose
factors from current estimates, analytic feature re-anchoring, and the
post-PGO feature-only BA."""

import numpy as np
import pytest

from obvi_slam_tpu import config as cfg
from obvi_slam_tpu.frontend import VisualFeatureFrontend
from obvi_slam_tpu.pose_graph import PoseGraph
from obvi_slam_tpu.runner import OfflineProblemRunner

from test_runner_e2e import ate_rmse, make_session, small_config


def pgo_config():
    """Paper-config PGO schedule on the synthetic session: PGO replaces the
    visual-factor BA on (non-final) global-BA frames, exactly like base7a:
    use_pose_graph_on_global_ba=1, use_visual_features_on_global_ba=0."""
    c = small_config()
    en = c.optimization_factors_enabled_params
    en.use_pose_graph_on_global_ba = True
    en.use_pose_graph_on_final_global_ba = True
    en.use_visual_features_on_global_ba = False
    en.use_visual_features_on_final_global_ba = True
    pgo = c.pgo_solver_params
    pgo.pgo_optimization_solver_params.max_num_iterations = 20
    pgo.final_pgo_optimization_solver_params.max_num_iterations = 25
    pgo.post_pgo_vf_adjustment_solver_params.max_num_iterations = 15
    pgo.final_post_pgo_vf_adjustment_solver_params.max_num_iterations = 20
    return c


def run_session(config, data, **runner_kwargs):
    runner = OfflineProblemRunner(config, **runner_kwargs)
    pg = PoseGraph(data.cameras)
    vf = VisualFeatureFrontend(
        gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
        reprojection_error_provider=lambda *a: config.visual_feature_params.reprojection_error_std_dev,
        min_parallax_pixel=config.visual_feature_params.min_visual_feature_parallax_pixel_requirement,
        inlier_epipolar_err_thresh=config.visual_feature_params.inlier_epipolar_err_thresh,
        check_past_n_frames=config.visual_feature_params.check_past_n_frames_for_epipolar_err,
    )
    assert runner.run_optimization(data, pg, visual_frontend=vf)
    return runner, pg


class TestPgoPlusEllipsoids:
    @pytest.fixture(scope="class")
    def session(self):
        return make_session(n_frames=11, n_features=35)

    def test_pgo_schedule_runs_and_improves_ate(self, session):
        data, gt_poses, _ = session
        config = pgo_config()
        runner, pg = run_session(config, data)
        ate_init = np.sqrt(
            np.mean(
                [
                    np.sum((data.initial_poses[i][:3] - gt_poses[i, :3]) ** 2)
                    for i in range(len(gt_poses))
                ]
            )
        )
        ate_final = ate_rmse(pg, gt_poses)
        assert ate_final < ate_init, (ate_init, ate_final)
        assert ate_final < 0.06, ate_final
        # The PGO pass actually ran: phase-0 records logged on global frames.
        pgo_recs = [r for r in runner.opt_log if r.phase == 0]
        assert pgo_recs, "no PGO solves logged"
        # Tracking + PGO timers populated with reference-compatible names.
        from obvi_slam_tpu.timing import TimerRegistry

        names = set(TimerRegistry.instance().timers)
        for expected in (
            "obj_only_pgo_full_process",
            "obj_only_pgo_local_track_solve",
            "obj_only_pgo_solve_pgo",
            "obj_only_pgo_opt_feat_adjust_solve",
        ):
            assert expected in names, expected

    def test_pgo_preserves_feature_consistency(self, session):
        """Feature re-anchoring (enable_visual_non_opt_feature_adjustment):
        features keep their pose-relative positions through the PGO update,
        then the vf-only BA refines them — reprojection errors at the end
        must be small."""
        data, gt_poses, gt_points = session
        config = pgo_config()
        runner, pg = run_session(config, data)
        errs = []
        for fid, pos in pg.features.items():
            # compare against ground truth landmark
            if fid in gt_points_index(gt_points, data):
                errs.append(np.linalg.norm(pos - gt_points[fid]))
        assert errs and np.median(errs) < 0.15, (len(errs), np.median(errs))

    def test_pgo_with_fused_solver_matches_host_loop(self, session):
        data, gt_poses, _ = session
        config = pgo_config()
        _, pg_host = run_session(config, data, use_fused_solver=False)
        _, pg_fused = run_session(config, data, use_fused_solver=True)
        n = data.max_frame_id() + 1
        host = np.stack([pg_host.get_robot_pose(i) for i in range(n)])
        fused = np.stack([pg_fused.get_robot_pose(i) for i in range(n)])
        np.testing.assert_allclose(fused, host, rtol=1e-5, atol=1e-7)


def gt_points_index(gt_points, data):
    return set(range(len(gt_points))) & set(data.feature_tracks)
