"""Object pipeline tests: bounding-box data association, pending-object
mini-BA initialization, merges, and the full joint object-visual run."""

import numpy as np

from obvi_slam_tpu import config as cfg
from obvi_slam_tpu.frontend import (
    FeatureBasedBoundingBoxFrontEnd,
    VisualFeatureFrontend,
    apply_merges,
    make_bb_frontend_hook,
    merge_objects_by_center_proximity,
)
from obvi_slam_tpu.offline_data import RawBoundingBox
from obvi_slam_tpu.pose_graph import PoseGraph
from obvi_slam_tpu.runner import OfflineProblemRunner
from obvi_slam_tpu.synthetic import make_object_session


def make_frontend(pg, config):
    return FeatureBasedBoundingBoxFrontEnd(
        pg,
        config.feature_based_bb_association_params,
        config.bounding_box_covariance_generator_params,
        config.geometric_similarity_scorer_params,
        img_heights_and_widths={1: (480.0, 640.0)},
    )


def object_config():
    c = cfg.object_session_config(pgo=False)
    c.sliding_window_params.local_ba_window_size = 6
    c.sliding_window_params.global_ba_frequency = 5
    en = c.optimization_factors_enabled_params
    en.use_pose_graph_on_global_ba = False
    en.use_pose_graph_on_final_global_ba = False
    en.use_visual_features_on_global_ba = True
    en.use_visual_features_on_final_global_ba = True
    en.min_low_level_feature_observations_per_frame = 10
    en.min_low_level_feature_observations = 3
    en.min_object_observations = 3
    fe = c.feature_based_bb_association_params
    fe.min_observations = 5
    fe.min_observations_for_local_est = 3
    fe.min_overlapping_features_for_match = 3.0
    for p in (c.local_ba_iteration_params, c.global_ba_iteration_params, c.final_ba_iteration_params):
        p.phase_one_opt_params.max_num_iterations = 15
        p.phase_two_opt_params.max_num_iterations = 20
    fe.pending_obj_estimator_params.solver_params.max_num_iterations = 30
    return c


class TestAssociation:
    def test_objects_created_and_consistently_associated(self):
        data, gt_poses, gt_objects = make_object_session()
        config = object_config()
        from obvi_slam_tpu.config import shape_prior_map

        pg = PoseGraph(data.cameras, shape_prior_map(config))
        # Ground-truth poses in the graph: isolates association from estimation.
        for i in range(len(gt_poses)):
            pg.add_frame(i, gt_poses[i])
        fe = make_frontend(pg, config)
        hook = make_bb_frontend_hook(fe)
        for i in range(len(gt_poses)):
            hook(data, pg, i)

        # Exactly 2 objects should exist (one per GT chair), near GT centers.
        assert len(pg.objects) == 2, (len(pg.objects), [o.ellipsoid[:3] for o in pg.objects.values()])
        ests = np.stack([pg.objects[o].ellipsoid[:3] for o in sorted(pg.objects)])
        # Match greedily to GT.
        d0 = min(np.linalg.norm(ests[0] - gt_objects[0][:3]), np.linalg.norm(ests[0] - gt_objects[1][:3]))
        d1 = min(np.linalg.norm(ests[1] - gt_objects[0][:3]), np.linalg.norm(ests[1] - gt_objects[1][:3]))
        assert d0 < 1.0 and d1 < 1.0, (ests, gt_objects)
        # All observations landed on the two objects.
        n_obs = sum(len(v) for v in pg.obj_obs_by_object.values())
        assert n_obs >= 16, n_obs

    def test_low_confidence_filtered(self):
        data, gt_poses, _ = make_object_session()
        config = object_config()
        pg = PoseGraph(data.cameras, {})
        pg.add_frame(0, gt_poses[0])
        fe = make_frontend(pg, config)
        bbs = [RawBoundingBox(np.array([100.0, 200, 100, 200]), "chair", 0.05)]
        fe.add_bounding_box_observations(0, 1, bbs, {})
        assert len(fe.pending) == 0 and len(pg.objects) == 0


class TestMerging:
    def test_center_proximity_merge(self):
        pg = PoseGraph({}, {})
        a = pg.add_new_ellipsoid([0, 0, 5, 0, 1, 1, 1], "chair")
        b = pg.add_new_ellipsoid([0.5, 0.1, 5.2, 0, 1, 1, 1], "chair")
        c = pg.add_new_ellipsoid([10, 0, 5, 0, 1, 1, 1], "chair")
        d = pg.add_new_ellipsoid([0.2, 0, 5.1, 0, 1, 1, 1], "bench")  # other class
        pg.add_object_observation(a, 0, 1, np.zeros(4), np.eye(4))
        pg.add_object_observation(b, 1, 1, np.zeros(4), np.eye(4))
        merges = merge_objects_by_center_proximity(pg, 2.0, x_y_only=True)
        assert merges == {b: {a}} or merges == {a: {b}}, merges
        assert apply_merges(pg, merges)
        assert len(pg.objects) == 3
        # Observations re-pointed to the survivor.
        survivor = list(merges.keys())[0]
        assert len(pg.obj_obs_by_object[survivor]) == 2

    def test_ltm_object_survives_merge(self):
        pg = PoseGraph({}, {})
        pg.add_ltm_object(7, [0, 0, 5, 0, 1, 1, 1], "chair")
        b = pg.add_new_ellipsoid([0.3, 0, 5, 0, 1, 1, 1], "chair")
        merges = merge_objects_by_center_proximity(pg, 2.0, x_y_only=True)
        assert merges == {7: {b}}
        apply_merges(pg, merges)
        assert 7 in pg.objects and b not in pg.objects


class TestJointEndToEnd:
    def test_full_object_visual_run(self):
        data, gt_poses, gt_objects = make_object_session()
        config = object_config()
        from obvi_slam_tpu.config import shape_prior_map
        from obvi_slam_tpu.runner import RunnerHooks

        pg = PoseGraph(data.cameras, shape_prior_map(config))
        fe = make_frontend(pg, config)
        hooks = RunnerHooks(bb_frontend=lambda d, p, f: make_bb_frontend_hook(fe)(d, p, f))

        def merger(pose_graph):
            merges = merge_objects_by_center_proximity(
                pose_graph,
                config.post_session_object_merge_params.max_merge_distance,
                config.post_session_object_merge_params.x_y_only_merge,
            )
            return apply_merges(pose_graph, merges, fe)

        hooks.object_merger = merger
        runner = OfflineProblemRunner(config, hooks)
        vf = VisualFeatureFrontend(
            gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
            reprojection_error_provider=lambda *a: 1.0,
        )
        ok = runner.run_optimization(data, pg, visual_frontend=vf)
        assert ok
        assert len(pg.objects) == 2, len(pg.objects)
        for obj_id, node in pg.objects.items():
            d = min(
                np.linalg.norm(node.ellipsoid[:3] - gt_objects[0][:3]),
                np.linalg.norm(node.ellipsoid[:3] - gt_objects[1][:3]),
            )
            assert d < 0.5, (obj_id, node.ellipsoid, d)
        # Trajectory still good.
        errs = [
            np.sum((pg.get_robot_pose(i)[:3] - gt_poses[i, :3]) ** 2)
            for i in range(len(gt_poses))
        ]
        assert np.sqrt(np.mean(errs)) < 0.05
