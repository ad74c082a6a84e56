"""Roshan appearance-based frontend tests: histogram machinery + association
pipeline on a synthetic scene with colored objects."""

import numpy as np
import pytest

from obvi_slam_tpu import config as cfg
from obvi_slam_tpu.config import shape_prior_map
from obvi_slam_tpu.frontend.roshan_frontend import (
    RoshanBbFrontEnd,
    histogram_correlation,
    hue_sat_histogram,
)
from obvi_slam_tpu.pose_graph import PoseGraph

from obvi_slam_tpu.synthetic import make_object_session
from test_bb_frontend import object_config


class TestHistograms:
    def test_identical_patches_correlate(self):
        rng = np.random.default_rng(0)
        patch = rng.uniform(0, 180, (20, 20, 3))
        h1 = hue_sat_histogram(patch)
        assert abs(histogram_correlation(h1, h1) - 1.0) < 1e-12

    def test_different_hues_do_not(self):
        red = np.zeros((20, 20, 3))
        red[..., 0] = 5
        red[..., 1] = 200
        blue = np.zeros((20, 20, 3))
        blue[..., 0] = 120
        blue[..., 1] = 200
        c = histogram_correlation(hue_sat_histogram(red), hue_sat_histogram(blue))
        assert c < 0.1

    def test_empty_patch(self):
        assert hue_sat_histogram(np.zeros((0, 0, 3))) is None
        assert histogram_correlation(None, None) == 0.0


def synthetic_hsv_provider(data, gt_objects):
    """Fake HSV images: each object's bbox region painted a distinct hue."""

    def provider(frame_id, camera_id):
        img = np.zeros((480, 640, 3))
        img[..., 0] = 90.0  # background hue
        img[..., 1] = 30.0
        bbs = data.bounding_boxes.get(frame_id, {}).get(camera_id, [])
        # Paint by matching bbox center x to the GT object order: the scene
        # generator emits bbs in object order.
        for k, bb in enumerate(bbs):
            x0, x1, y0, y1 = (int(max(0, v)) for v in (bb.corners[0], bb.corners[1], bb.corners[2], bb.corners[3]))
            hue = 10.0 if bb.corners[0] < 320 else 150.0  # left obj red, right blue
            img[y0 : min(480, y1 + 1), x0 : min(640, x1 + 1), 0] = hue
            img[y0 : min(480, y1 + 1), x0 : min(640, x1 + 1), 1] = 220.0
        return img

    return provider


class TestRoshanAssociation:
    def test_creates_and_tracks_objects(self):
        data, gt_poses, gt_objects = make_object_session(n_frames=12, seed=61)
        config = object_config()
        pg = PoseGraph(data.cameras, shape_prior_map(config))
        for i in range(len(gt_poses)):
            pg.add_frame(i, gt_poses[i])
        fe = RoshanBbFrontEnd(
            pg,
            {
                "min_observations": 5,
                "min_observations_for_local_est": 3,
                "max_distance_for_associated_ellipsoids": 3.5,
                "min_bb_confidence": 0.3,
                "required_min_conf_for_initialization": 0.5,
            },
            config.bounding_box_covariance_generator_params,
            config.geometric_similarity_scorer_params,
            img_heights_and_widths={1: (480.0, 640.0)},
            hsv_image_provider=synthetic_hsv_provider(data, gt_objects),
        )
        fe.params.pending_obj_estimator_params.solver_params.max_num_iterations = 30
        for i in range(len(gt_poses)):
            for cam_id, bbs in data.bounding_boxes.get(i, {}).items():
                fe.add_bounding_box_observations(i, cam_id, bbs, {})
        assert len(pg.objects) == 2, (
            len(pg.objects),
            {o: pg.objects[o].ellipsoid[:3] for o in pg.objects},
        )
        ests = np.stack([pg.objects[o].ellipsoid[:3] for o in sorted(pg.objects)])
        for est in ests:
            d = min(np.linalg.norm(est - g[:3]) for g in gt_objects)
            assert d < 1.0, (est, d)
        # LTM payload carries histograms.
        payload = fe.get_front_end_obj_map_data()
        assert all("infos_for_observed_bbs" in v for v in payload.values())
        any_hist = any(
            i["histogram"] is not None
            for v in payload.values()
            for i in v["infos_for_observed_bbs"]
        )
        assert any_hist

    def test_works_without_images(self):
        # No provider: association is geometric-only, still functional.
        data, gt_poses, gt_objects = make_object_session(n_frames=10, seed=62)
        config = object_config()
        pg = PoseGraph(data.cameras, shape_prior_map(config))
        for i in range(len(gt_poses)):
            pg.add_frame(i, gt_poses[i])
        fe = RoshanBbFrontEnd(
            pg,
            {"min_observations": 5, "min_observations_for_local_est": 3},
            config.bounding_box_covariance_generator_params,
            config.geometric_similarity_scorer_params,
            img_heights_and_widths={1: (480.0, 640.0)},
        )
        fe.params.pending_obj_estimator_params.solver_params.max_num_iterations = 30
        for i in range(len(gt_poses)):
            for cam_id, bbs in data.bounding_boxes.get(i, {}).items():
                fe.add_bounding_box_observations(i, cam_id, bbs, {})
        # The two GT objects are ~3m apart; geometric pruning at 3.5m may
        # merge or split imperfectly without appearance, but objects exist.
        assert 1 <= len(pg.objects) <= 3
