"""Long-term map tests: covariance extraction correctness, rank-deficiency
repair, serialization, and cross-session seeding/relocalization."""

import numpy as np
import pytest

from obvi_slam_tpu import config as cfg
from obvi_slam_tpu.config import shape_prior_map
from obvi_slam_tpu.frontend import (
    VisualFeatureFrontend,
    apply_merges,
    make_bb_frontend_hook,
    merge_objects_by_center_proximity,
)
from obvi_slam_tpu.ltm import (
    LongTermObjectMap,
    extract_long_term_object_map,
    far_feature_ids,
    seed_pose_graph_from_ltm,
)
from obvi_slam_tpu.pose_graph import PoseGraph
from obvi_slam_tpu.runner import OfflineProblemRunner, RunnerHooks

from obvi_slam_tpu.synthetic import make_object_session
from test_bb_frontend import make_frontend, object_config


def run_session(data, config, ltm=None):
    pg = PoseGraph(data.cameras, shape_prior_map(config))
    if ltm is not None:
        seed_pose_graph_from_ltm(pg, ltm)
    fe = make_frontend(pg, config)
    hooks = RunnerHooks(bb_frontend=make_bb_frontend_hook(fe))
    hooks.object_merger = lambda p: apply_merges(
        p,
        merge_objects_by_center_proximity(
            p,
            config.post_session_object_merge_params.max_merge_distance,
            config.post_session_object_merge_params.x_y_only_merge,
        ),
        fe,
    )
    runner = OfflineProblemRunner(config, hooks)
    vf = VisualFeatureFrontend(
        gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
        reprojection_error_provider=lambda *a: 1.0,
    )
    ok = runner.run_optimization(data, pg, visual_frontend=vf)
    assert ok
    return pg, fe


class TestExtraction:
    @pytest.fixture(scope="class")
    def session_result(self):
        data, gt_poses, gt_objects = make_object_session()
        config = object_config()
        pg, fe = run_session(data, config)
        return data, config, pg, fe, gt_objects

    def test_extracts_objects_with_covariances(self, session_result):
        data, config, pg, fe, gt_objects = session_result
        # The monocular synthetic session has a scale gauge freedom unless
        # odometry factors participate; force them in (mirrors real data where
        # feature-starved frames contribute relpose factors).
        import dataclasses as dc

        config2 = dc.replace(config)
        config2.optimization_factors_enabled_params = dc.replace(
            config.optimization_factors_enabled_params,
            min_low_level_feature_observations_per_frame=10**9,
        )
        ltm = extract_long_term_object_map(
            pg, config2, fe.get_front_end_obj_map_data()
        )
        assert ltm is not None
        assert len(ltm.ellipsoids) == 2
        for obj_id, cov in ltm.covariances.items():
            assert cov.shape == (7, 7)
            # Physically sane: positive diagonal, symmetric (relative to the
            # matrix scale), small position uncertainty for 10+ observations.
            assert np.all(np.diag(cov) > 0), (obj_id, np.diag(cov))
            scale = np.abs(cov).max()
            np.testing.assert_allclose(cov / scale, cov.T / scale, atol=1e-6)
            assert np.all(np.diag(cov)[:3] < 10.0), np.diag(cov)
            # Yaw of a symmetric chair ellipsoid (dx == dy) is unobservable
            # from boxes alone (shape priors are excluded in extraction) so
            # its variance must dominate the position variances.
            assert cov[3, 3] > np.diag(cov)[:3].max()

    def test_serialization_roundtrip(self, session_result, tmp_path):
        data, config, pg, fe, _ = session_result
        ltm = extract_long_term_object_map(pg, config, fe.get_front_end_obj_map_data())
        path = str(tmp_path / "ltm.json")
        ltm.save(path)
        ltm2 = LongTermObjectMap.load(path)
        assert set(ltm2.ellipsoids) == set(ltm.ellipsoids)
        for k in ltm.ellipsoids:
            np.testing.assert_allclose(ltm2.ellipsoids[k][1], ltm.ellipsoids[k][1])
            np.testing.assert_allclose(ltm2.covariances[k], ltm.covariances[k])

    def test_far_feature_filter(self, session_result):
        data, config, pg, fe, _ = session_result
        # Plant an absurdly far feature.
        pg.features[99999] = np.array([0.0, 0.0, 1e4])
        pg.add_visual_factor(0, 1, 99999, np.array([320.0, 240.0]), 1.0)
        far = far_feature_ids(pg, config.ltm_tunable_params.far_feature_threshold)
        assert 99999 in far
        near = far_feature_ids(pg, 1e6)
        assert 99999 not in near


class TestRankDeficiencyRepair:
    def test_never_observed_object_gets_placeholder(self):
        # Object with zero factors never enters the extraction problem (the
        # reference's Ceres problem wouldn't contain its block either);
        # we emit an identity placeholder instead of failing.
        data, gt_poses, gt_objects = make_object_session()
        config = object_config()
        pg, fe = run_session(data, config)
        lonely = pg.add_new_ellipsoid([50.0, 50.0, 50.0, 0, 1, 1, 1], "chair")
        for sid in pg.shape_priors_by_object.pop(lonely, []):
            pg.shape_priors[sid] = None
        ltm = extract_long_term_object_map(pg, config, {})
        assert ltm is not None
        assert lonely in ltm.covariances
        np.testing.assert_array_equal(ltm.covariances[lonely], np.eye(7))

    def test_rank_deficient_object_finite_covariance(self):
        # Object with a single bbox observation and NO shape prior: 4 residuals
        # for 7 params -> rank deficient. Extraction must still return finite
        # covariances (repair priors / huge-variance directions), not NaN.
        data, gt_poses, gt_objects = make_object_session()
        config = object_config()
        pg, fe = run_session(data, config)
        deficient = pg.add_new_ellipsoid([1.0, 0.5, 6.0, 0, 0.6, 0.6, 1.0], "chair")
        for sid in pg.shape_priors_by_object.pop(deficient, []):
            pg.shape_priors[sid] = None
        pg.add_object_observation(
            deficient, 3, 1, np.array([300.0, 360.0, 200.0, 280.0]), np.diag([900.0] * 4)
        )
        import dataclasses as dc

        config2 = dc.replace(config)
        config2.optimization_factors_enabled_params = dc.replace(
            config.optimization_factors_enabled_params,
            min_object_observations=1,
            min_low_level_feature_observations_per_frame=10**9,
        )
        ltm = extract_long_term_object_map(pg, config2, {})
        assert ltm is not None
        cov = ltm.covariances[deficient]
        assert np.all(np.isfinite(cov))
        # Some direction must be (nearly) unconstrained.
        assert np.diag(cov).max() > 1e2, np.diag(cov)

    def test_combination_deficiency_detected_and_unbiased(self):
        # Linear-COMBINATION rank deficiency: an object seen through a single
        # bbox factor has J_obj (4x7) whose columns all carry healthy norms,
        # yet rank(H_oo) <= 4 < 7 — invisible to any per-column norm check.
        # The eigen-based analysis (find_rank_deficiencies) must (a) identify
        # the null directions and prior only the involved params, and (b)
        # leave the well-conditioned objects' covariances untouched.
        import dataclasses as dc

        data, gt_poses, gt_objects = make_object_session()
        config = object_config()
        config2 = dc.replace(config)
        config2.optimization_factors_enabled_params = dc.replace(
            config.optimization_factors_enabled_params,
            min_object_observations=1,
            min_low_level_feature_observations_per_frame=10**9,
        )

        pg, fe = run_session(data, config)
        baseline = extract_long_term_object_map(pg, config2, {})
        assert baseline is not None

        pg2, fe2 = run_session(data, config)
        deficient = pg2.add_new_ellipsoid(
            [1.0, 0.5, 6.0, 0, 0.6, 0.6, 1.0], "chair"
        )
        for sid in pg2.shape_priors_by_object.pop(deficient, []):
            pg2.shape_priors[sid] = None
        # Observe from frame 0, which extraction holds CONSTANT (gauge pose):
        # the factor's pose Jacobian is masked, so the deficient object is
        # informationally decoupled from the rest of the graph and the other
        # objects' marginals must come out bit-identical to the baseline.
        pg2.add_object_observation(
            deficient,
            0,
            1,
            np.array([300.0, 360.0, 200.0, 280.0]),
            np.diag([900.0] * 4),
        )
        ltm = extract_long_term_object_map(pg2, config2, {})
        assert ltm is not None
        cov_def = ltm.covariances[deficient]
        assert np.all(np.isfinite(cov_def))
        # Null directions got weak priors only -> huge but finite variance.
        assert np.diag(cov_def).max() > 1e2, np.diag(cov_def)
        # Well-conditioned objects' covariances are NOT biased by the repair
        # (the old global-ridge/all-object-params rescue shrank them).
        for obj_id, cov in baseline.covariances.items():
            scale = np.abs(cov).max()
            np.testing.assert_allclose(
                ltm.covariances[obj_id] / scale,
                cov / scale,
                atol=1e-6,
                err_msg=f"object {obj_id} covariance biased by repair",
            )

    def test_find_rank_deficiencies_maps_null_space_to_params(self):
        # Direct unit check of the eigen analysis: a reduced Hessian with a
        # null direction spanning pose-0 x-translation and object-0 dx in
        # combination (each column individually full-norm).
        from obvi_slam_tpu.ltm import find_rank_deficiencies

        n_pose, n_obj = 2, 1
        dim = n_pose * 6 + n_obj * 7
        rng = np.random.default_rng(3)
        basis = rng.normal(size=(dim, dim))
        q, _ = np.linalg.qr(basis)
        lam = np.full(dim, 10.0)
        # Null direction = (e_pose0_x + e_obj0_dx)/sqrt(2).
        v0 = np.zeros(dim)
        v0[0] = 1.0
        v0[n_pose * 6 + 4] = 1.0
        v0 /= np.linalg.norm(v0)
        h = 10.0 * (np.eye(dim) - np.outer(v0, v0))
        state = {
            "pose": np.arange(n_pose * 6, dtype=float).reshape(n_pose, 6),
            "object": np.arange(n_obj * 7, dtype=float).reshape(n_obj, 7) + 100,
        }
        found = find_rank_deficiencies(h, state, min_col_norm=5e-4)
        keys = {(k, r, c) for (k, r, c, _, _) in found}
        assert (0, 0, 0) in keys  # pose 0, param 0
        assert (2, 0, 4) in keys  # object 0, param 4 (dx)
        assert len(keys) == 2  # nothing else prior'd
        # Means taken from the state; repair strength near sqrt(min_col_norm).
        for k, r, c, mean, inv_std in found:
            expect = state["pose"][r, c] if k == 0 else state["object"][r, c]
            assert mean == expect
            assert 0 < inv_std <= np.sqrt(5e-4)

    def test_fallback_to_previous(self):
        prev = LongTermObjectMap(
            ellipsoids={5: ("chair", np.arange(7.0))},
            covariances={5: np.eye(7)},
        )
        pg = PoseGraph({}, {})
        config = object_config()
        # Empty pose graph -> trivial map, no failure; force a failure path by
        # monkeypatching _extract.
        import obvi_slam_tpu.ltm as ltm_mod

        orig = ltm_mod._extract
        ltm_mod._extract = lambda *a, **k: None
        try:
            out = extract_long_term_object_map(pg, config, {}, prev_ltm=prev)
            assert out is prev
        finally:
            ltm_mod._extract = orig


class TestMultiSession:
    def test_second_session_reassociates_ltm_objects(self):
        # Session 1 -> LTM; session 2 (same scene, different noise) must merge
        # its detections into the LTM objects instead of duplicating them.
        data1, gt_poses, gt_objects = make_object_session(seed=21)
        config = object_config()
        pg1, fe1 = run_session(data1, config)
        ltm = extract_long_term_object_map(pg1, config, fe1.get_front_end_obj_map_data())
        assert len(ltm.ellipsoids) == 2

        data2, _, _ = make_object_session(seed=99)
        pg2, fe2 = run_session(data2, config, ltm=ltm)
        # LTM objects present in second session's graph.
        assert set(ltm.ellipsoids).issubset(set(pg2.objects) | set(pg2.merged_objects))
        # No duplicates: still exactly 2 objects after merges.
        assert len(pg2.objects) == 2, (
            len(pg2.objects),
            {o: pg2.objects[o].ellipsoid[:3] for o in pg2.objects},
        )
        # The survivors are the LTM objects (LTM survivor rule).
        assert set(pg2.objects) == set(ltm.ellipsoids)
        # And they have new observations from session 2.
        for obj_id in pg2.objects:
            assert len(pg2.obj_obs_by_object[obj_id]) > 0


class TestPairwiseCovarianceLtm:
    def test_extraction_and_consistency_with_independent(self, tmp_path):
        import dataclasses as dc

        from obvi_slam_tpu.ltm_pairwise import (
            PairwiseCovarianceLongTermObjectMap,
            extract_pairwise_covariance_ltm,
        )

        data, gt_poses, gt_objects = make_object_session(seed=21)
        config = object_config()
        pg, fe = run_session(data, config)
        config2 = dc.replace(config)
        config2.optimization_factors_enabled_params = dc.replace(
            config.optimization_factors_enabled_params,
            min_low_level_feature_observations_per_frame=10**9,
        )
        pltm = extract_pairwise_covariance_ltm(pg, config2, {})
        assert pltm is not None
        objs = sorted(pg.objects)
        # Diagonal blocks present for both objects + the cross block.
        assert (objs[0], objs[0]) in pltm.pairwise_covariances
        assert (objs[0], objs[1]) in pltm.pairwise_covariances
        # Diagonal blocks approx match the independent extraction (both use
        # the ridge-regularized inverse; compare loosely on well-conditioned
        # entries: position variances).
        ltm_ind = extract_long_term_object_map(pg, config2, {})
        for o in objs:
            d_pair = np.diag(pltm.pairwise_covariances[(o, o)])[:3]
            d_ind = np.diag(ltm_ind.covariances[o])[:3]
            np.testing.assert_allclose(d_pair, d_ind, rtol=0.2)
        # Serialization roundtrip.
        p = tmp_path / "pltm.json"
        pltm.save(str(p))
        p2 = PairwiseCovarianceLongTermObjectMap.load(str(p))
        np.testing.assert_allclose(
            p2.pairwise_covariances[(objs[0], objs[1])],
            pltm.pairwise_covariances[(objs[0], objs[1])],
        )
        # Bridge to the independent factor path.
        ind = pltm.to_independent()
        assert set(ind.covariances) == set(objs)
