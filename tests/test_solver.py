"""LM + Schur solver tests on synthetic BA problems: ground-truth recovery,
convergence semantics, fixed-block and outlier-weight handling."""

import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation

import obvi_slam_tpu.solver as slv
from obvi_slam_tpu import geometry as geo
from obvi_slam_tpu import types as T

RNG = np.random.default_rng(11)


def build_synthetic_ba(n_poses=6, n_points=30, with_objects=False, noise=0.0, seed=3):
    rng = np.random.default_rng(seed)
    gt_poses = np.zeros((n_poses, 6))
    gt_poses[:, 0] = np.arange(n_poses) * 0.4
    gt_poses[:, 4] = rng.normal(size=n_poses) * 0.02  # slight yaw wiggle
    gt_points = np.stack(
        [rng.uniform(-4, 4, n_points), rng.uniform(-2, 2, n_points), rng.uniform(5, 14, n_points)],
        axis=1,
    )
    n_objs = 2 if with_objects else 1
    gt_objects = np.zeros((n_objs, 7))
    if with_objects:
        gt_objects[0] = [1.0, 0.3, 8.0, 0.4, 1.2, 0.8, 1.6]
        gt_objects[1] = [-1.5, -0.2, 11.0, -0.2, 0.9, 1.1, 2.0]

    cams = T.make_camera_bundle(
        np.eye(3)[None], np.zeros((1, 3)), [500.0], [500.0], [320.0], [240.0]
    )

    pose_idx, pt_idx, obs, mult = [], [], [], []
    for i in range(n_poses):
        for j in range(n_points):
            proj, depth = geo.project_point_rectified(
                jnp.asarray(gt_poses[i]), jnp.asarray(gt_points[j]), jnp.eye(3), jnp.zeros(3)
            )
            if float(depth) > 1.0:
                pose_idx.append(i)
                pt_idx.append(j)
                obs.append(np.asarray(proj) + rng.normal(size=2) * noise / 500.0)
                mult.append([500.0 / 2.0, 500.0 / 2.0])
    reproj = T.make_reprojection_factors(pose_idx, pt_idx, [0] * len(obs), obs, mult)

    # Odometry factors pin scale + gauge together with fixing pose 0.
    before, after, meas_t, meas_r, si = [], [], [], [], []
    sqrt_inf = np.diag([100.0] * 3 + [200.0] * 3)
    for i in range(n_poses - 1):
        rel = np.array(geo.pose_between(jnp.asarray(gt_poses[i]), jnp.asarray(gt_poses[i + 1])))
        before.append(i)
        after.append(i + 1)
        meas_t.append(rel[:3])
        meas_r.append(Rotation.from_rotvec(rel[3:]).as_matrix())
        si.append(sqrt_inf)
    relpose = T.make_relative_pose_factors(before, after, meas_t, meas_r, si)

    tables = T.empty_factor_tables()._replace(reproj=reproj, relpose=relpose)

    if with_objects:
        bb_obj, bb_pose, bb_corners, bb_si = [], [], [], []
        s_inf = np.diag([1 / 30.0] * 4) @ np.diag([500.0] * 4)
        for k in range(n_objs):
            for i in range(n_poses):
                c, valid = geo.ellipsoid_corners_rectified(
                    jnp.asarray(gt_objects[k]), jnp.asarray(gt_poses[i]), jnp.eye(3), jnp.zeros(3)
                )
                if bool(valid):
                    bb_obj.append(k)
                    bb_pose.append(i)
                    bb_corners.append(np.asarray(c))
                    bb_si.append(s_inf)
        bbox = T.make_bounding_box_factors(bb_obj, bb_pose, [0] * len(bb_obj), bb_corners, bb_si)
        shape = T.make_shape_prior_factors(
            list(range(n_objs)),
            gt_objects[:, 4:7],
            [np.diag([1.0 / 0.5] * 3)] * n_objs,
        )
        tables = tables._replace(bbox=bbox, shape=shape)

    state_gt = T.BAState(jnp.asarray(gt_poses), jnp.asarray(gt_points), jnp.asarray(gt_objects))
    return state_gt, cams, tables


def perturb(state, pose_sigma=0.05, point_sigma=0.2, obj_sigma=0.1, seed=5):
    rng = np.random.default_rng(seed)
    poses = np.asarray(state.poses).copy()
    poses[1:] += rng.normal(size=poses[1:].shape) * pose_sigma
    points = np.asarray(state.points) + rng.normal(size=state.points.shape) * point_sigma
    objects = np.asarray(state.objects).copy()
    objects += rng.normal(size=objects.shape) * obj_sigma
    return T.BAState(jnp.asarray(poses), jnp.asarray(points), jnp.asarray(objects))


def free_masks(state, fix_first_pose=True):
    pose_free = np.ones(state.poses.shape[0], dtype=bool)
    if fix_first_pose:
        pose_free[0] = False
    return T.FreeMasks(
        poses=jnp.asarray(pose_free),
        points=jnp.ones(state.points.shape[0], dtype=bool),
        objects=jnp.ones(state.objects.shape[0], dtype=bool),
    )


class TestVisualOnlyBA:
    def test_recovers_ground_truth(self):
        state_gt, cams, tables = build_synthetic_ba()
        state0 = perturb(state_gt)
        plan = slv.build_schur_plan(tables)
        free = free_masks(state_gt)
        state, summary = slv.solve(state0, cams, tables, plan, free)
        assert summary.final_cost < 1e-10, summary
        pose_err = np.abs(np.asarray(state.poses) - np.asarray(state_gt.poses)).max()
        point_err = np.abs(np.asarray(state.points) - np.asarray(state_gt.points)).max()
        assert pose_err < 1e-5, pose_err
        assert point_err < 1e-4, point_err
        assert summary.termination in (
            "FUNCTION_TOLERANCE",
            "PARAMETER_TOLERANCE",
            "GRADIENT_TOLERANCE",
        )

    def test_cost_monotone_decreasing_on_accepted(self):
        state_gt, cams, tables = build_synthetic_ba(noise=1.0)
        state0 = perturb(state_gt)
        plan = slv.build_schur_plan(tables)
        state, summary = slv.solve(state0, cams, tables, plan, free_masks(state_gt))
        costs = [r.cost for r in summary.iterations if r.accepted]
        assert all(b < a + 1e-12 for a, b in zip(costs, costs[1:]))
        assert summary.final_cost <= summary.initial_cost

    def test_fixed_pose_untouched(self):
        state_gt, cams, tables = build_synthetic_ba()
        state0 = perturb(state_gt)
        plan = slv.build_schur_plan(tables)
        state, _ = slv.solve(state0, cams, tables, plan, free_masks(state_gt))
        np.testing.assert_array_equal(
            np.asarray(state.poses[0]), np.asarray(state0.poses[0])
        )

    def test_zero_iterations(self):
        state_gt, cams, tables = build_synthetic_ba()
        plan = slv.build_schur_plan(tables)
        state0 = perturb(state_gt)
        state, summary = slv.solve(
            state0, cams, tables, plan, free_masks(state_gt), params=slv.LMParams(max_num_iterations=0)
        )
        np.testing.assert_array_equal(np.asarray(state.poses), np.asarray(state0.poses))
        assert summary.final_cost == summary.initial_cost


class TestObjectBA:
    def test_joint_recovery(self):
        state_gt, cams, tables = build_synthetic_ba(with_objects=True)
        state0 = perturb(state_gt)
        plan = slv.build_schur_plan(tables)
        state, summary = slv.solve(state0, cams, tables, plan, free_masks(state_gt))
        assert summary.final_cost < 1e-8, summary
        obj_err = np.abs(np.asarray(state.objects) - np.asarray(state_gt.objects)).max()
        assert obj_err < 1e-3, obj_err

    def test_object_only_solve_with_fixed_poses(self):
        # Pending-object mini-BA analog (pending_object_estimator.cpp:19-151):
        # poses constant, bbox + shape priors only.
        state_gt, cams, tables = build_synthetic_ba(with_objects=True)
        tables = tables._replace(
            reproj=T.empty_reprojection_factors(),
            relpose=T.empty_relative_pose_factors(),
        )
        state0 = perturb(state_gt, pose_sigma=0.0, point_sigma=0.0, obj_sigma=0.2)
        plan = slv.build_schur_plan(tables)
        free = T.FreeMasks(
            poses=jnp.zeros(state_gt.poses.shape[0], dtype=bool),
            points=jnp.zeros(state_gt.points.shape[0], dtype=bool),
            objects=jnp.ones(state_gt.objects.shape[0], dtype=bool),
        )
        state, summary = slv.solve(state0, cams, tables, plan, free)
        np.testing.assert_array_equal(np.asarray(state.poses), np.asarray(state0.poses))
        obj_err = np.abs(np.asarray(state.objects) - np.asarray(state_gt.objects)).max()
        assert obj_err < 1e-2, (obj_err, summary.final_cost)


class TestOutlierWeights:
    def test_outlier_downweight_changes_solution(self):
        state_gt, cams, tables = build_synthetic_ba(n_poses=4, n_points=12)
        # Corrupt one observation badly.
        rect = np.asarray(tables.reproj.rect_obs).copy()
        rect[0] += 0.5
        tables = tables._replace(reproj=tables.reproj._replace(rect_obs=jnp.asarray(rect)))
        plan = slv.build_schur_plan(tables)
        free = free_masks(state_gt)
        state0 = perturb(state_gt, pose_sigma=0.01, point_sigma=0.05)

        w_all = slv.ones_weights(tables)
        _, sum_all = slv.solve(state0, cams, tables, plan, free, weights=w_all)
        w_out = w_all._replace(reproj=w_all.reproj.at[0].set(0.0))
        state_excl, sum_excl = slv.solve(state0, cams, tables, plan, free, weights=w_out)
        # Excluding the corrupted factor must reach (near) zero cost.
        assert sum_excl.final_cost < 1e-9
        assert sum_all.final_cost > sum_excl.final_cost


class TestLtmPrior:
    def test_prior_pulls_object(self):
        state_gt, cams, tables = build_synthetic_ba(with_objects=True)
        # Strong LTM prior at a shifted mean, with no other object factors.
        mean = np.asarray(state_gt.objects[0]).copy()
        mean[0] += 1.0
        ltm = T.make_ltm_prior_factors([0], [mean], [np.eye(7) * 100.0])
        tables = T.empty_factor_tables()._replace(ltm=ltm)
        plan = slv.build_schur_plan(tables)
        free = T.FreeMasks(
            poses=jnp.zeros(state_gt.poses.shape[0], dtype=bool),
            points=jnp.zeros(state_gt.points.shape[0], dtype=bool),
            objects=jnp.ones(state_gt.objects.shape[0], dtype=bool),
        )
        state, summary = slv.solve(state_gt, cams, tables, plan, free)
        np.testing.assert_allclose(np.asarray(state.objects[0]), mean, atol=1e-6)


class TestSlotLayout:
    """The per-landmark slot grid behind the one-hot Schur assembly."""

    def test_slot_layout_roundtrip(self):
        from obvi_slam_tpu.solver.schur import _slot_layout

        rng = np.random.default_rng(5)
        n_pairs = 37
        pair_block = rng.integers(0, 9, n_pairs)  # pose per pair
        # landmarks with uneven degrees, ids non-contiguous
        pair_land = np.repeat([2, 5, 11, 12, 40], [3, 9, 1, 20, 4])
        # every (pose, land) pair must be unique per landmark group
        for land in np.unique(pair_land):
            idx = np.nonzero(pair_land == land)[0]
            pair_block[idx] = rng.choice(64, size=len(idx), replace=False)
        gather, pose, mask, land = _slot_layout(pair_block, pair_land, n_pairs)
        # grid shapes bucketed
        assert gather.shape == pose.shape == mask.shape
        assert land.shape[0] == gather.shape[0]
        assert gather.shape[1] >= 20  # max degree
        # exactly one live slot per pair, pointing back at the right pair
        assert int(mask.sum()) == n_pairs
        rows, cols = np.nonzero(mask)
        back = gather[rows, cols]
        assert sorted(back.tolist()) == list(range(n_pairs))
        # slot pose/land match the pair they reference
        np.testing.assert_array_equal(pose[rows, cols], pair_block[back])
        np.testing.assert_array_equal(land[rows], pair_land[back])

    def test_slot_layout_empty(self):
        from obvi_slam_tpu.solver.schur import _slot_layout

        gather, pose, mask, land = _slot_layout(
            np.zeros(0, np.int64), np.zeros(0, np.int64), 0
        )
        assert mask.sum() == 0 and gather.shape[0] >= 1

    def test_capacity_grid(self):
        from obvi_slam_tpu.solver.schur import _round_up

        # {2^k, 1.5*2^k} grid, monotone, >= n
        for n in [1, 63, 64, 65, 96, 97, 128, 24576, 24577, 32768]:
            cap = _round_up(n)
            assert cap >= max(n, 64)
        assert _round_up(24576) == 24576  # 1.5 * 2^14 — no waste
        assert _round_up(97) == 128
        assert _round_up(96) == 96


class TestCapsPool:
    """Session high-water capacity pools: passing a larger window's observed
    caps into a smaller window's build must reproduce the SAME array shapes
    (one jit signature for both), and a window that outgrows the pool must
    still get capacities that fit."""

    @staticmethod
    def _make_pg(n_frames, n_feats):
        from obvi_slam_tpu.pose_graph import CameraInfo, PoseGraph

        K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
        pg = PoseGraph({1: CameraInfo(K, np.eye(3), np.zeros(3))})
        rng = np.random.default_rng(7)
        pts = np.stack(
            [rng.uniform(-3, 3, n_feats), rng.uniform(-1, 1, n_feats), rng.uniform(5, 12, n_feats)],
            axis=1,
        )
        for i in range(n_frames):
            pose = np.zeros(6)
            pose[0] = 0.3 * i
            pg.add_frame(i, pose)
            if i:
                rel = np.zeros(6)
                rel[0] = 0.3
                pg.add_pose_factor(i - 1, i, rel, np.eye(6) * 1e-4)
        for j in range(n_feats):
            pg.add_feature(j, pts[j])
            for i in range(n_frames):
                pg.add_visual_factor(i, 1, j, [320.0 + j, 240.0 + i], 1.3)
        return pg

    def _shapes(self, problem):
        import jax

        return jax.tree_util.tree_map(
            lambda x: getattr(x, "shape", None),
            (problem.state, problem.tables, problem.plan, problem.free),
        )

    def test_pool_pins_smaller_window_to_same_signature(self):
        from obvi_slam_tpu.solver.problem import Scope, build_problem, update_caps_pool

        pg = self._make_pg(n_frames=10, n_feats=25)
        pool = {}
        big = build_problem(pg, Scope(0, 9), None, caps=pool)
        update_caps_pool(pool, big)
        small = build_problem(pg, Scope(6, 9), None, caps=pool)
        assert self._shapes(small) == self._shapes(big)
        # pool unchanged by the smaller build
        update_caps_pool(pool, small)
        again = build_problem(pg, Scope(4, 9), None, caps=pool)
        assert self._shapes(again) == self._shapes(big)

    def test_window_outgrowing_pool_still_fits(self):
        from obvi_slam_tpu.solver.problem import Scope, build_problem, update_caps_pool

        pg = self._make_pg(n_frames=12, n_feats=30)
        pool = {}
        small = build_problem(pg, Scope(8, 11), None, caps=pool)
        update_caps_pool(pool, small)
        big = build_problem(pg, Scope(0, 11), None, caps=pool)
        # every live factor row fits under its mask capacity
        t = big.tables
        assert t.reproj.mask.shape[0] >= len(big.reproj_rows)
        assert big.state.poses.shape[0] >= 12
        assert big.state.points.shape[0] >= 30
        # and the big build's solution matches a pool-free build numerically
        free_build = build_problem(pg, Scope(0, 11), None)
        import obvi_slam_tpu.factors as fac

        def cost(p):
            return float(
                fac.total_cost(
                    p.state, p.cams, p.tables,
                    huber_reproj=p.huber.reproj, huber_bbox=p.huber.bbox,
                    huber_shape=p.huber.shape, huber_relpose=p.huber.relpose,
                    huber_ltm=p.huber.ltm, invalid_error=p.huber.invalid_ellipse_error,
                    reproj_weight=p.weights.reproj, bbox_weight=p.weights.bbox,
                    shape_weight=p.weights.shape, relpose_weight=p.weights.relpose,
                    ltm_weight=p.weights.ltm,
                )
            )

        np.testing.assert_allclose(cost(big), cost(free_build), rtol=1e-9)


class TestColumnarMirrors:
    """PoseGraph's struct-of-arrays factor mirrors must stay in sync with
    the object stores through incremental growth and object merges."""

    def _pg(self):
        from obvi_slam_tpu.pose_graph import CameraInfo, PoseGraph

        K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
        pg = PoseGraph(
            {1: CameraInfo(K, np.eye(3), np.zeros(3))},
            {"chair": (np.array([0.6, 0.6, 1.0]), np.eye(3) * 0.1)},
        )
        pg.add_frame(0, np.zeros(6))
        pg.add_frame(1, np.ones(6) * 0.1)
        return pg

    def test_incremental_extension(self):
        pg = self._pg()
        pg.add_feature(5, np.array([0.0, 0.0, 8.0]))
        pg.add_visual_factor(0, 1, 5, [10.0, 20.0], 1.3)
        c1 = pg.visual_factor_columns()
        assert c1["feature_id"].tolist() == [5]
        # add more AFTER materialization; columns must extend
        pg.add_visual_factor(1, 1, 5, [11.0, 21.0], 1.5)
        c2 = pg.visual_factor_columns()
        assert c2["frame_id"].tolist() == [0, 1]
        assert c2["pixel"][1].tolist() == [11.0, 21.0]
        assert c2["std"].tolist() == [1.3, 1.5]
        # earlier view is unaffected in its range
        np.testing.assert_array_equal(c1["feature_id"], [5])

    def test_merge_syncs_object_ids_and_tombstones(self):
        pg = self._pg()
        a = pg.add_new_ellipsoid(np.array([1, 0, 7, 0, 0.6, 0.6, 1.0]), "chair")
        b = pg.add_new_ellipsoid(np.array([1.1, 0, 7, 0, 0.6, 0.6, 1.0]), "chair")
        pg.add_object_observation(a, 0, 1, np.array([1.0, 2, 3, 4]), np.eye(4) * 900)
        pg.add_object_observation(b, 1, 1, np.array([5.0, 6, 7, 8]), np.eye(4) * 900)
        # materialize BEFORE the merge; the mirror must be updated in place
        oo = pg.object_observation_columns()
        sp = pg.shape_prior_columns()
        assert oo["object_id"].tolist() == [a, b]
        assert sp["object_id"].tolist() == [a, b]
        pg.merge_objects(b, a)
        oo = pg.object_observation_columns()
        sp = pg.shape_prior_columns()
        assert oo["object_id"].tolist() == [a, a]
        assert sp["object_id"].tolist() == [a, -1]  # tombstoned prior

    def test_sqrt_inf_cached_matches_scipy(self):
        import scipy.linalg

        from obvi_slam_tpu.pose_graph import batched_sqrt_inf

        rng = np.random.default_rng(5)
        m = rng.normal(size=(6, 4, 4))
        covs = m @ np.swapaxes(m, 1, 2) + np.eye(4) * 0.5
        batched = batched_sqrt_inf(covs)
        for i in range(len(covs)):
            ref = np.real(scipy.linalg.sqrtm(np.linalg.inv(covs[i])))
            np.testing.assert_allclose(batched[i], ref, rtol=1e-9, atol=1e-12)


class TestInclusionRules:
    def test_ltm_object_with_all_observations_excluded_is_dropped(self):
        """Reference selection: an object (even LTM) needs >= 1 LIVE
        observation in the window; excluding all its bbox factors as
        outliers must also drop its shape/LTM priors (phase 2 must not
        optimize the object against priors alone)."""
        from obvi_slam_tpu.pose_graph import (
            OBJECT_OBSERVATION_FACTOR,
            CameraInfo,
            PoseGraph,
        )
        from obvi_slam_tpu.solver.problem import (
            Scope,
            build_problem,
            reweight_for_exclusions,
        )

        K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
        pg = PoseGraph(
            {1: CameraInfo(K, np.eye(3), np.zeros(3))},
            {"chair": (np.array([0.6, 0.6, 1.0]), np.eye(3) * 0.1)},
        )
        for i in range(3):
            pg.add_frame(i, np.array([0.3 * i, 0, 0, 0, 0, 0.0]))
            if i:
                pg.add_pose_factor(i - 1, i, np.array([0.3, 0, 0, 0, 0, 0.0]), np.eye(6) * 1e-4)
        obj = 7
        pg.add_ltm_object(obj, np.array([1.0, 0, 7, 0, 0.6, 0.6, 1.0]), "chair")
        pg.add_ltm_factor(obj, np.array([1.0, 0, 7, 0, 0.6, 0.6, 1.0]), np.eye(7) * 0.01)
        fids = [
            pg.add_object_observation(obj, i, 1, np.array([300.0, 340, 220, 260]), np.eye(4) * 900)
            for i in range(3)
        ]
        scope = Scope(0, 2, min_object_observations=1)
        problem = build_problem(pg, scope, None)
        # live without exclusions
        assert float(np.asarray(problem.weights.ltm).max()) == 1.0
        excluded = {(OBJECT_OBSERVATION_FACTOR, f) for f in fids}
        w2 = reweight_for_exclusions(pg, problem, excluded)
        assert float(np.asarray(w2.bbox).max()) == 0.0
        assert float(np.asarray(w2.ltm).max()) == 0.0
        assert float(np.asarray(w2.shape).max()) == 0.0

    def test_missing_id_fails_loudly(self):
        """A factor referencing a frame with no pose node must raise at
        build time, not silently index a wrong row."""
        from obvi_slam_tpu.pose_graph import CameraInfo, PoseGraph
        from obvi_slam_tpu.solver.problem import Scope, build_problem

        K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
        pg = PoseGraph({1: CameraInfo(K, np.eye(3), np.zeros(3))})
        pg.add_frame(0, np.zeros(6))
        pg.add_frame(1, np.zeros(6))
        pg.add_feature(3, np.array([0.0, 0, 8.0]))
        pg.add_visual_factor(0, 1, 3, [320.0, 240.0], 1.3)
        pg.add_visual_factor(1, 1, 3, [321.0, 240.0], 1.3)
        # Factor for frame 2, which has NO pose node.
        pg.add_visual_factor(2, 1, 3, [322.0, 240.0], 1.3)
        del pg.robot_poses[1]  # shrink window below the factor's frame range
        pg.add_frame(1, np.zeros(6))
        import pytest as _pytest

        with _pytest.raises(KeyError):
            build_problem(pg, Scope(0, 2), None)
