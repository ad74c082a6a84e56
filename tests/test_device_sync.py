"""Device-resident session tables: diff-sync correctness.

The reference rebuilds its Ceres problem per window
(``object_pose_graph_optimizer.h:412-472``); our replacement keeps
the session's factor tables device-resident and uploads only changed rows
(solver/device_sync.py). These tests pin:
  - a synced runner session produces the same trajectory as an unsynced one,
  - the delta path uploads strictly fewer bytes than the full payload while
    leaving device contents equal to the host arrays,
  - the global-BA row registry keeps landmark rows stable under out-of-order
    id arrival and object-merge tombstones.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from obvi_slam_tpu.solver.device_sync import DeviceSync
from obvi_slam_tpu.solver.problem import Scope, build_problem

from test_runner_e2e import make_session, small_config


class TestDeviceSyncUnit:
    def test_full_then_delta_then_reuse(self):
        sync = DeviceSync()
        a = np.arange(128, dtype=np.float32).reshape(64, 2)
        b = np.arange(64, dtype=np.int32)
        tree = {"a": a, "b": b}
        out = sync.sync("t", tree)
        assert all(m == "full" for m, _ in sync.last_detail.values())
        np.testing.assert_array_equal(np.asarray(out["a"]), a)
        full_bytes = sync.last_bytes
        assert full_bytes == a.nbytes + b.nbytes

        # One changed row -> delta on both (unchanged leaves ride the
        # delta path with idempotent no-op rows so the applier layout — and
        # with it the compiled update program — stays stable).
        a2 = a.copy()
        a2[3] = [100.0, 101.0]
        out2 = sync.sync("t", {"a": a2, "b": b.copy()})
        detail = sync.last_detail
        assert detail["t['a']"][0] == "delta"
        assert detail["t['b']"][0] == "delta"
        np.testing.assert_array_equal(np.asarray(out2["a"]), a2)
        np.testing.assert_array_equal(np.asarray(out2["b"]), b)
        assert sync.last_bytes < full_bytes

        # Identical -> same layout, only min-bucket no-op rows uploaded.
        out3 = sync.sync("t", {"a": a2.copy(), "b": b.copy()})
        assert sync.last_bytes < full_bytes
        np.testing.assert_array_equal(np.asarray(out3["a"]), a2)

    def test_shape_growth_forces_full(self):
        sync = DeviceSync()
        a = np.ones((4, 3), np.float32)
        sync.sync("t", [a])
        grown = np.ones((8, 3), np.float32) * 2
        out = sync.sync("t", [grown])
        assert sync.last_detail["t[0]"][0] == "full"
        np.testing.assert_array_equal(np.asarray(out[0]), grown)

    def test_bool_and_scalarish_leaves(self):
        sync = DeviceSync()
        m = np.array([True, False, True])
        out = sync.sync("t", {"m": m})
        m2 = np.array([True, True, True])
        out = sync.sync("t", {"m": m2})
        np.testing.assert_array_equal(np.asarray(out["m"]), m2)

    def test_adopt_marks_clean(self):
        sync = DeviceSync()
        a = np.zeros((4, 2), np.float32)
        out = sync.sync("t", [a])
        solved_host = np.full((4, 2), 7.0, np.float32)
        solved_dev = jnp.asarray(solved_host)
        sync.adopt("t", [solved_dev], [solved_host])
        out2 = sync.sync("t", [solved_host.copy()])
        # Adopted state diffs clean: only the min-bucket no-op rows move.
        assert sync.last_detail["t[0]"][0] == "delta"
        np.testing.assert_array_equal(np.asarray(out2[0]), solved_host)


class TestRowRegistry:
    def _pg(self, feature_ids):
        from obvi_slam_tpu.pose_graph import CameraInfo, PoseGraph

        K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
        pg = PoseGraph({1: CameraInfo(K, np.eye(3), np.zeros(3))})
        for f in range(4):
            pg.add_frame(f, np.array([0.1 * f, 0, 0, 0, 0, 0.0]))
        for fid in feature_ids:
            pg.add_feature(fid, np.array([0.5, 0.2, 5.0]))
            for f in range(4):
                pg.add_visual_factor(f, 1, fid, np.array([320.0 + fid, 240.0]), 1.0)
        return pg

    def test_rows_stable_under_out_of_order_ids(self):
        scope = Scope(min_frame_id=0, max_frame_id=3,
                      min_low_level_feature_observations=1,
                      min_low_level_feature_observations_per_frame=0)
        reg = {}
        pg = self._pg([10, 30])
        p1 = build_problem(pg, scope, row_registry=reg, to_device=False)
        rows1 = {f: i for i, f in enumerate(p1.point_rows)}
        # Feature 20 arrives later with an id BETWEEN existing ones: sorted
        # assignment would shift feature 30's row; the registry must not.
        pg2 = self._pg([10, 30])
        pg2.add_feature(20, np.array([0.1, 0.1, 4.0]))
        for f in range(4):
            pg2.add_visual_factor(f, 1, 20, np.array([300.0, 240.0]), 1.0)
        p2 = build_problem(pg2, scope, row_registry=reg, to_device=False)
        rows2 = {f: i for i, f in enumerate(p2.point_rows)}
        assert rows2[10] == rows1[10]
        assert rows2[30] == rows1[30]
        assert rows2[20] == 2  # appended
        # Factor tables reference the registry rows.
        rp = p2.tables.reproj
        live = np.asarray(rp.mask)
        pt = np.asarray(rp.point_idx)[live]
        assert set(pt.tolist()) == {0, 1, 2}
        # State rows carry the right values.
        np.testing.assert_allclose(
            np.asarray(p2.state.points)[rows2[20]], [0.1, 0.1, 4.0]
        )

    def test_merged_object_tombstone(self):
        from obvi_slam_tpu.pose_graph import CameraInfo, PoseGraph

        K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
        pg = PoseGraph({1: CameraInfo(K, np.eye(3), np.zeros(3))})
        for f in range(3):
            pg.add_frame(f, np.array([0.1 * f, 0, 0, 0, 0, 0.0]))
        pg.shape_mean_and_cov_by_class["chair"] = (
            np.array([0.5, 0.5, 0.5]), np.eye(3) * 0.1,
        )
        for oid in (0, 1):
            pg.initialize_ellipsoid_with_id(
                oid, np.array([1.0 + oid, 0, 5, 0, 0.5, 0.5, 0.5]), "chair"
            )
            for f in range(3):
                pg.add_object_observation(
                    oid, f, 1, np.array([100.0, 200.0, 100.0, 200.0]), np.eye(4)
                )
        scope = Scope(min_frame_id=0, max_frame_id=2,
                      min_object_observations=1,
                      min_low_level_feature_observations_per_frame=0)
        reg = {}
        p1 = build_problem(pg, scope, row_registry=reg, to_device=False)
        assert list(p1.obj_rows) == [0, 1]
        pg.merge_objects(1, 0)
        p2 = build_problem(pg, scope, row_registry=reg, to_device=False)
        # Row 1 is a tombstone: kept, zeroed, not free.
        assert list(p2.obj_rows) == [0, 1]
        assert not bool(np.asarray(p2.free.objects)[1])
        np.testing.assert_array_equal(np.asarray(p2.state.objects)[1], 0.0)
        # All observation factors now target row 0.
        bb = p2.tables.bbox
        live = np.asarray(bb.mask)
        assert set(np.asarray(bb.obj_idx)[live].tolist()) == {0}


class TestSyncedRunnerEquality:
    def test_synced_session_matches_unsynced(self):
        from obvi_slam_tpu.frontend import VisualFeatureFrontend
        from obvi_slam_tpu.pose_graph import PoseGraph
        from obvi_slam_tpu.runner import OfflineProblemRunner

        data, gt_poses, _ = make_session(n_frames=8, n_features=25)
        config = small_config()

        def run(use_sync):
            runner = OfflineProblemRunner(
                config, dtype=np.float64, use_device_sync=use_sync
            )
            pg = PoseGraph(data.cameras)
            vf = VisualFeatureFrontend(
                gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
                reprojection_error_provider=lambda *a: config.visual_feature_params.reprojection_error_std_dev,
                inlier_epipolar_err_thresh=config.visual_feature_params.inlier_epipolar_err_thresh,
                check_past_n_frames=config.visual_feature_params.check_past_n_frames_for_epipolar_err,
            )
            assert runner.run_optimization(data, pg, visual_frontend=vf)
            return pg, runner

        pg_sync, runner_sync = run(True)
        pg_plain, _ = run(False)
        for i in range(8):
            np.testing.assert_allclose(
                pg_sync.get_robot_pose(i), pg_plain.get_robot_pose(i),
                rtol=0, atol=1e-12,
            )
        rep = runner_sync.sync_report()
        assert rep and all(v["n_syncs"] > 0 for v in rep.values())
