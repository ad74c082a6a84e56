"""Tests for the comparison-approach metrics driver
(cli/compute_metrics_for_approach.py) — the trajectory_metrics_generator +
compute_metrics_for_<approach> equivalents."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

sys.path.insert(0, str(Path(__file__).parent.parent))

from cli.compute_metrics_for_approach import (
    adjust_to_origin_with_extrinsics,
    interpolate_pose_at,
    main as approach_main,
    read_est_trajectory,
)
from obvi_slam_tpu.io import timestamped as T
from obvi_slam_tpu.metrics import schema


def _compose(a, b):
    ra, ta = Rotation.from_rotvec(a[3:6]).as_matrix(), a[0:3]
    rb, tb = Rotation.from_rotvec(b[3:6]).as_matrix(), b[0:3]
    return np.concatenate(
        [ra @ tb + ta, Rotation.from_matrix(ra @ rb).as_rotvec()]
    )


def _make_bl_traj(n, seed=0):
    """Smooth baselink trajectory of n 6-vec poses."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        t = np.array([0.5 * i, 0.1 * np.sin(0.3 * i), 0.0])
        rv = np.array([0.0, 0.0, 0.05 * i]) + 0.01 * rng.normal(size=3)
        poses.append(np.concatenate([t, rv]))
    return poses


EXT = np.array([0.1, -0.2, 0.3, 0.05, -0.1, 0.2])  # sensor rel baselink
GT_EXT = np.array([-0.05, 0.1, 0.0, 0.0, 0.02, -0.01])
WORLD_OFF = np.array([3.0, -1.0, 0.5, 0.0, 0.0, 0.7])


def _write_extrinsics(path, pose):
    q = Rotation.from_rotvec(pose[3:6]).as_quat()
    with open(path, "w") as f:
        f.write("transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
        f.write(
            f"{pose[0]},{pose[1]},{pose[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n"
        )


def _setup_sequence(tmp_path, n_frames=12, lost_frame=5):
    """Two sessions over the same physical trajectory; comparison estimates
    in the sensor frame with a global world offset; GT in a third frame.

    After both sides are adjusted to baselink-starting-at-origin they agree
    exactly, so ATE must be ~0 (see adjustTrajectoryToStartAtOriginWith-
    Extrinsics algebra: E (origin^-1 pose_i) E^-1 = B_0^-1 B_i)."""
    bl = _make_bl_traj(n_frames)
    est_root = tmp_path / "est"
    gt_root = tmp_path / "gt"
    wp_dir = tmp_path / "wps"
    wp_dir.mkdir()

    seq = {
        "sequence_info": {
            "seq_id": "testseq",
            "sequence": [
                {
                    "bag_base_name": "bagA",
                    "waypoint_file_base_name": {"has_v": 1, "v": "wpA"},
                },
                {
                    "bag_base_name": "bagB",
                    "waypoint_file_base_name": {"has_v": 1, "v": "wpB"},
                },
            ],
        }
    }
    seq_file = tmp_path / "seq.json"
    seq_file.write_text(json.dumps(seq))

    for idx, name in enumerate(["0_bagA", "1_bagB"]):
        base_sec = 100 + 50 * idx
        est_entries = []
        gt_entries = []
        for i, b in enumerate(bl):
            ts = (base_sec + i, 250_000_000)
            est_pose = _compose(WORLD_OFF, _compose(b, EXT))
            if idx == 0 and i == lost_frame:
                est_entries.append((ts, None))
            else:
                est_entries.append((ts, est_pose))
            gt_entries.append((ts, _compose(b, GT_EXT)))
        est_dir = est_root / name
        est_dir.mkdir(parents=True)
        T.write_optional_poses_with_timestamps(
            str(est_dir / "trajectory.csv"), est_entries
        )
        gt_dir = gt_root / name
        gt_dir.mkdir(parents=True)
        T.write_poses_with_timestamps(
            str(gt_dir / "interpolated_lego_loam_poses.csv"), gt_entries
        )
        # Both sessions visit waypoint 7 at frame 3 and waypoint 8 at
        # frame 9 (same physical pose in both sessions).
        T.write_timestamps_and_waypoints(
            str(wp_dir / ("wpA.csv" if idx == 0 else "wpB.csv")),
            [
                ((base_sec + 3, 250_000_000), 7, False),
                ((base_sec + 9, 250_000_000), 8, idx == 1),
            ],
        )

    comp_ext_file = tmp_path / "comparison_bl.txt"
    gt_ext_file = tmp_path / "gt_bl.txt"
    _write_extrinsics(comp_ext_file, EXT)
    _write_extrinsics(gt_ext_file, GT_EXT)
    return seq_file, est_root, gt_root, wp_dir, comp_ext_file, gt_ext_file


class TestAdjustTrajectory:
    def test_matches_reference_algebra(self):
        bl = _make_bl_traj(5)
        est = [_compose(WORLD_OFF, _compose(b, EXT)) for b in bl]
        adjusted = adjust_to_origin_with_extrinsics(est, est[0], EXT)
        # E (est_0^-1 est_i) E^-1 = B_0^-1 B_i
        inv0 = np.concatenate(
            [
                -Rotation.from_rotvec(bl[0][3:6]).as_matrix().T @ bl[0][0:3],
                Rotation.from_rotvec(bl[0][3:6]).inv().as_rotvec(),
            ]
        )
        for a, b in zip(adjusted, bl):
            expect = _compose(inv0, b)
            np.testing.assert_allclose(a, expect, atol=1e-10)


class TestTrajectoryFormats:
    def test_tum_format(self, tmp_path):
        p = tmp_path / "traj.txt"
        p.write_text(
            "# ts x y z qx qy qz qw\n"
            "100.25 1.0 2.0 3.0 0 0 0 1\n"
            "101.5 2.0 3.0 4.0 0 0 0.7071068 0.7071068\n"
        )
        traj = read_est_trajectory(str(p), "tum")
        assert traj[0][0] == (100, 250_000_000)
        np.testing.assert_allclose(traj[0][1][:3], [1, 2, 3])
        assert traj[1][0][0] == 101
        np.testing.assert_allclose(
            traj[1][1][3:6], [0, 0, np.pi / 2], atol=1e-6
        )

    def test_interpolate_pose_skips_lost(self):
        traj = [
            ((100, 0), np.zeros(6)),
            ((101, 0), None),
            ((102, 0), np.array([2.0, 0, 0, 0, 0, 1.0])),
        ]
        p = interpolate_pose_at(traj, 101.0)
        np.testing.assert_allclose(p[:3], [1.0, 0, 0], atol=1e-9)
        np.testing.assert_allclose(p[5], 0.5, atol=1e-9)
        assert interpolate_pose_at(traj, 99.0) is None


class TestApproachMetricsDriver:
    def test_sequence_end_to_end(self, tmp_path):
        (seq_file, est_root, gt_root, wp_dir, comp_ext, gt_ext) = (
            _setup_sequence(tmp_path)
        )
        out_file = tmp_path / "metrics.json"
        rc = approach_main(
            [
                "--sequence_file", str(seq_file),
                "--comparison_alg_traj_est_dir", str(est_root),
                "--interpolated_gt_traj_dir", str(gt_root),
                "--comparison_alg_to_bl_extrinsics", str(comp_ext),
                "--gt_frame_to_bl_extrinsics", str(gt_ext),
                "--waypoints_files_directory", str(wp_dir),
                "--metrics_out_file", str(out_file),
            ]
        )
        assert rc == 0
        seq_m, indiv = schema.read_metrics_file(str(out_file))
        assert len(indiv) == 2
        # Exact agreement after frame adjustment: ATE ~ 0.
        assert seq_m["ate"].rmse_transl_err < 1e-6
        assert seq_m["ate"].rmse_rot_err < 1e-6
        for m in indiv:
            assert m["ate"].rmse_transl_err < 1e-6
        # Session A has one lost frame.
        assert indiv[0]["ate"].lost_poses == 1
        assert indiv[1]["ate"].lost_poses == 0
        # Waypoints were visited consistently -> near-zero deviations, two
        # visits per waypoint pooled at sequence level.
        assert len(seq_m["all_translation_deviations"]) == 4
        assert max(seq_m["all_translation_deviations"]) < 1e-6
        # Per-session waypoint artifact written alongside the trajectory.
        assert (est_root / "0_bagA" / "traj_with_waypoints.csv").exists()

    def test_inconsistent_waypoints_detected(self, tmp_path):
        (seq_file, est_root, gt_root, wp_dir, comp_ext, gt_ext) = (
            _setup_sequence(tmp_path)
        )
        # Session B's waypoint 7 moved to a different frame -> deviation.
        T.write_timestamps_and_waypoints(
            str(wp_dir / "wpB.csv"),
            [((150 + 6, 250_000_000), 7, False)],
        )
        out_file = tmp_path / "metrics.json"
        rc = approach_main(
            [
                "--sequence_file", str(seq_file),
                "--comparison_alg_traj_est_dir", str(est_root),
                "--interpolated_gt_traj_dir", str(gt_root),
                "--comparison_alg_to_bl_extrinsics", str(comp_ext),
                "--gt_frame_to_bl_extrinsics", str(gt_ext),
                "--waypoints_files_directory", str(wp_dir),
                "--metrics_out_file", str(out_file),
            ]
        )
        assert rc == 0
        seq_m, indiv = schema.read_metrics_file(str(out_file))
        assert max(seq_m["all_translation_deviations"]) > 0.5

    def test_single_trajectory_mode(self, tmp_path):
        (seq_file, est_root, gt_root, wp_dir, comp_ext, gt_ext) = (
            _setup_sequence(tmp_path)
        )
        out_file = tmp_path / "metrics_single.json"
        rc = approach_main(
            [
                "--single_trajectory_eval_base_name", "0_bagA",
                "--comparison_alg_traj_est_dir", str(est_root),
                "--interpolated_gt_traj_dir", str(gt_root),
                "--comparison_alg_to_bl_extrinsics", str(comp_ext),
                "--gt_frame_to_bl_extrinsics", str(gt_ext),
                "--metrics_out_file", str(out_file),
            ]
        )
        assert rc == 0
        seq_m, indiv = schema.read_metrics_file(str(out_file))
        assert len(indiv) == 1
        assert seq_m["ate"].rmse_transl_err < 1e-6

    def test_requires_exactly_one_mode(self, tmp_path):
        rc = approach_main(
            [
                "--comparison_alg_traj_est_dir", str(tmp_path),
                "--interpolated_gt_traj_dir", str(tmp_path),
                "--metrics_out_file", str(tmp_path / "m.json"),
            ]
        )
        assert rc == 1


class TestPerBaselineWrappers:
    def test_orbslam3_wrapper(self, tmp_path):
        """The wrapper fixes calib file names + TUM format."""
        (seq_file, est_root, gt_root, wp_dir, comp_ext, gt_ext) = (
            _setup_sequence(tmp_path)
        )
        calib_dir = tmp_path / "calib"
        calib_dir.mkdir()
        os.rename(comp_ext, calib_dir / "orb_slam3_bl.txt")
        os.rename(gt_ext, calib_dir / "lego_loam_bl.txt")
        # Rewrite session trajectories in TUM format.
        for name in ["0_bagA", "1_bagB"]:
            csv = est_root / name / "trajectory.csv"
            entries = T.read_optional_poses_with_timestamps(str(csv))
            with open(est_root / name / "trajectory.txt", "w") as f:
                for ts, pose in entries:
                    if pose is None:
                        continue
                    q = Rotation.from_rotvec(pose[3:6]).as_quat()
                    t_float = ts[0] + ts[1] * 1e-9
                    f.write(
                        f"{t_float} {pose[0]} {pose[1]} {pose[2]} "
                        f"{q[0]} {q[1]} {q[2]} {q[3]}\n"
                    )
        from cli.compute_metrics_for_orbslam3 import main as orb_main

        out_file = tmp_path / "orb_metrics.json"
        rc = orb_main(
            [
                "--sequence_file", str(seq_file),
                "--orb_slam_3_out_root_dir", str(est_root),
                "--interpolated_gt_traj_dir", str(gt_root),
                "--calibration_file_directory", str(calib_dir),
                "--metrics_out_file", str(out_file),
                "--est_traj_file_name", "trajectory.txt",
            ]
        )
        assert rc == 0
        seq_m, indiv = schema.read_metrics_file(str(out_file))
        assert len(indiv) == 2
        assert seq_m["ate"].rmse_transl_err < 1e-5


class TestOdomWaypointExtrapolation:
    """Lost-frame waypoint recovery via odometry chaining
    (interpolate3dPosesUsingOdom equivalent)."""

    def _lose_tail(self, est_root, bl, n_lost_from=8):
        """Re-write session A's trajectory with frames >= n_lost_from lost."""
        entries = []
        for i, b in enumerate(bl):
            ts = (100 + i, 250_000_000)
            pose = _compose(WORLD_OFF, _compose(b, EXT))
            entries.append((ts, None if i >= n_lost_from else pose))
        T.write_optional_poses_with_timestamps(
            str(est_root / "0_bagA" / "trajectory.csv"), entries
        )

    def _write_odom(self, odom_dir, bl):
        odom_dir.mkdir(exist_ok=True)
        entries = [((100 + i, 250_000_000), b) for i, b in enumerate(bl)]
        T.write_poses_with_timestamps(str(odom_dir / "bagA.csv"), entries)

    def test_lossy_session_waypoint_recovered(self, tmp_path):
        (seq_file, est_root, gt_root, wp_dir, comp_ext, gt_ext) = (
            _setup_sequence(tmp_path)
        )
        bl = _make_bl_traj(12)
        self._lose_tail(est_root, bl)

        def run(extra):
            out_file = tmp_path / f"metrics_{len(extra)}.json"
            rc = approach_main(
                [
                    "--sequence_file", str(seq_file),
                    "--comparison_alg_traj_est_dir", str(est_root),
                    "--interpolated_gt_traj_dir", str(gt_root),
                    "--comparison_alg_to_bl_extrinsics", str(comp_ext),
                    "--gt_frame_to_bl_extrinsics", str(gt_ext),
                    "--waypoints_files_directory", str(wp_dir),
                    "--metrics_out_file", str(out_file),
                ]
                + extra
            )
            assert rc == 0
            seq_m, _ = schema.read_metrics_file(str(out_file))
            return seq_m

        # Without odometry: session A's waypoint 8 (frame 9, lost tail)
        # contributes no pose; single-visit waypoints pool no deviations ->
        # only waypoint 7's two visits remain.
        seq_m = run([])
        assert len(seq_m["all_translation_deviations"]) == 2

        # With odometry (base_link trajectory; the global odom frame offset
        # cancels in the anchored delta): the lost waypoint is recovered
        # exactly -> 4 deviations, all ~0 like the lossless baseline.
        odom_dir = tmp_path / "odom"
        self._write_odom(odom_dir, bl)
        seq_m = run(["--odometry_files_directory", str(odom_dir)])
        assert len(seq_m["all_translation_deviations"]) == 4
        assert max(seq_m["all_translation_deviations"]) < 1e-6

    def test_extrapolate_pose_with_odom_unit(self):
        from cli.compute_metrics_for_approach import (
            extrapolate_pose_with_odom,
            in_lost_region,
        )

        bl = _make_bl_traj(8, seed=3)
        # Estimated trajectory valid through t=103, lost afterwards; odometry
        # in a different global frame (chaining must cancel it).
        off = np.array([5.0, 1.0, 0.0, 0.0, 0.0, 1.2])
        traj = [
            ((100 + i, 0), bl[i] if i <= 3 else None) for i in range(8)
        ]
        odom = [((100 + i, 0), _compose(off, bl[i])) for i in range(8)]
        assert in_lost_region(traj, 106.0)
        assert not in_lost_region(traj, 102.5)
        p = extrapolate_pose_with_odom(traj, odom, 106.0)
        np.testing.assert_allclose(p, bl[6], atol=1e-9)
