"""CLI integration tests: export a synthetic session to the reference's file
formats, run the main binary / sequence executor / metrics generators as
subprocesses, and check the artifacts."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

REPO = Path(__file__).parent.parent

from obvi_slam_tpu.synthetic import export_session, make_object_session


def write_small_config(path: Path):
    """The in-repo object-session config shrunk for the synthetic session."""
    from test_bb_frontend import object_config

    from obvi_slam_tpu.config import write_config

    write_config(object_config(), str(path))
    return path


@pytest.fixture(scope="module")
def session_files(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli_session")
    data, gt_poses, gt_objects = make_object_session(n_frames=10, seed=33)
    export_session(data, gt_poses, out)
    write_small_config(out / "config.json")
    return out, gt_poses, gt_objects


def run_cli(script, args, timeout=900):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    if "offline_object_visual_slam" in script:
        args = args + ["--platform", "cpu"]
    result = subprocess.run(
        [sys.executable, str(REPO / "cli" / script)] + args,
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
    )
    if result.returncode != 0:
        raise AssertionError(
            f"{script} failed:\nstdout={result.stdout}\nstderr={result.stderr[-3000:]}"
        )
    return result


class TestMainCli:
    @pytest.mark.slow
    def test_full_session(self, session_files):
        out, gt_poses, gt_objects = session_files
        res_dir = out / "results"
        run_cli(
            "offline_object_visual_slam_main.py",
            [
                "--params_config_file", str(out / "config.json"),
                "--intrinsics_file", str(out / "intrinsics.csv"),
                "--extrinsics_file", str(out / "extrinsics.csv"),
                "--poses_by_node_id_file", str(out / "poses.csv"),
                "--bounding_boxes_by_node_id_file", str(out / "bounding_boxes.csv"),
                "--low_level_feats_dir", str(out / "orb_out"),
                "--long_term_map_output", str(res_dir / "ltm.json"),
                "--robot_poses_results_file", str(res_dir / "robot_poses.csv"),
                "--ellipsoids_results_file", str(res_dir / "ellipsoids.csv"),
                "--visual_feature_results_file", str(res_dir / "features.csv"),
                "--opt_log_file", str(res_dir / "ceres_opt_summary.csv"),
                "--timing_report_file", str(res_dir / "timing.json"),
                "--bb_associations_out_file", str(res_dir / "bb_assoc.json"),
                "--checkpoint_output_dir", str(res_dir / "checkpoints"),
                "--logs_directory", str(res_dir / "logs"),
            ],
        )
        assert (res_dir / "robot_poses.csv").exists()
        assert (res_dir / "ellipsoids.csv").exists()
        assert (res_dir / "ltm.json").exists()

        # Four-point checkpointing (main.cpp:394-409,627-653,
        # optimization_runner.h:499-506 file names).
        ckpt_dir = res_dir / "checkpoints"
        ckpts = sorted(p.name for p in ckpt_dir.glob("*.json"))
        assert any(
            n.startswith("pose_graph_state_checkpoint_pre_optimization_")
            and "_attempt_1" in n
            for n in ckpts
        ), ckpts
        assert "pose_graph_state_checkpoint_post_frame_add.json" in ckpts
        assert "pose_graph_state_checkpoint_post_postprocessing.json" in ckpts
        assert "long_term_map_checkpoint.json" in ckpts

        # Per-LM-iteration CSVs (ceres_iterations_<type>.csv,
        # optimization_logger.h:29-118 schema).
        iter_csvs = sorted((res_dir / "logs").glob("ceres_iterations_*.csv"))
        assert iter_csvs, list((res_dir / "logs").iterdir())
        types = {p.stem.replace("ceres_iterations_", "") for p in iter_csvs}
        assert {"lba_phase_1", "gba_phase_1"} <= types, types
        with open(iter_csvs[0]) as f:
            header = f.readline().strip()
            assert header == (
                "optimization_id,iteration_num,cost,cost_change,step_norm,"
                "step_norm_per_param,is_successful"
            )
            row = f.readline().strip().split(",")
            assert len(row) == 7 and row[6] in ("0", "1"), row

        # bb-association artifact round-trip.
        sys.path.insert(0, str(REPO))
        from obvi_slam_tpu.io import read_bb_association_results

        assoc_ellipsoids, associations = read_bb_association_results(
            str(res_dir / "bb_assoc.json")
        )
        assert len(assoc_ellipsoids) == 2
        for obj_id, obs in associations.items():
            assert obj_id in assoc_ellipsoids
            for frame_id, cam_id, corners in obs:
                assert corners.shape == (4,)
        with open(res_dir / "ltm.json") as f:
            ltm = json.load(f)
        assert len(ltm["ellipsoids"]) == 2
        with open(res_dir / "timing.json") as f:
            timing = json.load(f)
        assert "global_bundle_adjustment" in timing

        # Trajectory metrics on the result.
        mfile = res_dir / "traj_metrics.json"
        r = run_cli(
            "trajectory_metrics_generator.py",
            [
                "--est_trajectory_file", str(res_dir / "robot_poses.csv"),
                "--gt_trajectory_file", str(out / "gt_poses.csv"),
                "--metrics_out_file", str(mfile),
            ],
        )
        with open(mfile) as f:
            metrics = json.load(f)
        assert metrics["rmse_transl_err"] < 0.05, metrics
        assert metrics["lost_poses"] == 0

        # Object metrics: write GT object file then compare.
        gt_file = res_dir / "gt_objects.csv"
        with open(gt_file, "w") as f:
            f.write(
                "semantic_class,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w,d_x,d_y,d_z,obj_id\n"
            )
            for k, e in enumerate(gt_objects):
                q = Rotation.from_euler("z", e[3]).as_quat()
                f.write(
                    f"chair,{e[0]},{e[1]},{e[2]},{q[0]},{q[1]},{q[2]},{q[3]},{e[4]},{e[5]},{e[6]},{k}\n"
                )
        omfile = res_dir / "obj_metrics.json"
        r = run_cli(
            "object_metrics_generator.py",
            [
                "--est_objects_file", str(res_dir / "ellipsoids.csv"),
                "--gt_objects_file", str(gt_file),
                "--metrics_out_file", str(omfile),
            ],
        )
        with open(omfile) as f:
            om = json.load(f)
        assert om["recall"] == 1.0, om
        assert om["average_pos_deviation"] < 0.5, om
        assert om["avg_iou"] > 0.3, om


class TestUtilityBinaries:
    def test_write_configuration_roundtrip(self, tmp_path):
        out = tmp_path / "default_config.json"
        r = subprocess.run(
            [sys.executable, str(REPO / "cli" / "write_configuration.py"),
             "--config_output_file", str(out)],
            capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0, r.stderr
        sys.path.insert(0, str(REPO))
        from obvi_slam_tpu.config import read_config

        c = read_config(str(out))
        assert c.config_version_id == "default"
        assert len(c.shape_dimension_priors) == 6

    def test_sparsifier(self, session_files, tmp_path):
        out, _, _ = session_files
        r = subprocess.run(
            [sys.executable, str(REPO / "cli" / "orb_trajectory_sparsifier.py"),
             "--input_poses_file", str(out / "poses.csv"),
             "--input_feature_obs_dir", str(out / "orb_out"),
             "--output_poses_file", str(tmp_path / "sparse_poses.csv"),
             "--output_feature_obs_dir", str(tmp_path / "sparse_orb"),
             "--max_pose_inc_threshold_transl", "0.35",
             "--max_pose_inc_threshold_rot", "0.5"],
            capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0, r.stderr
        from obvi_slam_tpu.io.readers import read_poses_by_node_id

        orig = read_poses_by_node_id(str(out / "poses.csv"))
        sparse = read_poses_by_node_id(str(tmp_path / "sparse_poses.csv"))
        # Frames 0.2m apart, threshold 0.35m -> roughly every other frame kept.
        assert 2 < len(sparse) < len(orig), (len(sparse), len(orig))
        # Frame ids renumbered densely from 0.
        assert sorted(sparse) == list(range(len(sparse)))
        # Feature obs files renumbered to match.
        names = sorted(p.name for p in (tmp_path / "sparse_orb").glob("*.txt"))
        assert names[0] == "000000.txt"
        assert (tmp_path / "sparse_orb" / "features" / "features.txt").exists()

    def test_interpolator(self, tmp_path):
        poses = tmp_path / "poses_ts.csv"
        with open(poses, "w") as f:
            f.write("seconds,nanoseconds,tx,ty,tz,qx,qy,qz,qw\n")
            f.write("100,0,0,0,0,0,0,0,1\n")
            f.write("101,0,1,0,0,0,0,0,1\n")
        req = tmp_path / "req_ts.csv"
        with open(req, "w") as f:
            f.write("seconds,nanoseconds\n100,500000000\n")
        out = tmp_path / "interp.csv"
        r = subprocess.run(
            [sys.executable, str(REPO / "cli" / "interpolate_poses_with_required_nodes.py"),
             "--poses_by_timestamp_file", str(poses),
             "--required_timestamps_file", str(req),
             "--poses_out_file", str(out)],
            capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0, r.stderr
        row = open(out).read().strip().splitlines()[1].split(",")
        assert abs(float(row[2]) - 0.5) < 1e-9, row


class TestCheckpointResume:
    @pytest.mark.slow
    def test_checkpoint_then_resume_and_ltm_tools(self, tmp_path):
        # Small session with checkpointing, then resume + LTM tools.
        data, gt_poses, gt_objects = make_object_session(n_frames=8, seed=44)
        out = tmp_path / "sess"
        export_session(data, gt_poses, out)
        write_small_config(out / "config.json")
        res = out / "results"
        run_cli(
            "offline_object_visual_slam_main.py",
            [
                "--params_config_file", str(out / "config.json"),
                "--intrinsics_file", str(out / "intrinsics.csv"),
                "--extrinsics_file", str(out / "extrinsics.csv"),
                "--poses_by_node_id_file", str(out / "poses.csv"),
                "--bounding_boxes_by_node_id_file", str(out / "bounding_boxes.csv"),
                "--low_level_feats_dir", str(out / "orb_out"),
                "--checkpoint_output_dir", str(res / "checkpoints"),
                "--robot_poses_results_file", str(res / "robot_poses.csv"),
            ],
        )
        ckpt = res / "checkpoints" / "pose_graph_state.json"
        assert ckpt.exists()

        # Resume from EACH of the reference's named checkpoint points
        # (pre-final-opt / post-frame-add / post-postprocessing): all must
        # load and re-run the final optimization successfully.
        named = [
            res / "checkpoints" / "pose_graph_state_checkpoint_pre_optimization_7_attempt_1.json",
            res / "checkpoints" / "pose_graph_state_checkpoint_post_frame_add.json",
            res / "checkpoints" / "pose_graph_state_checkpoint_post_postprocessing.json",
        ]
        for n in named:
            assert n.exists(), sorted(p.name for p in (res / "checkpoints").iterdir())
        for n in named:
            r = subprocess.run(
                [sys.executable, str(REPO / "cli" / "run_opt_from_pg_state.py"),
                 "--input_checkpoint_file", str(n),
                 "--params_config_file", str(out / "config.json"),
                 "--intrinsics_file", str(out / "intrinsics.csv"),
                 "--extrinsics_file", str(out / "extrinsics.csv"),
                 "--poses_by_node_id_file", str(out / "poses.csv"),
                 "--bounding_boxes_by_node_id_file", str(out / "bounding_boxes.csv"),
                 "--low_level_feats_dir", str(out / "orb_out"),
                 "--start_at_frame", "7",
                 "--robot_poses_results_file",
                 str(res / f"resumed_{n.stem[-12:]}.csv"),
                 "--platform", "cpu"],
                capture_output=True, text=True, timeout=900,
            )
            assert r.returncode == 0, (n.name, r.stderr[-2000:])

        # Resume from the checkpoint at the final frame (re-runs final opt).
        r = subprocess.run(
            [sys.executable, str(REPO / "cli" / "run_opt_from_pg_state.py"),
             "--input_checkpoint_file", str(ckpt),
             "--params_config_file", str(out / "config.json"),
             "--intrinsics_file", str(out / "intrinsics.csv"),
             "--extrinsics_file", str(out / "extrinsics.csv"),
             "--poses_by_node_id_file", str(out / "poses.csv"),
             "--bounding_boxes_by_node_id_file", str(out / "bounding_boxes.csv"),
             "--low_level_feats_dir", str(out / "orb_out"),
             "--start_at_frame", "7",
             "--robot_poses_results_file", str(res / "resumed_poses.csv"),
             "--platform", "cpu"],
            capture_output=True, text=True, timeout=900,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert (res / "resumed_poses.csv").exists()
        from obvi_slam_tpu.io.readers import read_poses_by_node_id

        resumed = read_poses_by_node_id(str(res / "resumed_poses.csv"))
        assert len(resumed) == len(gt_poses)

        # ltm_extraction_only from the checkpoint.
        r = subprocess.run(
            [sys.executable, str(REPO / "cli" / "ltm_extraction_only.py"),
             "--input_checkpoint_file", str(ckpt),
             "--params_config_file", str(out / "config.json"),
             "--intrinsics_file", str(out / "intrinsics.csv"),
             "--extrinsics_file", str(out / "extrinsics.csv"),
             "--long_term_map_output", str(res / "ltm2.json"),
             "--platform", "cpu"],
            capture_output=True, text=True, timeout=900,
        )
        assert r.returncode == 0, r.stderr[-2000:]

        # display_ltm renders it.
        r = subprocess.run(
            [sys.executable, str(REPO / "cli" / "display_ltm.py"),
             str(res / "ltm2.json"), "--covariances"],
            capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0, r.stderr
        assert "Long-term map" in r.stdout

        # timing_analysis on nothing would fail; use the timing file from the
        # earlier full-session test if present — here just check help runs.
        r = subprocess.run(
            [sys.executable, str(REPO / "cli" / "timing_analysis.py"), "--help"],
            capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0


class TestSequenceExecutor:
    @pytest.mark.slow
    def test_two_session_ltm_chaining(self, tmp_path):
        """ltm_trajectory_sequence_executor.py:44-85 equivalent: session 1's
        LTM must seed session 2 (the second run reassociates detections to
        the map's objects instead of duplicating them)."""
        seq = []
        for i, seed in enumerate((44, 45)):
            data, gt_poses, gt_objects = make_object_session(n_frames=8, seed=seed)
            sdir = tmp_path / f"sess{i}"
            export_session(data, gt_poses, sdir)
            seq.append(
                {
                    "name": f"session_{i}",
                    "intrinsics_file": str(sdir / "intrinsics.csv"),
                    "extrinsics_file": str(sdir / "extrinsics.csv"),
                    "poses_by_node_id_file": str(sdir / "poses.csv"),
                    "bounding_boxes_by_node_id_file": str(sdir / "bounding_boxes.csv"),
                    "low_level_feats_dir": str(sdir / "orb_out"),
                }
            )
        write_small_config(tmp_path / "config.json")
        with open(tmp_path / "sequence.json", "w") as f:
            json.dump(seq, f)
        out = tmp_path / "seq_out"
        r = subprocess.run(
            [sys.executable, str(REPO / "cli" / "sequence_executor.py"),
             "--sequence_file", str(tmp_path / "sequence.json"),
             "--output_dir", str(out),
             "--params_config_file", str(tmp_path / "config.json"),
             "--platform", "cpu"],
            capture_output=True, text=True, timeout=1800,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])
        ltm1 = json.load(open(out / "session_0" / "long_term_map.json"))
        ltm2 = json.load(open(out / "session_1" / "long_term_map.json"))
        assert len(ltm1["ellipsoids"]) == 2, ltm1["ellipsoids"].keys()
        # Cross-session association: the same two chairs, not four copies.
        assert len(ltm2["ellipsoids"]) == 2, ltm2["ellipsoids"].keys()
        # Both sessions produced trajectories of the right length.
        for name in ("session_0", "session_1"):
            poses = (out / name / "robot_poses.csv").read_text().strip().splitlines()
            assert len(poses) == 1 + 8


class TestRealDataSequenceMetrics:
    """The full evaluation pipeline
    (ltm_trajectory_sequence_executor.py:44-85 ->
    compute_metrics_for_ut_vslam semantics) on REAL data — two overlapping
    TUM fr2_pioneer_360 slices chained through cli/sequence_executor.py,
    waypoint files at shared physical frames, pooled waypoint-deviation
    output written in the reference's metric-file schema and re-read with
    metrics/schema.py."""

    @staticmethod
    def _tum_slice(start, n):
        """OfflineProblemData for TUM frames [start, start+n), node ids
        renumbered from 0, in the shared TUM world frame."""
        sys.path.insert(0, str(REPO / "tests"))
        import test_tum_fixture as T
        from obvi_slam_tpu.io.readers import read_tum_consecutive_matching
        from obvi_slam_tpu.offline_data import OfflineProblemData
        from obvi_slam_tpu.pose_graph import CameraInfo

        gt_all, tracks_all, _ = read_tum_consecutive_matching(
            T.TUM_DIR, max_frames=start + n
        )
        gt = {i: gt_all[start + i] for i in range(n)}
        k_inv = np.linalg.inv(T.K)

        rng = np.random.default_rng(start + 5)
        init = {0: gt[0].copy()}
        for i in range(1, n):
            rp = Rotation.from_rotvec(gt[i - 1][3:]).as_matrix()
            rc = Rotation.from_rotvec(gt[i][3:]).as_matrix()
            rel_t = rp.T @ (gt[i][:3] - gt[i - 1][:3]) + rng.normal(size=3) * 0.01
            rel_w = Rotation.from_matrix(rp.T @ rc).as_rotvec() + rng.normal(size=3) * 0.004
            rpi = Rotation.from_rotvec(init[i - 1][3:]).as_matrix()
            t = rpi @ rel_t + init[i - 1][:3]
            r = rpi @ Rotation.from_rotvec(rel_w).as_matrix()
            init[i] = np.concatenate([t, Rotation.from_matrix(r).as_rotvec()])

        tracks, feat_init = {}, {}
        for f, t in tracks_all.items():
            sub = {
                fr - start: obs for fr, obs in t.items()
                if start <= fr < start + n
            }
            if len(sub) < 3:
                continue
            x = T.triangulate(sub, gt, k_inv)
            fr0 = min(sub)
            rw = Rotation.from_rotvec(gt[fr0][3:]).as_matrix()
            pc = rw.T @ (x - gt[fr0][:3])
            if 0.3 < pc[2] < 30 and np.linalg.norm(x) < 50:
                tracks[f] = sub
                feat_init[f] = x
        assert len(tracks) > 100, len(tracks)
        data = OfflineProblemData(
            cameras={1: CameraInfo(T.K, np.eye(3), np.zeros(3))},
            feature_tracks=tracks,
            feature_init_positions=feat_init,
            initial_poses=init,
            bounding_boxes={},
        )
        return data, np.stack([gt[i] for i in range(n)])

    @staticmethod
    def _write_tum_config(path):
        with open("/root/reference/config/base7_vis_feat_only.json") as f:
            raw = json.load(f)
        c = raw["config"]
        c["sliding_window_params"] = {
            "global_ba_frequency": "8", "local_ba_window_size": "8",
        }
        en = c["optimization_factors_enabled_params"]
        en["use_pose_graph_on_global_ba"] = 0
        en["use_pose_graph_on_final_global_ba"] = 0
        en["use_visual_features_on_global_ba"] = 1
        en["use_visual_features_on_final_global_ba"] = 1
        en["min_low_level_feature_observations_per_frame"] = 15
        en["min_low_level_feature_observations"] = 3
        for key in (
            "local_ba_iteration_params",
            "global_ba_iteration_params",
            "final_ba_iteration_params",
        ):
            c[key]["phase_one_opt_params"]["max_num_iterations"] = 8
            c[key]["phase_two_opt_params"]["max_num_iterations"] = 10
        with open(path, "w") as f:
            json.dump(raw, f)
        return path

    @pytest.mark.slow
    def test_two_tum_sessions_waypoint_metrics(self, tmp_path):
        n, overlap_start = 24, 12
        slices = [(0, n), (overlap_start, n)]
        seq, session_dirs, gts = [], [], []
        for i, (start, count) in enumerate(slices):
            data, gt = self._tum_slice(start, count)
            sdir = tmp_path / f"tum{i}"
            export_session(data, gt, sdir)
            gts.append(gt)
            session_dirs.append(sdir)
            seq.append({
                "name": f"session_{i}",
                "intrinsics_file": str(sdir / "intrinsics.csv"),
                "extrinsics_file": str(sdir / "extrinsics.csv"),
                "poses_by_node_id_file": str(sdir / "poses.csv"),
                "low_level_feats_dir": str(sdir / "orb_out"),
            })
        self._write_tum_config(tmp_path / "config.json")
        with open(tmp_path / "sequence.json", "w") as f:
            json.dump(seq, f)
        out = tmp_path / "seq_out"
        r = subprocess.run(
            [sys.executable, str(REPO / "cli" / "sequence_executor.py"),
             "--sequence_file", str(tmp_path / "sequence.json"),
             "--output_dir", str(out),
             "--params_config_file", str(tmp_path / "config.json"),
             "--platform", "cpu"],
            capture_output=True, text=True, timeout=2700,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])

        # Waypoints at original frames {14, 18, 22}: both sessions visit the
        # same physical poses (the slices overlap), at different node ids.
        wp_frames = [14, 18, 22]
        results = []
        for i, (start, count) in enumerate(slices):
            wp_file = tmp_path / f"waypoints_{i}.json"
            with open(wp_file, "w") as f:
                json.dump(
                    {str(w): [fr - start] for w, fr in enumerate(wp_frames)},
                    f,
                )
            gt_file = tmp_path / f"gt_traj_{i}.csv"
            with open(gt_file, "w") as f:
                f.write("node_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
                for frame, p in enumerate(gts[i]):
                    q = Rotation.from_rotvec(p[3:6]).as_quat()
                    f.write(f"{frame},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")
            results.append({
                "name": f"session_{i}",
                "est_trajectory_file": str(out / f"session_{i}" / "robot_poses.csv"),
                "gt_trajectory_file": str(gt_file),
                "waypoints_file": str(wp_file),
            })
        with open(tmp_path / "seq_results.json", "w") as f:
            json.dump(results, f)
        metrics_out = tmp_path / "seq_metrics.json"
        ref_out = tmp_path / "ref_metrics.json"
        run_cli(
            "compute_metrics_for_sequence.py",
            ["--sequence_results_file", str(tmp_path / "seq_results.json"),
             "--metrics_out_file", str(metrics_out),
             "--ref_schema_out_file", str(ref_out)],
        )

        from obvi_slam_tpu.metrics import schema

        seq_m, indiv = schema.read_metrics_file(str(ref_out))
        assert len(indiv) == 2
        # Real-data sanity: both sessions track the TUM ground truth.
        assert seq_m["ate"].rmse_transl_err < 0.5, seq_m["ate"].rmse_transl_err
        # 3 waypoints x 2 sessions in one shared frame -> one pooled
        # deviation per visit.
        devs = seq_m["all_translation_deviations"]
        assert len(devs) == 2 * len(wp_frames)
        # Shared-world estimates at identical physical poses agree to
        # sub-half-meter (bounded by per-session drift on 24 real frames).
        assert max(devs) < 0.5, devs


class TestComparisonSystemLaunchers:
    """ROS-free third-party SLAM launchers (reference
    src/evaluation/run_orb_slam_2.py / run_multi_session_orb_slam_3.py /
    run_lego_loam.py semantics): per-session {index}_{name} dirs, dry-run
    command expansion, skip-if-legitimate-results, force rerun, and
    map chaining for the multi-session variant."""

    def _seq(self, tmp_path, names=("bagA", "bagB")):
        seq = tmp_path / "sequence.json"
        with open(seq, "w") as f:
            json.dump([{"name": n} for n in names], f)
        return seq

    def test_orbslam2_dry_run_commands(self, tmp_path):
        seq = self._seq(tmp_path)
        r = run_cli(
            "run_orb_slam_2.py",
            ["--orb_slam_vocabulary_file", "/v/voc.txt",
             "--orb_slam_configuration_file", "/c/stereo.yaml",
             "--sequence_file", str(seq),
             "--orb_slam_2_out_root_dir", str(tmp_path / "out"),
             "--session_input_root", "/bags",
             "--dry_run"],
        )
        lines = [l for l in r.stdout.splitlines() if "session" in l]
        assert len(lines) == 2
        assert "ORB_SLAM2_Stereo /v/voc.txt /c/stereo.yaml false" in lines[0]
        assert str(tmp_path / "out" / "0_bagA") in lines[0]
        assert "/bags/bagA" in lines[0]
        assert str(tmp_path / "out" / "1_bagB") in lines[1]

    def test_orbslam3_map_chaining(self, tmp_path):
        seq = self._seq(tmp_path)
        r = run_cli(
            "run_multi_session_orb_slam_3.py",
            ["--orb_slam_vocabulary_file", "/v/voc.txt",
             "--orb_slam_configuration_file", "/c/stereo.yaml",
             "--sequence_file", str(seq),
             "--orb_slam_3_out_root_dir", str(tmp_path / "out"),
             "--dry_run"],
        )
        lines = [l for l in r.stdout.splitlines() if "session" in l]
        # Session 0 writes map.bin; session 1 receives it as {map_in}.
        map0 = str(tmp_path / "out" / "0_bagA" / "map.bin")
        assert lines[0].rstrip().endswith(map0)
        assert map0 in lines[1]
        assert str(tmp_path / "out" / "1_bagB" / "map.bin") in lines[1]

    def test_skip_and_force_rerun(self, tmp_path):
        from cli.run_comparison_system import FINAL_TRAJECTORY_BASENAME

        seq = self._seq(tmp_path, names=("bagA",))
        out = tmp_path / "out"
        sdir = out / "0_bagA"
        sdir.mkdir(parents=True)
        (sdir / FINAL_TRAJECTORY_BASENAME).write_text("node_id\n")
        (sdir / "extra.txt").write_text("x\n")
        base = ["--sequence_file", str(seq),
                "--lego_loam_out_root_dir", str(out),
                "--dry_run"]
        r = run_cli("run_lego_loam.py", base)
        assert "skipping bagA" in r.stdout
        r = run_cli("run_lego_loam.py", base + ["--force_rerun"])
        assert "skipping" not in r.stdout
        assert "lego_loam_runner" in r.stdout

    def test_real_subprocess_execution(self, tmp_path):
        """Non-dry run with a stand-in 'binary' (touch) actually executes
        per session and creates the session dirs."""
        seq = self._seq(tmp_path)
        out = tmp_path / "out"
        r = run_cli(
            "run_comparison_system.py",
            ["--system_name", "fake",
             "--sequence_file", str(seq),
             "--results_root_dir", str(out),
             "--command_template", "touch {output_dir}/ran_{name}"],
        )
        assert (out / "0_bagA" / "ran_bagA").exists()
        assert (out / "1_bagB" / "ran_bagB").exists()
