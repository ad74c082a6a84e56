"""End-to-end runner tests: full per-frame loop (frontend gating, sliding
window, two-phase outlier rejection, global BA, final refinement) on a
synthetic stereo session, driven by the in-repo session config."""

import dataclasses

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from obvi_slam_tpu import config as cfg
from obvi_slam_tpu.frontend import VisualFeatureFrontend
from obvi_slam_tpu.offline_data import OfflineProblemData, RawBoundingBox
from obvi_slam_tpu.pose_graph import CameraInfo, PoseGraph
from obvi_slam_tpu.runner import OfflineProblemRunner, provide_optimization_window

def make_session(n_frames=12, n_features=40, noise_px=0.5, odom_noise=0.01, seed=9):
    """Synthetic stereo session: forward motion, random landmarks, exact
    feature tracks + noisy initial trajectory."""
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    baseline = 0.12
    cameras = {
        1: CameraInfo(K, np.eye(3), np.zeros(3)),
        2: CameraInfo(K, np.eye(3), np.array([baseline, 0.0, 0.0])),
    }

    gt_poses = np.zeros((n_frames, 6))
    gt_poses[:, 0] = np.arange(n_frames) * 0.25
    gt_poses[:, 4] = 0.02 * np.sin(np.arange(n_frames) * 0.7)

    gt_points = np.stack(
        [
            rng.uniform(-5, 5, n_features),
            rng.uniform(-2, 2, n_features),
            rng.uniform(4, 18, n_features),
        ],
        axis=1,
    )

    feature_tracks = {}
    for j in range(n_features):
        track = {}
        for i in range(n_frames):
            rw = Rotation.from_rotvec(gt_poses[i, 3:]).as_matrix()
            obs_cams = {}
            for cam_id, cam in cameras.items():
                p_robot = rw.T @ (gt_points[j] - gt_poses[i, :3])
                p_cam = cam.extrinsics_r.T @ (p_robot - cam.extrinsics_t)
                if p_cam[2] < 0.5:
                    continue
                px = np.array(
                    [
                        fx * p_cam[0] / p_cam[2] + cx,
                        fy * p_cam[1] / p_cam[2] + cy,
                    ]
                )
                px += rng.normal(size=2) * noise_px
                if -50 <= px[0] <= 690 and -50 <= px[1] <= 530:
                    obs_cams[cam_id] = px
            if obs_cams:
                track[i] = obs_cams
        if len(track) >= 2:
            feature_tracks[j] = track

    # Noisy initial trajectory by integrating noisy odometry.
    init_poses = {0: gt_poses[0].copy()}
    for i in range(1, n_frames):
        r_prev = Rotation.from_rotvec(gt_poses[i - 1, 3:]).as_matrix()
        r_curr = Rotation.from_rotvec(gt_poses[i, 3:]).as_matrix()
        rel_t = r_prev.T @ (gt_poses[i, :3] - gt_poses[i - 1, :3])
        rel_r = r_prev.T @ r_curr
        rel_t = rel_t + rng.normal(size=3) * odom_noise
        rel_w = Rotation.from_matrix(rel_r).as_rotvec() + rng.normal(size=3) * odom_noise * 0.5
        r_prev_init = Rotation.from_rotvec(init_poses[i - 1][3:]).as_matrix()
        new_t = r_prev_init @ rel_t + init_poses[i - 1][:3]
        new_r = r_prev_init @ Rotation.from_rotvec(rel_w).as_matrix()
        init_poses[i] = np.concatenate([new_t, Rotation.from_matrix(new_r).as_rotvec()])

    # Initial 3-D features: perturbed ground truth (stands in for ORB depth).
    feature_init = {
        j: gt_points[j] + rng.normal(size=3) * 0.1 for j in feature_tracks
    }

    data = OfflineProblemData(
        cameras=cameras,
        feature_tracks=feature_tracks,
        feature_init_positions=feature_init,
        initial_poses=init_poses,
    )
    return data, gt_poses, gt_points


def small_config():
    c = cfg.object_session_config(pgo=False)
    # Shrink for the synthetic session: window 6, global BA every 5 frames,
    # no PGO (tested separately), loose min-obs thresholds for the small scene.
    c.sliding_window_params.local_ba_window_size = 6
    c.sliding_window_params.global_ba_frequency = 5
    en = c.optimization_factors_enabled_params
    en.use_pose_graph_on_global_ba = False
    en.use_pose_graph_on_final_global_ba = False
    en.use_visual_features_on_global_ba = True
    en.use_visual_features_on_final_global_ba = True
    en.min_low_level_feature_observations_per_frame = 10
    en.min_low_level_feature_observations = 3
    en.poses_prior_to_window_to_keep_constant = 1
    for p in (
        c.local_ba_iteration_params,
        c.global_ba_iteration_params,
        c.final_ba_iteration_params,
    ):
        p.phase_one_opt_params.max_num_iterations = 20
        p.phase_two_opt_params.max_num_iterations = 30
    return c


def ate_rmse(pg, gt_poses):
    errs = []
    for i in range(len(gt_poses)):
        p = pg.get_robot_pose(i)
        if p is not None:
            errs.append(np.sum((p[:3] - gt_poses[i, :3]) ** 2))
    return np.sqrt(np.mean(errs))


class TestWindowPolicy:
    def test_matches_reference(self):
        sw = cfg.SlidingWindowParams(global_ba_frequency=30, local_ba_window_size=50)
        # (run_opt_utils.h:101-116)
        assert provide_optimization_window(100, 100, sw) == 0  # final
        assert provide_optimization_window(90, 100, sw) == 0  # gba multiple
        assert provide_optimization_window(40, 100, sw) == 0  # below window size
        assert provide_optimization_window(77, 100, sw) == 27  # sliding


class TestVisualOnlyEndToEnd:
    @pytest.fixture(scope="class")
    def session(self):
        return make_session()

    def test_full_run_reduces_ate(self, session):
        data, gt_poses, gt_points = session
        config = small_config()
        runner = OfflineProblemRunner(config)
        pg = PoseGraph(data.cameras)
        vf = VisualFeatureFrontend(
            gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
            reprojection_error_provider=lambda *a: config.visual_feature_params.reprojection_error_std_dev,
            min_parallax_pixel=config.visual_feature_params.min_visual_feature_parallax_pixel_requirement,
            inlier_epipolar_err_thresh=config.visual_feature_params.inlier_epipolar_err_thresh,
            check_past_n_frames=config.visual_feature_params.check_past_n_frames_for_epipolar_err,
        )
        # Initial ATE from noisy odometry integration.
        ate_init = np.sqrt(
            np.mean(
                [
                    np.sum((data.initial_poses[i][:3] - gt_poses[i, :3]) ** 2)
                    for i in range(len(gt_poses))
                ]
            )
        )
        ok = runner.run_optimization(data, pg, visual_frontend=vf)
        assert ok
        ate_final = ate_rmse(pg, gt_poses)
        # BA should beat raw odometry integration significantly.
        assert ate_final < ate_init * 0.5, (ate_init, ate_final)
        assert ate_final < 0.05, ate_final
        # All frames present.
        assert pg.max_frame_id() == data.max_frame_id()
        # Features were admitted via the parallax gate.
        assert len(pg.features) > 10
        # Solve log populated with both phases.
        phases = {r.phase for r in runner.opt_log}
        assert 1 in phases and 2 in phases

    def test_timers_populated(self, session):
        from obvi_slam_tpu.timing import TimerRegistry

        names = set(TimerRegistry.instance().timers)
        for expected in (
            "frame_data_adder",
            "local_bundle_adjustment",
            "global_bundle_adjustment",
            "phase_one_lba_solve_opt",
            "phase_two_gba_solve_opt",
        ):
            assert expected in names, (expected, names)


class TestShardedRunner:
    """Multi-chip wiring: a runner given an 8-device mesh shards every
    global-BA (and, when opted in, local-BA) solve across the factor axis and
    must produce the same trajectory as the single-device runner — the
    sharded program is the same numeric computation with XLA-inserted
    all-reduces (f64 on CPU, so equality is tight)."""

    def _run(self, data, mesh=None, shard_local_ba=False, use_fused_solver=None):
        config = small_config()
        runner = OfflineProblemRunner(
            config, mesh=mesh, shard_local_ba=shard_local_ba,
            use_fused_solver=use_fused_solver,
        )
        pg = PoseGraph(data.cameras)
        vf = VisualFeatureFrontend(
            gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
            reprojection_error_provider=lambda *a: config.visual_feature_params.reprojection_error_std_dev,
            min_parallax_pixel=config.visual_feature_params.min_visual_feature_parallax_pixel_requirement,
            inlier_epipolar_err_thresh=config.visual_feature_params.inlier_epipolar_err_thresh,
            check_past_n_frames=config.visual_feature_params.check_past_n_frames_for_epipolar_err,
        )
        assert runner.run_optimization(data, pg, visual_frontend=vf)
        return np.stack([pg.get_robot_pose(i) for i in range(data.max_frame_id() + 1)])

    def test_fused_solver_runner_converges(self):
        """The runner's fused-solver path (lax.while_loop LM, one dispatch
        per solve — the accelerator deployment default) must reach the same quality
        as the host-loop path on the same session."""
        data, gt_poses, _ = make_session(n_frames=8, n_features=30)
        config = small_config()
        runner = OfflineProblemRunner(config, use_fused_solver=True)
        pg = PoseGraph(data.cameras)
        vf = VisualFeatureFrontend(
            gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
            reprojection_error_provider=lambda *a: config.visual_feature_params.reprojection_error_std_dev,
            min_parallax_pixel=config.visual_feature_params.min_visual_feature_parallax_pixel_requirement,
            inlier_epipolar_err_thresh=config.visual_feature_params.inlier_epipolar_err_thresh,
            check_past_n_frames=config.visual_feature_params.check_past_n_frames_for_epipolar_err,
        )
        assert runner.run_optimization(data, pg, visual_frontend=vf)
        fused = np.stack(
            [pg.get_robot_pose(i) for i in range(data.max_frame_id() + 1)]
        )
        base = self._run(data)  # host-loop runner on the same session
        # Same Ceres semantics in both loops; tiny differences only from
        # f64 reduction-order variation across the two compiled programs.
        np.testing.assert_allclose(fused, base, rtol=1e-5, atol=1e-7)

    def test_sharded_global_ba_matches_single_device(self):
        import jax

        from obvi_slam_tpu import parallel as par

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        data, gt_poses, _ = make_session(n_frames=8, n_features=30)
        base = self._run(data)
        mesh = par.make_mesh(jax.devices()[:8])
        sharded = self._run(data, mesh=mesh, shard_local_ba=True)
        np.testing.assert_allclose(sharded, base, rtol=1e-7, atol=1e-9)

    def test_sharded_fused_matches_single_fused(self):
        """The FUSED trust-region loop (lm_fused.solve_fused — the code path
        GPU deployments actually run) executed on an 8-device mesh must match
        the single-device fused run: the while_loop body is the same numeric
        program with XLA-inserted psums over the factor axis."""
        import jax

        from obvi_slam_tpu import parallel as par

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        data, gt_poses, _ = make_session(n_frames=8, n_features=30)
        base = self._run(data, use_fused_solver=True)
        mesh = par.make_mesh(jax.devices()[:8])
        sharded = self._run(
            data, mesh=mesh, shard_local_ba=True, use_fused_solver=True
        )
        np.testing.assert_allclose(sharded, base, rtol=1e-6, atol=1e-8)


class TestCapsPresize:
    """The whole presize scheme (runner.presize_session_caps) rests on one
    invariant: capacity padding rows are masked everywhere, so a problem
    built at LARGER capacities is the same numeric computation. These tests
    pin that invariant at the trajectory level, plus the growth path when a
    session's later windows exceed the seed."""

    def _run(self, data, presize_mode):
        config = small_config()
        runner = OfflineProblemRunner(config)
        if presize_mode == "off":
            runner.presize_session_caps = lambda *a, **k: runner._caps_pools
        elif presize_mode == "tiny":
            # Deliberate under-seed: horizon 3 of a 12-frame session, so
            # nearly every later window EXCEEDS the seed and takes the pool
            # growth path (dense late-arriving tracks in production).
            def tiny(d, max_frame_id=None):
                runner._seed_pool("local", runner._window_caps_seed(d, 0, 3))
                runner._seed_pool("global", runner._window_caps_seed(d, 0, 3))
                return runner._caps_pools

            runner.presize_session_caps = tiny
        pg = PoseGraph(data.cameras)
        vf = VisualFeatureFrontend(
            gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
            reprojection_error_provider=lambda *a: config.visual_feature_params.reprojection_error_std_dev,
            min_parallax_pixel=config.visual_feature_params.min_visual_feature_parallax_pixel_requirement,
            inlier_epipolar_err_thresh=config.visual_feature_params.inlier_epipolar_err_thresh,
            check_past_n_frames=config.visual_feature_params.check_past_n_frames_for_epipolar_err,
        )
        assert runner.run_optimization(data, pg, visual_frontend=vf)
        est = np.stack(
            [pg.get_robot_pose(i) for i in range(data.max_frame_id() + 1)]
        )
        return est, runner

    # Bit-identity is impossible across capacities — XLA tiles reductions
    # differently per shape, reordering f64 sums — so "identical" means
    # agreement at accumulated-roundoff level (observed max 1e-15 abs /
    # 8e-14 rel on this fixture; the bound below is 1000x that).

    def test_presized_matches_unpresized(self, presize_sessions):
        est_presized, est_off, _ = presize_sessions
        np.testing.assert_allclose(
            est_presized, est_off, rtol=1e-10, atol=1e-12
        )

    def test_seed_exceeded_growth_path_matches(self, presize_sessions):
        est_presized, _, (est_tiny, runner_tiny) = presize_sessions
        # The tiny seed MUST have been exceeded (growth path exercised)...
        pool = runner_tiny.caps_pool("global")
        tiny_seed = runner_tiny._window_caps_seed(
            presize_sessions.data, 0, 3
        )
        grew = [k for k, v in tiny_seed.items() if pool.get(k, 0) > v]
        assert grew, "expected the session to outgrow the tiny seed"
        # ...and the trajectory must still match the fully presized run.
        np.testing.assert_allclose(
            est_tiny, est_presized, rtol=1e-10, atol=1e-12
        )

    @pytest.fixture(scope="class")
    def presize_sessions(self):
        data, gt_poses, _ = make_session()
        est_presized, _ = self._run(data, "normal")
        est_off, _ = self._run(data, "off")
        tiny = self._run(data, "tiny")

        class R(tuple):
            pass

        out = R((est_presized, est_off, tiny))
        out.data = data
        return out
