"""Regression tests on the REFERENCE's own bundled mini-datasets
(SURVEY.md §4.1: data/vslam_set*, CPU-runnable fixtures) — the same data the
reference's debug mains consume drives our pipeline end-to-end.

Fixture conventions (recovered by consistency analysis — the camera is not
shipped with the data): ROBOT poses with x-forward robotics frames; the
camera looks along +x (extrinsic R maps cam z->robot x, cam x->-y, cam y->-z).
The nominal intrinsics below give ~2px median reprojection consistency, which
is the fixture's own noise floor, so assertions are RELATIVE: BA from a
perturbed start must reach (at least) the ground-truth state's cost and
recover the trajectory.

Also validates f32 (device dtype) vs f64 solves on the same problem
(SURVEY hard part #5).
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import obvi_slam_tpu.factors as fac
import obvi_slam_tpu.solver as slv
from obvi_slam_tpu import types as T
from obvi_slam_tpu.io.readers import read_vslam_set

FIXTURE = "/root/reference/data/vslam_set1"
ALL_FIXTURES = [
    f"/root/reference/data/{name}"
    for name in (
        "vslam_set1", "vslam_set2", "vslam_set4", "vslam_set5",
        "vslam_set6", "vslam_set7", "vslam_superset1",
    )
]

FX = FY = 276.6
CX, CY = 601.5, 555.7
# Robotics x-forward camera: columns are camera axes in the robot frame.
R_EXT = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])


def triangulate(track, poses, k_inv):
    rows = []
    for frame, cams in track.items():
        if frame not in poses:
            continue
        px = cams[1]
        rw = Rotation.from_rotvec(poses[frame][3:]).as_matrix()
        t = poses[frame][:3]
        rc = R_EXT.T @ rw.T
        tc = -rc @ t
        p = np.hstack([rc, tc[:, None]])
        xn = k_inv @ np.array([px[0], px[1], 1.0])
        rows.append(xn[0] * p[2] - p[0])
        rows.append(xn[1] * p[2] - p[1])
    a = np.stack(rows)
    _, _, vt = np.linalg.svd(a)
    x = vt[-1]
    return x[:3] / x[3]


def load_fixture_problem(path):
    poses, tracks = read_vslam_set(path)
    assert len(poses) >= 5
    assert len(tracks) >= 5
    k_inv = np.linalg.inv(np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]]))
    frames = sorted(poses)
    frame_row = {f: i for i, f in enumerate(frames)}
    feat_ids = sorted(f for f, t in tracks.items() if len(t) >= 3)
    feat_row = {f: i for i, f in enumerate(feat_ids)}
    points0 = np.stack([triangulate(tracks[f], poses, k_inv) for f in feat_ids])

    pose_idx, pt_idx, obs, mult = [], [], [], []
    for f in feat_ids:
        for frame, cams in tracks[f].items():
            px = cams[1]
            pose_idx.append(frame_row[frame])
            pt_idx.append(feat_row[f])
            obs.append([(px[0] - CX) / FX, (px[1] - CY) / FY])
            mult.append([FX / 1.0, FY / 1.0])
    return poses, frames, frame_row, feat_ids, points0, (pose_idx, pt_idx, obs, mult)


@pytest.fixture(scope="module")
def fixture_problem():
    return load_fixture_problem(FIXTURE)


def build_state_tables(fixture_problem, pose_noise, dtype, seed=1):
    import jax.numpy as jnp

    poses, frames, frame_row, feat_ids, points0, (pose_idx, pt_idx, obs, mult) = (
        fixture_problem
    )
    rng = np.random.default_rng(seed)
    pose_arr = np.stack([poses[f] for f in frames])
    pose_init = pose_arr.copy()
    pose_init[1:] += rng.normal(size=pose_init[1:].shape) * pose_noise

    cams = T.make_camera_bundle(
        R_EXT[None], np.zeros((1, 3)), [FX], [FY], [CX], [CY], dtype=dtype
    )
    reproj = T.make_reprojection_factors(
        pose_idx, pt_idx, [0] * len(obs), obs, mult, dtype=dtype
    )
    before, after, mt, mr, si = [], [], [], [], []
    for i in range(len(frames) - 1):
        ra = Rotation.from_rotvec(pose_arr[i][3:]).as_matrix()
        rb = Rotation.from_rotvec(pose_arr[i + 1][3:]).as_matrix()
        before.append(i)
        after.append(i + 1)
        mt.append(ra.T @ (pose_arr[i + 1][:3] - pose_arr[i][:3]))
        mr.append(ra.T @ rb)
        si.append(np.diag([100.0] * 3 + [200.0] * 3))
    relpose = T.make_relative_pose_factors(before, after, mt, mr, si, dtype=dtype)
    tables = T.empty_factor_tables(dtype=dtype)._replace(reproj=reproj, relpose=relpose)
    state0 = T.BAState(
        poses=jnp.asarray(pose_init.astype(dtype)),
        points=jnp.asarray(points0.astype(dtype)),
        objects=jnp.zeros((1, 7), dtype=dtype),
    )
    state_gt = T.BAState(
        poses=jnp.asarray(pose_arr.astype(dtype)),
        points=jnp.asarray(points0.astype(dtype)),
        objects=jnp.zeros((1, 7), dtype=dtype),
    )
    free = T.FreeMasks(
        poses=jnp.asarray(np.arange(len(frames)) != 0),
        points=jnp.ones(len(feat_ids), dtype=bool),
        objects=jnp.zeros(1, dtype=bool),
    )
    return state0, state_gt, cams, tables, free, pose_arr


class TestVslamSet1:
    def test_ba_converges_on_reference_fixture(self, fixture_problem):
        state0, state_gt, cams, tables, free, gt = build_state_tables(
            fixture_problem, pose_noise=0.02, dtype=np.float64
        )
        plan = slv.build_schur_plan(tables)
        gt_cost = float(fac.total_cost(state_gt, cams, tables))
        state, summary = slv.solve(
            state0, cams, tables, plan, free, params=slv.LMParams(max_num_iterations=60)
        )
        # BA must do at least as well as the ground-truth state on this noisy
        # fixture (the optimum absorbs fixture noise).
        assert summary.final_cost <= gt_cost * 1.01, (summary.final_cost, gt_cost)
        ate = np.sqrt(
            np.mean(np.sum((np.asarray(state.poses)[:, :3] - gt[:, :3]) ** 2, axis=1))
        )
        assert ate < 0.05, ate

    def test_f32_matches_f64_solution(self, fixture_problem):
        """SURVEY hard part #5: the device dtype (f32) must reach the same
        solution as the f64 reference-parity solve."""
        s64, g64, cams64, t64, free, gt = build_state_tables(
            fixture_problem, pose_noise=0.02, dtype=np.float64
        )
        plan64 = slv.build_schur_plan(t64)
        out64, sum64 = slv.solve(
            s64, cams64, t64, plan64, free, params=slv.LMParams(max_num_iterations=60)
        )
        s32, g32, cams32, t32, free32, _ = build_state_tables(
            fixture_problem, pose_noise=0.02, dtype=np.float32
        )
        plan32 = slv.build_schur_plan(t32)
        out32, sum32 = slv.solve(
            s32, cams32, t32, plan32, free32, params=slv.LMParams(max_num_iterations=60)
        )
        pose_diff = np.abs(
            np.asarray(out32.poses, dtype=np.float64) - np.asarray(out64.poses)
        ).max()
        assert pose_diff < 2e-3, pose_diff  # mm-level trajectory agreement
        assert sum32.final_cost < sum64.final_cost * 1.1 + 1e-6


class TestVslamSetOtherSets:
    """Sets 2-6 ship no calibration, so their pixel-noise floor under the
    set1-recovered camera varies (8-80 px median); the gauge- and
    calibration-free regression property is COST DOMINANCE: BA from a
    perturbed start must reach at least the ground-truth state's cost."""

    OTHER_SETS = ["vslam_set2", "vslam_set4", "vslam_set5", "vslam_set6"]

    @pytest.mark.parametrize("set_name", OTHER_SETS)
    def test_loads_and_is_consistent(self, set_name):
        poses, tracks = read_vslam_set(f"/root/reference/data/{set_name}")
        assert len(poses) >= 3
        assert len(tracks) >= 3
        for f, t in tracks.items():
            for fr in t:
                assert fr in poses

    @pytest.mark.parametrize("set_name", ["vslam_set2", "vslam_set4"])
    def test_ba_reaches_gt_cost(self, set_name):
        problem = load_fixture_problem(f"/root/reference/data/{set_name}")
        state0, state_gt, cams, tables, free, gt = build_state_tables(
            problem, pose_noise=0.02, dtype=np.float64
        )
        plan = slv.build_schur_plan(tables)
        gt_cost = float(fac.total_cost(state_gt, cams, tables))
        state, summary = slv.solve(
            state0, cams, tables, plan, free,
            params=slv.LMParams(max_num_iterations=60),
        )
        assert summary.final_cost <= gt_cost * 1.01, (summary.final_cost, gt_cost)


def load_calibrated_fixture(directory, min_track_len=2):
    """vslam_set7 / vslam_superset1 config dirs: shipped calibration +
    ground-truth 3-D landmarks (features/features.txt) — no convention
    recovery or triangulation needed."""
    import jax.numpy as jnp

    from obvi_slam_tpu.io.readers import (
        read_vslam_set_calibration,
        read_vslam_set_features,
    )

    fx, fy, cx, cy = read_vslam_set_calibration(directory)
    landmarks = read_vslam_set_features(directory)
    poses, tracks = read_vslam_set(directory)
    frames = sorted(poses)
    frame_row = {f: i for i, f in enumerate(frames)}
    feat_ids = sorted(
        f for f, t in tracks.items() if len(t) >= min_track_len and f in landmarks
    )
    feat_row = {f: i for i, f in enumerate(feat_ids)}
    pose_idx, pt_idx, obs, mult = [], [], [], []
    for f in feat_ids:
        for frame, cams_ in tracks[f].items():
            px = cams_[1]
            pose_idx.append(frame_row[frame])
            pt_idx.append(feat_row[f])
            obs.append([(px[0] - cx) / fx, (px[1] - cy) / fy])
            mult.append([fx, fy])
    pose_arr = np.stack([poses[f] for f in frames])
    points = np.stack([landmarks[f] for f in feat_ids])
    cams = T.make_camera_bundle(
        R_EXT[None], np.zeros((1, 3)), [fx], [fy], [cx], [cy], dtype=np.float64
    )
    reproj = T.make_reprojection_factors(
        pose_idx, pt_idx, [0] * len(obs), obs, mult, dtype=np.float64
    )
    # Odometry chain from GT deltas (the real pipeline always has odometry;
    # without it the monocular problem's SCALE gauge is free and noisy
    # configs drift arbitrarily along it).
    before, after, mt, mr, si = [], [], [], [], []
    for i in range(len(frames) - 1):
        ra = Rotation.from_rotvec(pose_arr[i][3:]).as_matrix()
        rb = Rotation.from_rotvec(pose_arr[i + 1][3:]).as_matrix()
        before.append(i)
        after.append(i + 1)
        mt.append(ra.T @ (pose_arr[i + 1][:3] - pose_arr[i][:3]))
        mr.append(ra.T @ rb)
        si.append(np.diag([20.0] * 3 + [40.0] * 3))
    relpose = T.make_relative_pose_factors(before, after, mt, mr, si, dtype=np.float64)
    tables = T.empty_factor_tables(dtype=np.float64)._replace(
        reproj=reproj, relpose=relpose
    )
    return pose_arr, points, cams, tables, frames, feat_ids


class TestCalibratedFixtures:
    """vslam_set7 and vslam_superset1 ship calibration (fx=fy=400,
    cx=320, cy=240) and ground-truth landmarks; the shipped groundtruth
    observations are exact projections, so BA must recover the exact state,
    and the README-specified noise tiers bound the error on noisy configs."""

    def test_set7_gt_state_is_consistent(self):
        pose_arr, points, cams, tables, frames, feat_ids = load_calibrated_fixture(
            "/root/reference/data/vslam_set7"
        )
        import jax.numpy as jnp

        state_gt = T.BAState(
            poses=jnp.asarray(pose_arr),
            points=jnp.asarray(points),
            objects=jnp.zeros((1, 7)),
        )
        res = fac.all_residuals(state_gt, cams, tables, 1e6)
        n_live = int(np.asarray(tables.reproj.mask).sum())
        norms = np.linalg.norm(np.asarray(res["reproj"])[:n_live], axis=1)
        # set7 is simulated with noise sigma ~1px; median must be small.
        assert np.median(norms) < 3.0, np.median(norms)

    @pytest.mark.parametrize(
        "config,ate_bound",
        [
            # exact projections -> exact recovery
            ("low_density/groundtruth", 1e-4),
            # README noise tiers corrupt each landmark independently PER
            # FRAME (sigma in meters), making observations of the same
            # landmark mutually inconsistent by ~1-2 px (low) / ~5 px
            # (high); the 41-frame monocular+odometry chain then has a
            # data-noise ATE floor of ~0.23 m / ~0.6 m (measured).
            ("low_density/low_noise", 0.35),
            # high_noise (sigma 0.15 m) needs the full pipeline's two-phase
            # outlier rejection to beat odometry (raw-solver floor ~1.2 m);
            # that path is regression-tested on real noisy data in
            # test_tum_fixture.py instead.
        ],
    )
    def test_superset1_ba_recovers_trajectory(self, config, ate_bound):
        import jax.numpy as jnp

        directory = f"/root/reference/data/vslam_superset1/{config}"
        pose_arr, points, cams, tables, frames, feat_ids = load_calibrated_fixture(
            directory
        )
        rng = np.random.default_rng(3)
        pose_init = pose_arr.copy()
        pose_init[1:, :3] += rng.normal(size=pose_init[1:, :3].shape) * 0.3
        pose_init[1:, 3:] += rng.normal(size=pose_init[1:, 3:].shape) * 0.02
        state0 = T.BAState(
            poses=jnp.asarray(pose_init),
            points=jnp.asarray(points + rng.normal(size=points.shape) * 0.1),
            objects=jnp.zeros((1, 7)),
        )
        ate_init = np.sqrt(
            np.mean(np.sum((pose_init[:, :3] - pose_arr[:, :3]) ** 2, axis=1))
        )
        free = T.FreeMasks(
            poses=jnp.asarray(np.arange(len(frames)) != 0),
            points=jnp.ones(len(feat_ids), dtype=bool),
            objects=jnp.zeros(1, dtype=bool),
        )
        plan = slv.build_schur_plan(tables)
        state, summary = slv.solve(
            state0, cams, tables, plan, free,
            params=slv.LMParams(max_num_iterations=80),
        )
        est = np.asarray(state.poses)
        ate = np.sqrt(np.mean(np.sum((est[:, :3] - pose_arr[:, :3]) ** 2, axis=1)))
        assert ate < ate_bound, (config, ate)
        assert ate < ate_init * 0.8, (config, ate, ate_init)
