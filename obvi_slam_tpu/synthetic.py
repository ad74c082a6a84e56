"""Seeded synthetic inputs.

``synthetic_problem`` builds a joint object-visual BA problem as
capacity-padded factor tables directly (no pose-graph pass), so problem size
is fully parameterizable; its generation math is vectorized numpy.
``make_object_session`` builds a whole object session (camera, feature
tracks, detections, noisy initial trajectory) for the runner and the main
CLI, and ``export_session`` writes it in the reference's input file formats.
Shared by __graft_entry__, bench.py, chip_smoke.py, the tools and the tests."""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from obvi_slam_tpu import geometry as geo
from obvi_slam_tpu import solver as slv
from obvi_slam_tpu import types as T
from obvi_slam_tpu.offline_data import OfflineProblemData, RawBoundingBox
from obvi_slam_tpu.pose_graph import CameraInfo


def _np_rotvec_to_matrix(w):
    """Batched numpy Rodrigues (mirror of geometry.exp_so3)."""
    w = np.atleast_2d(w)
    theta = np.linalg.norm(w, axis=-1)
    small = theta < 1e-12
    theta_safe = np.where(small, 1.0, theta)
    a = np.where(small, 1.0, np.sin(theta_safe) / theta_safe)
    b = np.where(small, 0.5, (1.0 - np.cos(theta_safe)) / theta_safe**2)
    zeros = np.zeros_like(w[:, 0])
    s = np.stack(
        [
            np.stack([zeros, -w[:, 2], w[:, 1]], -1),
            np.stack([w[:, 2], zeros, -w[:, 0]], -1),
            np.stack([-w[:, 1], w[:, 0], zeros], -1),
        ],
        axis=-2,
    )
    return np.eye(3) + a[:, None, None] * s + b[:, None, None] * (s @ s)


def _np_project(poses, points):
    """Rectified projection of points (N,3) from poses (N,6): returns
    (proj (N,2), depth (N,))."""
    r = _np_rotvec_to_matrix(poses[:, 3:6])
    p_cam = np.einsum("nji,nj->ni", r, points - poses[:, :3])  # R^T (p - t)
    return p_cam[:, :2] / p_cam[:, 2:3], p_cam[:, 2]


def _np_ellipsoid_corners(ellipsoids, poses):
    """Batched numpy dual-quadric corners (mirror of
    geometry.ellipsoid_corners_rectified, identity camera). Returns
    (corners (N,4), valid (N,))."""
    n = len(poses)
    r_wr = _np_rotvec_to_matrix(poses[:, 3:6])
    r_wc = np.swapaxes(r_wr, -1, -2)  # world->cam (identity extrinsics)
    t_wc = -np.einsum("nij,nj->ni", r_wc, poses[:, :3])
    yaw = ellipsoids[:, 3]
    c, s = np.cos(yaw), np.sin(yaw)
    r_e = np.zeros((n, 3, 3))
    r_e[:, 0, 0] = c
    r_e[:, 0, 1] = -s
    r_e[:, 1, 0] = s
    r_e[:, 1, 1] = c
    r_e[:, 2, 2] = 1.0
    r_ce = r_wc @ r_e
    t_ce = np.einsum("nij,nj->ni", r_wc, ellipsoids[:, :3]) + t_wc
    e_mat = np.concatenate([r_ce, t_ce[:, :, None]], axis=-1)  # (N,3,4)
    d = np.concatenate(
        [(ellipsoids[:, 4:7] * 0.5) ** 2 + 1e-3, -np.ones((n, 1))], axis=-1
    )
    q = np.einsum("nik,nk,njk->nij", e_mat, d, e_mat)
    q11, q13 = q[:, 0, 0], q[:, 0, 2]
    q22, q23 = q[:, 1, 1], q[:, 1, 2]
    q33 = q[:, 2, 2]
    x_inner = q13 * q13 - q11 * q33
    y_inner = q23 * q23 - q22 * q33
    valid = (x_inner > 0) & (y_inner > 0)
    sx = np.sqrt(np.maximum(x_inner, 1e-12))
    sy = np.sqrt(np.maximum(y_inner, 1e-12))
    corners = np.stack([q13 + sx, q13 - sx, q23 + sy, q23 - sy], axis=-1)
    return corners / np.where(np.abs(q33) < 1e-12, 1e-12, q33)[:, None], valid


def synthetic_problem(
    n_poses=64,
    n_points=512,
    n_objects=8,
    obs_per_point=6,
    obs_per_object=12,
    noise_px=0.5,
    pose_noise=0.03,
    point_noise=0.1,
    seed=0,
    dtype=np.float64,
):
    """Returns (state0, state_gt, cams, tables, plan, free, weights, huber)."""
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0

    gt_poses = np.zeros((n_poses, 6))
    gt_poses[:, 0] = np.arange(n_poses) * 0.3
    gt_poses[:, 4] = 0.05 * np.sin(np.arange(n_poses) * 0.3)
    gt_points = np.stack(
        [
            gt_poses[rng.integers(0, n_poses, n_points), 0]
            + rng.uniform(-4, 4, n_points),
            rng.uniform(-3, 3, n_points),
            rng.uniform(4, 20, n_points),
        ],
        axis=1,
    )
    gt_objects = np.concatenate(
        [
            gt_poses[rng.integers(0, n_poses, n_objects), 0:1]
            + rng.uniform(-3, 3, (n_objects, 1)),
            rng.uniform(-1, 1, (n_objects, 1)),
            rng.uniform(6, 12, (n_objects, 1)),
            rng.uniform(-0.5, 0.5, (n_objects, 1)),
            1.0 + rng.uniform(0, 1, (n_objects, 3)),
        ],
        axis=1,
    )
    cams = T.make_camera_bundle(
        np.eye(3)[None], np.zeros((1, 3)), [fx], [fy], [cx], [cy], dtype=dtype
    )

    # Reprojection factors: each point observed from obs_per_point candidate
    # poses trailing it in x (vectorized candidate generation + validity mask).
    cand = np.argsort(
        np.abs(gt_poses[None, :, 0] - gt_points[:, None, 0] + 4.0), axis=1
    )[:, : obs_per_point * 2]  # (M, C)
    flat_pose = cand.ravel()
    flat_point = np.repeat(np.arange(n_points), cand.shape[1])
    proj, depth = _np_project(gt_poses[flat_pose], gt_points[flat_point])
    ok = depth > 1.0
    # Keep at most obs_per_point valid observations per point.
    order = np.lexsort((np.arange(len(flat_point)), ~ok, flat_point))
    keep_rows = []
    count = {}
    for row in order:
        if not ok[row]:
            continue
        j = flat_point[row]
        c = count.get(j, 0)
        if c < obs_per_point:
            keep_rows.append(row)
            count[j] = c + 1
    keep_rows = np.array(keep_rows, dtype=np.int64)
    pose_idx = flat_pose[keep_rows]
    pt_idx = flat_point[keep_rows]
    obs = proj[keep_rows] + rng.normal(size=(len(keep_rows), 2)) * noise_px / fx
    mult = np.full((len(keep_rows), 2), fx / 2.0)
    reproj = T.make_reprojection_factors(
        pose_idx, pt_idx, np.zeros(len(keep_rows), np.int64), obs, mult, dtype=dtype
    )

    # Relpose odometry chain (vectorized relative poses).
    r_all = _np_rotvec_to_matrix(gt_poses[:, 3:6])
    rel_r = np.swapaxes(r_all[:-1], -1, -2) @ r_all[1:]
    rel_t = np.einsum(
        "nji,nj->ni", r_all[:-1], gt_poses[1:, :3] - gt_poses[:-1, :3]
    )
    si6 = np.broadcast_to(np.diag([50.0] * 3 + [100.0] * 3), (n_poses - 1, 6, 6))
    relpose = T.make_relative_pose_factors(
        np.arange(n_poses - 1),
        np.arange(1, n_poses),
        rel_t,
        rel_r,
        si6,
        dtype=dtype,
    )

    # Object observations + shape priors.
    cand_o = np.argsort(
        np.abs(gt_poses[None, :, 0] - gt_objects[:, None, 0] + 5.0), axis=1
    )[:, : obs_per_object * 2]
    flat_o_pose = cand_o.ravel()
    flat_o_obj = np.repeat(np.arange(n_objects), cand_o.shape[1])
    corners, valid = _np_ellipsoid_corners(
        gt_objects[flat_o_obj], gt_poses[flat_o_pose]
    )
    keep_o = []
    count_o = {}
    for row in range(len(flat_o_obj)):
        if not valid[row]:
            continue
        k = flat_o_obj[row]
        c = count_o.get(k, 0)
        if c < obs_per_object:
            keep_o.append(row)
            count_o[k] = c + 1
    keep_o = np.array(keep_o, dtype=np.int64)
    s_inf = np.diag([1 / 30.0] * 4) @ np.diag([fx, fx, fy, fy])
    bbox = T.make_bounding_box_factors(
        flat_o_obj[keep_o],
        flat_o_pose[keep_o],
        np.zeros(len(keep_o), np.int64),
        corners[keep_o] + rng.normal(size=(len(keep_o), 4)) * 2.0 / fx,
        np.broadcast_to(s_inf, (len(keep_o), 4, 4)),
        dtype=dtype,
    )
    shape = T.make_shape_prior_factors(
        np.arange(n_objects),
        gt_objects[:, 4:7] + rng.normal(size=(n_objects, 3)) * 0.1,
        np.broadcast_to(np.diag([2.0] * 3), (n_objects, 3, 3)),
        dtype=dtype,
    )

    tables = T.FactorTables(
        reproj=reproj,
        bbox=bbox,
        shape=shape,
        relpose=relpose,
        ltm=T.empty_ltm_prior_factors(dtype=dtype),
        param_prior=T.empty_param_prior_factors(dtype=dtype),
    )
    plan = slv.build_schur_plan_host(
        pose_idx,
        pt_idx,
        reproj.capacity,
        flat_o_pose[keep_o],
        flat_o_obj[keep_o],
        bbox.capacity,
        n_pose=n_poses,
        rl_before=np.arange(n_poses - 1),
        rl_after=np.arange(1, n_poses),
        rl_cap=relpose.capacity,
    )

    state_gt = T.BAState(
        poses=jnp.asarray(gt_poses.astype(dtype)),
        points=jnp.asarray(gt_points.astype(dtype)),
        objects=jnp.asarray(gt_objects.astype(dtype)),
    )
    poses0 = gt_poses.copy()
    poses0[1:] += rng.normal(size=(n_poses - 1, 6)) * pose_noise
    state0 = T.BAState(
        poses=jnp.asarray(poses0.astype(dtype)),
        points=jnp.asarray(
            (gt_points + rng.normal(size=gt_points.shape) * point_noise).astype(dtype)
        ),
        objects=jnp.asarray(
            (gt_objects + rng.normal(size=gt_objects.shape) * 0.1).astype(dtype)
        ),
    )
    free = T.FreeMasks(
        poses=jnp.asarray(np.arange(n_poses) != 0),
        points=jnp.ones(n_points, dtype=bool),
        objects=jnp.ones(n_objects, dtype=bool),
    )
    weights = slv.ones_weights(tables, dtype=state0.poses.dtype)
    huber = slv.schur.HuberParams()
    return state0, state_gt, cams, tables, plan, free, weights, huber


# The reference-scale global-BA problem (UT-campus shape): 98,304
# reprojection rows and 768 bbox rows.
GLOBAL_BA_1024 = dict(n_poses=1024, n_points=16384, n_objects=64,
                      obs_per_point=6, obs_per_object=12)

# Relative error bound of an f32 step against the f64 step (pose delta): the
# damped normal equations amplify f32 rounding by the system's condition
# number.
F32_STEP_REL_ERR = 5e-3


def put_problem(problem, device):
    """Place a synthetic_problem tuple on ``device`` (huber stays static)."""
    return jax.device_put(problem[:-1], device) + (problem[-1],)


def step_pose_delta(problem, device=None, shard_mesh=None):
    """One jitted ``compute_step`` from the problem's initial state at a
    wide trust region: (pose delta, model cost change), on the device.
    ``device`` places the problem first; a sharded problem passes None."""
    state0, _, cams, tables, plan, free, weights, huber = problem
    radius = jnp.asarray(1e4, state0.poses.dtype)
    args = (state0, cams, tables, plan, free, weights, radius)
    if device is not None:
        args = jax.device_put(args, device)
    delta, model_change, _ = jax.jit(
        lambda s, c, t, p, f, w, r: slv.schur.compute_step(
            s, c, t, p, f, w, r, huber, shard_mesh=shard_mesh)
    )(*args)
    return delta.poses, model_change


def rel_err(a, b):
    """||a - b|| / ||b|| in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def project_px(pose, point, cam: CameraInfo):
    rw = Rotation.from_rotvec(pose[3:]).as_matrix()
    p_robot = rw.T @ (point - pose[:3])
    p_cam = cam.extrinsics_r.T @ (p_robot - cam.extrinsics_t)
    if p_cam[2] <= 0.3:
        return None
    K = cam.intrinsics
    return np.array(
        [K[0, 0] * p_cam[0] / p_cam[2] + K[0, 2], K[1, 1] * p_cam[1] / p_cam[2] + K[1, 2]]
    )


def make_object_session(n_frames=14, seed=21):
    """Scene with 2 'chair' objects + surface features ON the objects (so the
    feature-overlap association signal works) + background features."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    cameras = {1: CameraInfo(K, np.eye(3), np.zeros(3))}

    gt_poses = np.zeros((n_frames, 6))
    gt_poses[:, 0] = np.arange(n_frames) * 0.2

    # chairs (class prior: mean [0.62, 0.62, 0.975])
    gt_objects = np.array(
        [
            [1.0, 0.5, 7.0, 0.0, 0.62, 0.62, 0.975],
            [-1.8, 0.4, 10.0, 0.0, 0.62, 0.62, 0.975],
        ]
    )

    # Features: 10 on each object surface + 20 background.
    feat_positions = {}
    fid = 0
    for k in range(2):
        for _ in range(10):
            offset = rng.uniform(-0.5, 0.5, 3) * gt_objects[k, 4:7]
            feat_positions[fid] = gt_objects[k, :3] + offset
            fid += 1
    for _ in range(20):
        feat_positions[fid] = np.array(
            [rng.uniform(-5, 5), rng.uniform(-2, 2), rng.uniform(4, 15)]
        )
        fid += 1

    feature_tracks = {}
    for j, pos in feat_positions.items():
        track = {}
        for i in range(n_frames):
            px = project_px(gt_poses[i], pos, cameras[1])
            if px is not None and 0 <= px[0] <= 640 and 0 <= px[1] <= 480:
                track[i] = {1: px + rng.normal(size=2) * 0.3}
        if len(track) >= 2:
            feature_tracks[j] = track

    # Bounding boxes: projected GT ellipsoid corners + noise.
    bounding_boxes = {}
    for i in range(n_frames):
        bbs = []
        for k in range(2):
            c, valid = geo.ellipsoid_corners_rectified(
                jnp.asarray(gt_objects[k]), jnp.asarray(gt_poses[i]), jnp.eye(3), jnp.zeros(3)
            )
            if not bool(valid):
                continue
            c = np.asarray(c)
            px = np.array(
                [
                    500.0 * c[0] + 320.0,
                    500.0 * c[1] + 320.0,
                    500.0 * c[2] + 240.0,
                    500.0 * c[3] + 240.0,
                ]
            ) + rng.normal(size=4) * 1.0
            if px[1] < 10 or px[0] > 630 or px[3] < 10 or px[2] > 470:
                continue
            bbs.append(RawBoundingBox(px, "chair", 0.9))
        if bbs:
            bounding_boxes[i] = {1: bbs}

    init_poses = {
        i: gt_poses[i] + np.concatenate([rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.004])
        for i in range(n_frames)
    }
    init_poses[0] = gt_poses[0].copy()
    feature_init = {j: feat_positions[j] + rng.normal(size=3) * 0.05 for j in feature_tracks}

    data = OfflineProblemData(
        cameras=cameras,
        feature_tracks=feature_tracks,
        feature_init_positions=feature_init,
        initial_poses=init_poses,
        bounding_boxes=bounding_boxes,
    )
    return data, gt_poses, gt_objects


def export_session(data, gt_poses, out_dir: Path, odom_as_init=True):
    """Write a session in the reference's input file formats."""
    out_dir.mkdir(parents=True, exist_ok=True)
    # Intrinsics / extrinsics CSVs.
    with open(out_dir / "intrinsics.csv", "w") as f:
        f.write("camera_id,img_width,img_height,mat_00,mat_01,mat_02,mat_10,mat_11,mat_12,mat_20,mat_21,mat_22\n")
        for cam_id, cam in data.cameras.items():
            k = cam.intrinsics.ravel()
            f.write(f"{cam_id},640,480," + ",".join(str(v) for v in k) + "\n")
    with open(out_dir / "extrinsics.csv", "w") as f:
        f.write("camera_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
        for cam_id, cam in data.cameras.items():
            q = Rotation.from_matrix(cam.extrinsics_r).as_quat()
            t = cam.extrinsics_t
            f.write(f"{cam_id},{t[0]},{t[1]},{t[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")
    # Initial trajectory.
    with open(out_dir / "poses.csv", "w") as f:
        f.write("node_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
        for frame, p in sorted(data.initial_poses.items()):
            q = Rotation.from_rotvec(p[3:6]).as_quat()
            f.write(f"{frame},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")
    # Ground truth trajectory (for metrics).
    with open(out_dir / "gt_poses.csv", "w") as f:
        f.write("node_id,transl_x,transl_y,transl_z,quat_x,quat_y,quat_z,quat_w\n")
        for frame in range(len(gt_poses)):
            p = gt_poses[frame]
            q = Rotation.from_rotvec(p[3:6]).as_quat()
            f.write(f"{frame},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")
    # Bounding boxes.
    with open(out_dir / "bounding_boxes.csv", "w") as f:
        f.write("min_pixel_x,min_pixel_y,max_pixel_x,max_pixel_y,semantic_class,node_id,camera_id,detection_confidence\n")
        for frame, by_cam in sorted(data.bounding_boxes.items()):
            for cam_id, bbs in by_cam.items():
                for bb in bbs:
                    c = bb.corners  # [x_min, x_max, y_min, y_max]
                    f.write(
                        f"{c[0]},{c[2]},{c[1]},{c[3]},{bb.semantic_class},{frame},{cam_id},{bb.detection_confidence}\n"
                    )
    # ORB output directory.
    orb = out_dir / "orb_out"
    (orb / "features").mkdir(parents=True, exist_ok=True)
    frames = sorted(data.initial_poses)
    for frame in frames:
        with open(orb / f"{frame:06d}.txt", "w") as f:
            f.write(f"{frame}\n")
            f.write("0 0 0 0 0 0 1\n")  # pose line (skipped by reader)
            feats = data.features_for_frame(frame)
            for feat_id in sorted(feats):
                parts = [str(feat_id)]
                for cam_id, px in sorted(feats[feat_id].items()):
                    parts += [str(cam_id), str(px[0]), str(px[1])]
                f.write(" ".join(parts) + "\n")
    with open(orb / "features" / "features.txt", "w") as f:
        f.write("feature_id,x,y,z\n")
        for feat_id, pos in sorted(data.feature_init_positions.items()):
            f.write(f"{feat_id},{pos[0]},{pos[1]},{pos[2]}\n")
    return out_dir
