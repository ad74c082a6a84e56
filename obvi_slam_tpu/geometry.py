"""Batched SO(3)/SE(3) and dual-quadric ellipsoid geometry.

JAX re-design of the reference's Eigen template math
(``include/refactoring/types/vslam_math_util.h``,
``include/refactoring/types/ellipsoid_utils.h``,
``include/refactoring/types/vslam_types_math_util.h``).

Conventions (identical to the reference):
  - A raw pose is a 6-vector ``[tx, ty, tz, wx, wy, wz]`` — translation then
    axis-angle rotation with angle = |w| (vslam_basic_types_refactor.h:43).
  - A raw ellipsoid is a 7-vector ``[x, y, z, yaw, dx, dy, dz]`` — the default
    CONSTRAIN_ELLIPSOID_ORIENTATION build (yaw-only orientation,
    vslam_obj_opt_types_refactor.h:15-36, CMakeLists.txt:8-15).
  - Rectified coordinates: pixels pre-transformed by ``(p - c) / f`` so the
    projection kernels are intrinsics-free (reprojection_cost_functor.cpp).

All functions broadcast over arbitrary leading batch dimensions and are
NaN-safe under ``jax.grad`` at the small-angle singularities (the reference
uses real branches at kSmallAngleThreshold=1e-8; here ``jnp.where`` guards with
Taylor expansions so XLA can fuse everything into straight-line vector code).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Matches kSmallAngleThreshold (vslam_math_util.h:17). Used as a *squared*
# angle guard here since we branch on theta^2 to keep gradients exact.
SMALL_ANGLE = 1e-8
# Matches kDimensionRegularizationConstant (ellipsoid_utils.h:22).
DIM_REGULARIZATION = 1e-3


def _sq_norm(v, axis=-1):
    return jnp.sum(v * v, axis=axis)


def skew(w):
    """Skew-symmetric matrix of a 3-vector; batched. (vslam_math_util.h:217)."""
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -w[..., 2], w[..., 1]], axis=-1),
            jnp.stack([w[..., 2], zeros, -w[..., 0]], axis=-1),
            jnp.stack([-w[..., 1], w[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(w):
    """so(3) -> SO(3) via Rodrigues, batched & grad-safe.

    Matches ``Exp`` (vslam_math_util.h:292) with a Taylor series replacing the
    hard small-angle branch (agrees to machine precision for tiny angles).
    """
    theta2 = _sq_norm(w)
    small = theta2 < SMALL_ANGLE**2
    # Safe theta for the large branch (value irrelevant when small is taken).
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    s = skew(w)
    s2 = bmm(s, s)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), s.shape)
    return eye + a[..., None, None] * s + b[..., None, None] * s2


def right_jacobian_so3(w):
    """SO(3) right Jacobian Jr(w) (GetRodriguesJacobian, vslam_math_util.h:311):
    Jr = I - (1-cos t)/t^2 [w]x + (t - sin t)/t^3 [w]x^2, Taylor-safe."""
    theta2 = _sq_norm(w)
    small = theta2 < SMALL_ANGLE**2
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    b = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2_safe * theta)
    )
    s = skew(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), s.shape)
    return eye - a[..., None, None] * s + b[..., None, None] * bmm(s, s)


def log_so3(r):
    """SO(3) -> so(3), batched & grad-safe, via quaternion.

    The reference warns against its own trace-based ``Log``
    (vslam_math_util.h:249 comment) and recommends the Eigen
    AngleAxis-from-rotation path, which goes through a quaternion — that is
    what this implements.
    """
    q = quat_from_matrix(r)  # [w, x, y, z], w >= 0
    return 2.0 * _quat_vec_log(q)


def _quat_vec_log(q):
    """log of a unit quaternion with non-negative scalar part -> axis*angle/2."""
    w = q[..., 0]
    v = q[..., 1:]
    vn2 = _sq_norm(v)
    small = vn2 < SMALL_ANGLE**2
    vn2_safe = jnp.where(small, jnp.ones_like(vn2), vn2)
    vn = jnp.sqrt(vn2_safe)
    # atan2(|v|, w)/|v| with Taylor fallback atan(x)/x ~ 1 - x^2/3 for x=|v|/w.
    half_angle_over_vn = jnp.where(
        small,
        (1.0 - vn2 / (3.0 * jnp.maximum(w, 0.5) ** 2)) / jnp.maximum(w, 0.5),
        jnp.arctan2(vn, w) / vn,
    )
    return v * half_angle_over_vn[..., None]


def quat_from_matrix(r):
    """Rotation matrix -> unit quaternion [w,x,y,z] with w >= 0; batched.

    Branch-free blend of the four Shepperd cases (each case is computed and the
    numerically best one selected with where — jit/vmap friendly).
    """
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate 4*q*q_k vectors (unnormalized), one per pivot.
    def cand(t, a, b, c):
        return jnp.stack([t, a, b, c], axis=-1)

    qw = cand(1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    qx = cand(m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    qy = cand(m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21)
    qz = cand(m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11)

    # Pivot magnitudes (= 4*q_k^2).
    pw = 1.0 + tr
    px = 1.0 + m00 - m11 - m22
    py = 1.0 + m11 - m00 - m22
    pz = 1.0 + m22 - m00 - m11
    pivots = jnp.stack([pw, px, py, pz], axis=-1)
    best = jnp.argmax(pivots, axis=-1)

    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4, 4]
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32), axis=-2)[
        ..., 0, :
    ]
    norm2 = jnp.maximum(_sq_norm(q), 1e-30)
    q = q / jnp.sqrt(norm2)[..., None]
    # Canonicalize sign: scalar part non-negative.
    return q * jnp.where(q[..., 0] < 0, -1.0, 1.0)[..., None]


# ---------------------------------------------------------------------------
# Raw-pose (6-vector) helpers.
# ---------------------------------------------------------------------------


def pose_to_rt(pose):
    """6-vec pose -> (R, t): world-from-body rotation and translation.

    Matches ``PoseArrayToAffine`` (vslam_math_util.h:122).
    """
    return exp_so3(pose[..., 3:6]), pose[..., 0:3]


def pose_from_rt(r, t):
    """(R, t) -> 6-vec pose."""
    return jnp.concatenate([t, log_so3(r)], axis=-1)



def bmv(m, v):
    """Batched matrix @ vector as broadcast-multiply-reduce.

    Tiny-contraction einsums/dots (k = 2..7) lower to batched matrix
    products, which a GPU may run in TF32 at DEFAULT precision. Spelled
    elementwise they stay exact f32 and fuse into the surrounding
    elementwise code."""
    return (m * v[..., None, :]).sum(-1)


def bmm(a, b):
    """Batched (…, i, k) @ (…, k, j) as broadcast-multiply-reduce."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def pose_inverse_rt(pose):
    """6-vec pose -> (R, t) of the INVERSE transform (T^-1 = [R^T | -R^T t]).

    Matches ``InversePoseArrayToAffine`` (vslam_math_util.h:144).
    """
    r, t = pose_to_rt(pose)
    r_inv = jnp.swapaxes(r, -1, -2)
    t_inv = -bmv(r_inv, t)
    return r_inv, t_inv


def transform_point(r, t, p):
    """Apply rigid transform (R, t) to points p; batched."""
    return bmv(r, p) + t


def compose_rt(r1, t1, r2, t2):
    """(R1,t1) ∘ (R2,t2): apply 2 first, then 1."""
    return bmm(r1, r2), transform_point(r1, t1, t2)


def pose_compose(pose1, pose2):
    """combinePoses (vslam_types_math_util.h): pose of frame2 given pose of
    frame1 (world) and pose2 relative to frame1; 6-vec in/out."""
    r1, t1 = pose_to_rt(pose1)
    r2, t2 = pose_to_rt(pose2)
    r, t = compose_rt(r1, t1, r2, t2)
    return pose_from_rt(r, t)


def pose_between(pose1, pose2):
    """getPose2RelativeToPose1 (vslam_types_math_util.h): T1^-1 * T2."""
    r1i, t1i = pose_inverse_rt(pose1)
    r2, t2 = pose_to_rt(pose2)
    r, t = compose_rt(r1i, t1i, r2, t2)
    return pose_from_rt(r, t)


def pose_inverse(pose):
    r, t = pose_inverse_rt(pose)
    return pose_from_rt(r, t)


# ---------------------------------------------------------------------------
# Projection kernels (rectified coordinates).
# ---------------------------------------------------------------------------


def project_point_rectified(pose, point, cam_from_robot_r, cam_from_robot_t):
    """Project a world point to rectified pixel coords (x/z, y/z).

    Matches ``getProjectedPixelLocationRectified`` (vslam_math_util.h:348):
    p_cam = T_cam_robot * T_robot_world(pose)^-1 * p_world; returns p_xy/p_z.

    ``cam_from_robot_*`` is the robot pose in the camera frame — the inverse of
    the extrinsics (extrinsics give camera-in-robot-frame).
    """
    r_wr_inv, t_wr_inv = pose_inverse_rt(pose)
    p_robot = transform_point(r_wr_inv, t_wr_inv, point)
    p_cam = transform_point(cam_from_robot_r, cam_from_robot_t, p_robot)
    return p_cam[..., 0:2] / p_cam[..., 2:3], p_cam[..., 2]


def ellipsoid_dual_diag(ellipsoid):
    """Diagonal of the origin-centered dual form D = diag((d/2)^2 + eps, -1).

    (ellipsoid_utils.h:208-216)."""
    dims = ellipsoid[..., 4:7]
    d = (dims * 0.5) ** 2 + DIM_REGULARIZATION
    return jnp.concatenate([d, -jnp.ones_like(d[..., :1])], axis=-1)


def rot_z(yaw):
    """Yaw-only rotation matrix (CONSTRAIN_ELLIPSOID_ORIENTATION build)."""
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    zeros = jnp.zeros_like(yaw)
    ones = jnp.ones_like(yaw)
    return jnp.stack(
        [
            jnp.stack([c, -s, zeros], axis=-1),
            jnp.stack([s, c, zeros], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )


def ellipsoid_corners_rectified(ellipsoid, pose, cam_from_robot_r, cam_from_robot_t):
    """Predicted rectified bbox corners of an ellipsoid seen from a robot pose.

    Faithful port of the dual-quadric corner math in
    ``getCornerLocationsVectorRectified`` (ellipsoid_utils.h:160-273):

      world_to_camera = cam_from_robot ∘ pose^-1
      E (3x4 compact)  = world_to_camera ∘ ellipsoid_pose(x,y,z,yaw)
      q (3x3)          = E · diag((d/2)^2+1e-3, -1) · E^T
      corners          = [q13 + sx, q13 - sx, q23 + sy, q23 - sy] / q33
                         with sx = sqrt(q13^2 - q11 q33), sy = sqrt(q23^2 - q22 q33)

    Returns ``(corners4, valid)`` where ``valid`` is False when either inner
    sqrt is <= 0 (the reference's "invalid ellipse" branch, :257). Corners are
    computed with clamped sqrt args so they are finite (and gradient-safe) even
    when invalid; the caller must mask with ``valid``.
    """
    r_wr_inv, t_wr_inv = pose_inverse_rt(pose)
    r_wc, t_wc = compose_rt(cam_from_robot_r, cam_from_robot_t, r_wr_inv, t_wr_inv)
    r_e = rot_z(ellipsoid[..., 3])
    t_e = ellipsoid[..., 0:3]
    r_ce, t_ce = compose_rt(r_wc, t_wc, r_e, t_e)
    # Compact 3x4 transform [R | t].
    e_mat = jnp.concatenate([r_ce, t_ce[..., :, None]], axis=-1)
    d = ellipsoid_dual_diag(ellipsoid)
    q = bmm(e_mat * d[..., None, :], jnp.swapaxes(e_mat, -1, -2))

    q11, q13 = q[..., 0, 0], q[..., 0, 2]
    q22, q23 = q[..., 1, 1], q[..., 1, 2]
    q33 = q[..., 2, 2]

    x_inner = q13 * q13 - q11 * q33
    y_inner = q23 * q23 - q22 * q33
    valid = (x_inner > 0) & (y_inner > 0)
    sx = jnp.sqrt(jnp.maximum(x_inner, 1e-12))
    sy = jnp.sqrt(jnp.maximum(y_inner, 1e-12))
    corners = jnp.stack([q13 + sx, q13 - sx, q23 + sy, q23 - sy], axis=-1)
    q33_safe = jnp.where(jnp.abs(q33) < 1e-12, 1e-12, q33)
    return corners / q33_safe[..., None], valid


def rectify_pixel(pixel, fx, fy, cx, cy):
    """(p - c) / f per axis (reprojection_cost_functor.cpp)."""
    return jnp.stack(
        [(pixel[..., 0] - cx) / fx, (pixel[..., 1] - cy) / fy], axis=-1
    )


def rectify_bb_corners(corners, fx, fy, cx, cy):
    """BbCorners [x_min,x_max,y_min,y_max] -> rectified (bounding_box_factor.cpp)."""
    return jnp.stack(
        [
            (corners[..., 0] - cx) / fx,
            (corners[..., 1] - cx) / fx,
            (corners[..., 2] - cy) / fy,
            (corners[..., 3] - cy) / fy,
        ],
        axis=-1,
    )


def essential_matrix(pose1, pose2, cam1_r, cam1_t, cam2_r, cam2_t):
    """Essential matrix relating rectified pixels of cam at pose1/pose2.

    Matches ``CalcEssentialMatrix`` (vslam_math_util.h:174):
    T_c1_c2 = (T_r_c1)^-1 T_w_r1^-1 T_w_r2 T_r_c2; E = [t]_x R.

    Here ``cam*_r/t`` are the extrinsics (camera in robot frame) as (R, t).
    """
    r1, t1 = pose_to_rt(pose1)
    r2, t2 = pose_to_rt(pose2)
    # cam1^-1:
    c1ri = jnp.swapaxes(cam1_r, -1, -2)
    c1ti = -bmv(c1ri, cam1_t)
    r1i = jnp.swapaxes(r1, -1, -2)
    t1i = -bmv(r1i, t1)
    ra, ta = compose_rt(c1ri, c1ti, r1i, t1i)
    rb, tb = compose_rt(ra, ta, r2, t2)
    rc, tc = compose_rt(rb, tb, cam2_r, cam2_t)
    return bmm(skew(tc), rc)
