"""Analytic reprojection residual + Jacobian (the solver's XLA path).

The generic path (``residuals.reproj_residuals_and_jac``) vmaps jacfwd over
factors, re-evaluating the pose's Rodrigues rotation (and differentiating
through it) once PER FACTOR — 24k transcendental-heavy evaluations for 24k
factors over 256 poses. This kernel hoists all pose-level work to per-pose
tables (R^T and dR^T/dw, computed once per pose via jacfwd over P items) and
builds the per-factor Jacobians by chain rule with pure batched einsums:

    p_r  = R^T (x - t)                   (robot frame)
    p_c  = C_r p_r + C_t                 (camera frame)
    proj = p_c_xy / p_c_z
    r    = mult * (proj - obs)

    dproj/dp_c = [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]]
    dp_c/dx    =  C_r R^T          dp_c/dt = -C_r R^T
    dp_c/dw_i  =  C_r (dR^T/dw_i) (x - t)

Numerically identical to the autodiff path (same forward expressions, exact
chain rule); validated against it in tests to f64 precision.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from obvi_slam_tpu.factors.residuals import highest_matmul

from obvi_slam_tpu import geometry as geo
from obvi_slam_tpu.types import BAState, CameraBundle


def pose_rotation_tables(poses):
    """Per-pose R^T (world->robot) and the right Jacobian Jr(w): (P,3,3) each.

    The rotation derivative enters via the identity
        d(R(w)^T v)/dw = [R^T v]_x Jr(w)
    (from dR/dw_i = R [Jr e_i]_x), so a 9-component Jr gather replaces the
    27-component dR^T/dw tensor the naive chain rule needs."""
    w = poses[:, 3:6]
    rt = jnp.swapaxes(geo.exp_so3(w), -1, -2)
    jr = geo.right_jacobian_so3(w)
    return rt, jr


@highest_matmul
def reproj_residuals_and_jac_fast(state: BAState, cams: CameraBundle, f):
    """Drop-in replacement for factors.reproj_residuals_and_jac."""
    dtype = state.poses.dtype
    rt, jr = pose_rotation_tables(state.poses)

    pose_t = state.poses[f.pose_idx, 0:3]  # (F,3)
    rt_f = rt[f.pose_idx]  # (F,3,3)
    jr_f = jr[f.pose_idx]  # (F,3,3)
    x = state.points[f.point_idx]  # (F,3)
    c_r = cams.cam_from_robot_r[f.cam_idx]  # (F,3,3)
    c_t = cams.cam_from_robot_t[f.cam_idx]  # (F,3)

    diff = x - pose_t
    p_r = geo.bmv(rt_f, diff)
    p_c = geo.bmv(c_r, p_r) + c_t
    z = p_c[:, 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-300, 1e-300, z)
    inv_z = 1.0 / z_safe
    proj = p_c[:, :2] * inv_z[:, None]
    r = f.multiplier * (proj - f.rect_obs)

    # dproj/dp_c (F,2,3)
    zero = jnp.zeros_like(inv_z)
    dproj = jnp.stack(
        [
            jnp.stack([inv_z, zero, -p_c[:, 0] * inv_z * inv_z], axis=-1),
            jnp.stack([zero, inv_z, -p_c[:, 1] * inv_z * inv_z], axis=-1),
        ],
        axis=-2,
    )
    # scaled rows by multiplier
    dproj = dproj * f.multiplier[:, :, None]

    cr_rt = geo.bmm(c_r, rt_f)  # (F,3,3)
    j_point = geo.bmm(dproj, cr_rt)  # (F,2,3)
    j_t = -j_point  # translation block
    # d(R^T diff)/dw = [p_r]_x Jr  =>  dp_c/dw = C_r [p_r]_x Jr.
    skew_pr = geo.skew(p_r)  # (F,3,3)
    dpc_dw = geo.bmm(geo.bmm(c_r, skew_pr), jr_f)
    j_w = geo.bmm(dproj, dpc_dw)  # (F,2,3)
    j_pose = jnp.concatenate([j_t, j_w], axis=-1)  # (F,2,6)

    m = f.mask
    return (
        jnp.where(m[:, None], r, 0.0),
        jnp.where(m[:, None, None], j_pose, 0.0),
        jnp.where(m[:, None, None], j_point, 0.0),
    )
