"""Batched residual + Jacobian kernels for the five factor families.

Re-designs the reference's per-factor Ceres autodiff functors
(``include/refactoring/factors/``) as vmapped JAX kernels: each family
evaluates ALL its residual blocks in one fused XLA computation, with Jacobians
from ``jax.jacfwd`` of the per-block function (forward mode matches the
2-6 input / 2-7 output block shapes; the reference likewise relies on Ceres
dual-number autodiff — residual_creator.h:251-256 notes the symforce analytic
Jacobians are disabled).

Whitening (sqrt-information scaling) is baked into each residual, exactly as
in the reference constructors. Robust (Huber) weighting is applied by the
solver at the residual-block level via ``huber_sqrt_weight`` — the IRLS
sqrt(rho') scaling of Ceres' robustified Gauss-Newton.

Padding rows (mask=False) produce exactly zero residuals and Jacobians, so
capacity-padded tables contribute nothing to cost or normal equations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from obvi_slam_tpu import geometry as geo
from obvi_slam_tpu.types import BAState, CameraBundle, FactorTables

# ---------------------------------------------------------------------------
# Robust loss (Ceres HuberLoss semantics; s = squared norm of the block).
# ---------------------------------------------------------------------------


def highest_matmul(fn):
    """Pin every matmul/einsum traced inside ``fn`` to full f32 operand
    precision. A GPU's default float32 matmul may run in TF32 (~2^-11
    relative operand rounding) — harmless for redundant passes, harmful for
    Jacobian / Hessian values: the LM normal equations amplify the rounding
    by the damped system's condition number. Explicit per-op precision
    arguments (the Schur grams) still override this scoped default."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper


def huber_rho(s, delta):
    """Ceres HuberLoss: rho(s) = s for s <= delta^2 else 2*delta*sqrt(s)-delta^2."""
    d2 = delta * delta
    safe = jnp.maximum(s, 1e-30)
    return jnp.where(s <= d2, s, 2.0 * delta * jnp.sqrt(safe) - d2)


def huber_sqrt_weight(s, delta):
    """sqrt(rho'(s)) row scaling for the robustified normal equations.

    This is EXACTLY Ceres' robustification for Huber, not an approximation:
    Ceres' Corrector applies the Triggs alpha term only when rho''(s) > 0
    (corrector.cc: ``if (sq_norm == 0.0 || rho[2] <= 0.0) residual_scaling_
    = sqrt_rho1_; alpha = 0``), and HuberLoss has rho'' = 0 on the inlier
    branch and rho'' = -delta/(2 s^{3/2}) < 0 on the outlier branch — so
    alpha is always 0 and the correction degenerates to this sqrt(rho')
    scaling of both residual and Jacobian.
    """
    d2 = delta * delta
    safe = jnp.maximum(s, 1e-30)
    return jnp.where(s <= d2, 1.0, jnp.sqrt(delta / jnp.sqrt(safe)))


# ---------------------------------------------------------------------------
# Reprojection (reprojection_cost_functor.h: residual dim 2, blocks pose6/point3)
# ---------------------------------------------------------------------------


def _reproj_single(pose, point, cam_r, cam_t, rect_obs, multiplier):
    proj, _depth = geo.project_point_rectified(pose, point, cam_r, cam_t)
    return multiplier * (proj - rect_obs)


@highest_matmul
def reproj_residuals(state: BAState, cams: CameraBundle, f):
    pose = state.poses[f.pose_idx]
    point = state.points[f.point_idx]
    cam_r = cams.cam_from_robot_r[f.cam_idx]
    cam_t = cams.cam_from_robot_t[f.cam_idx]
    r = _reproj_single(pose, point, cam_r, cam_t, f.rect_obs, f.multiplier)
    return jnp.where(f.mask[:, None], r, 0.0)


@highest_matmul
def reproj_residuals_and_jac(state: BAState, cams: CameraBundle, f):
    """Returns (r (F,2), J_pose (F,2,6), J_point (F,2,3)), mask-zeroed."""

    def single(pose, point, cam_r, cam_t, obs, mult):
        return _reproj_single(pose, point, cam_r, cam_t, obs, mult)

    jac = jax.vmap(jax.jacfwd(single, argnums=(0, 1)))
    pose = state.poses[f.pose_idx]
    point = state.points[f.point_idx]
    cam_r = cams.cam_from_robot_r[f.cam_idx]
    cam_t = cams.cam_from_robot_t[f.cam_idx]
    r = _reproj_single(pose, point, cam_r, cam_t, f.rect_obs, f.multiplier)
    j_pose, j_point = jac(pose, point, cam_r, cam_t, f.rect_obs, f.multiplier)
    m = f.mask
    return (
        jnp.where(m[:, None], r, 0.0),
        jnp.where(m[:, None, None], j_pose, 0.0),
        jnp.where(m[:, None, None], j_point, 0.0),
    )


# ---------------------------------------------------------------------------
# Bounding box (bounding_box_factor.h: residual dim 4, blocks ellipsoid7/pose6)
# ---------------------------------------------------------------------------


def _bbox_single(ellipsoid, pose, cam_r, cam_t, rect_corners, sqrt_inf, invalid_error):
    corners, valid = geo.ellipsoid_corners_rectified(ellipsoid, pose, cam_r, cam_t)
    deviation = corners - rect_corners
    whitened = geo.bmv(sqrt_inf, deviation)
    # Invalid projection saturates to a constant -> zero Jacobian, exactly like
    # the reference's early-return branch (bounding_box_factor.h:81-96).
    return jnp.where(valid, whitened, invalid_error)


@highest_matmul
def bbox_residuals(state: BAState, cams: CameraBundle, f, invalid_error=1e6):
    single = jax.vmap(_bbox_single, in_axes=(0, 0, 0, 0, 0, 0, None))
    r = single(
        state.objects[f.obj_idx],
        state.poses[f.pose_idx],
        cams.cam_from_robot_r[f.cam_idx],
        cams.cam_from_robot_t[f.cam_idx],
        f.rect_corners,
        f.sqrt_inf,
        invalid_error,
    )
    return jnp.where(f.mask[:, None], r, 0.0)


@highest_matmul
def bbox_residuals_and_jac(state: BAState, cams: CameraBundle, f, invalid_error=1e6):
    """Returns (r (B,4), J_obj (B,4,7), J_pose (B,4,6)), mask-zeroed.
    Single traversal: jacfwd with has_aux returns residuals alongside."""

    def single_with_aux(obj, pose, cam_r, cam_t, corners, sqrt_inf):
        r = _bbox_single(obj, pose, cam_r, cam_t, corners, sqrt_inf, invalid_error)
        return r, r

    jac = jax.vmap(jax.jacfwd(single_with_aux, argnums=(0, 1), has_aux=True))
    obj = state.objects[f.obj_idx]
    pose = state.poses[f.pose_idx]
    cam_r = cams.cam_from_robot_r[f.cam_idx]
    cam_t = cams.cam_from_robot_t[f.cam_idx]
    (j_obj, j_pose), r = jac(obj, pose, cam_r, cam_t, f.rect_corners, f.sqrt_inf)
    m = f.mask
    return (
        jnp.where(m[:, None], r, 0.0),
        jnp.where(m[:, None, None], j_obj, 0.0),
        jnp.where(m[:, None, None], j_pose, 0.0),
    )


# ---------------------------------------------------------------------------
# Shape prior (shape_prior_factor.h: residual dim 3, block ellipsoid7)
# ---------------------------------------------------------------------------


@highest_matmul
def shape_residuals(state: BAState, f):
    deviation = state.objects[f.obj_idx][:, 4:7] - f.mean_dim
    r = geo.bmv(f.sqrt_inf, deviation)
    return jnp.where(f.mask[:, None], r, 0.0)


@highest_matmul
def shape_residuals_and_jac(state: BAState, f):
    """Returns (r (S,3), J_obj (S,3,7)). Analytic: d r / d dims = sqrt_inf."""
    r = shape_residuals(state, f)
    j = jnp.zeros(f.sqrt_inf.shape[:1] + (3, 7), dtype=r.dtype)
    j = j.at[:, :, 4:7].set(f.sqrt_inf)
    j = jnp.where(f.mask[:, None, None], j, 0.0)
    return r, j


# ---------------------------------------------------------------------------
# Relative pose (relative_pose_factor.h: residual dim 6, blocks pose6/pose6)
# ---------------------------------------------------------------------------


def _relpose_single(pose_before, pose_after, meas_t, meas_r, sqrt_inf):
    rb, tb = geo.pose_to_rt(pose_before)
    ra, ta = geo.pose_to_rt(pose_after)
    rbi = jnp.swapaxes(rb, -1, -2)
    rel_r = geo.bmm(rbi, ra)
    rel_t = geo.bmv(rbi, ta - tb)
    unscaled_t = rel_t - meas_t
    rot_err = geo.bmm(rel_r, jnp.swapaxes(meas_r, -1, -2))
    unscaled_w = geo.log_so3(rot_err)
    unscaled = jnp.concatenate([unscaled_t, unscaled_w], axis=-1)
    return geo.bmv(sqrt_inf, unscaled)


@highest_matmul
def relpose_residuals(state: BAState, f):
    single = jax.vmap(_relpose_single)
    r = single(
        state.poses[f.before_idx], state.poses[f.after_idx], f.meas_t, f.meas_r, f.sqrt_inf
    )
    return jnp.where(f.mask[:, None], r, 0.0)


@highest_matmul
def relpose_residuals_and_jac(state: BAState, f):
    """Returns (r (R,6), J_before (R,6,6), J_after (R,6,6)).
    Single traversal via jacfwd with has_aux."""

    def single_with_aux(pb, pa, mt, mr, si):
        r = _relpose_single(pb, pa, mt, mr, si)
        return r, r

    jac = jax.vmap(jax.jacfwd(single_with_aux, argnums=(0, 1), has_aux=True))
    pb = state.poses[f.before_idx]
    pa = state.poses[f.after_idx]
    (j_before, j_after), r = jac(pb, pa, f.meas_t, f.meas_r, f.sqrt_inf)
    m = f.mask
    return (
        jnp.where(m[:, None], r, 0.0),
        jnp.where(m[:, None, None], j_before, 0.0),
        jnp.where(m[:, None, None], j_after, 0.0),
    )


# ---------------------------------------------------------------------------
# LTM prior (independent_object_map_factor.h: residual dim 7, block ellipsoid7)
# ---------------------------------------------------------------------------


@highest_matmul
def ltm_residuals(state: BAState, f):
    deviation = state.objects[f.obj_idx] - f.mean
    r = geo.bmv(f.sqrt_inf, deviation)
    return jnp.where(f.mask[:, None], r, 0.0)


@highest_matmul
def ltm_residuals_and_jac(state: BAState, f):
    """Analytic: J = sqrt_inf (7x7)."""
    r = ltm_residuals(state, f)
    j = jnp.where(f.mask[:, None, None], f.sqrt_inf, 0.0)
    return r, j


# ---------------------------------------------------------------------------
# Scalar parameter prior (parameter_prior.h) — rank-deficiency repair.
# ---------------------------------------------------------------------------


def param_prior_residuals(state: BAState, f):
    """residual = (x[param] - mean) / std; returns (Q,)."""
    pose_val = state.poses[f.block_idx, jnp.clip(f.param_idx, 0, 5)]
    point_val = state.points[
        jnp.clip(f.block_idx, 0, state.points.shape[0] - 1),
        jnp.clip(f.param_idx, 0, 2),
    ]
    obj_val = state.objects[
        jnp.clip(f.block_idx, 0, state.objects.shape[0] - 1),
        jnp.clip(f.param_idx, 0, 6),
    ]
    val = jnp.where(f.block_kind == 0, pose_val, jnp.where(f.block_kind == 1, point_val, obj_val))
    r = f.inv_std * (val - f.mean)
    return jnp.where(f.mask, r, 0.0)


# ---------------------------------------------------------------------------
# Total robustified cost (Ceres convention: 0.5 * sum rho(||r||^2)).
# ---------------------------------------------------------------------------


@highest_matmul
def total_cost(
    state: BAState,
    cams: CameraBundle,
    tables: FactorTables,
    huber_reproj=1.0,
    huber_bbox=0.5,
    huber_shape=10.0,
    huber_relpose=1.0,
    huber_ltm=1.0,
    invalid_error=1e6,
    reproj_weight=None,
    bbox_weight=None,
    shape_weight=None,
    relpose_weight=None,
    ltm_weight=None,
):
    """Robustified total cost. ``*_weight`` optionally multiplies each block's
    rho (used by the two-phase outlier pass and scope-inclusion rules:
    weight 0 drops a factor without a shape change). NOTE: weights scale rho,
    not the residual, so only 0/1 weights match reference exclusion
    semantics exactly."""

    def block_cost(r, mask, delta, weight=None):
        s = jnp.sum(r * r, axis=-1)
        c = huber_rho(s, delta)
        c = jnp.where(mask, c, 0.0)
        if weight is not None:
            c = c * weight
        return 0.5 * jnp.sum(c)

    cost = block_cost(
        reproj_residuals(state, cams, tables.reproj), tables.reproj.mask, huber_reproj,
        reproj_weight,
    )
    cost += block_cost(
        bbox_residuals(state, cams, tables.bbox, invalid_error),
        tables.bbox.mask,
        huber_bbox,
        bbox_weight,
    )
    cost += block_cost(
        shape_residuals(state, tables.shape), tables.shape.mask, huber_shape, shape_weight
    )
    cost += block_cost(
        relpose_residuals(state, tables.relpose),
        tables.relpose.mask,
        huber_relpose,
        relpose_weight,
    )
    cost += block_cost(
        ltm_residuals(state, tables.ltm), tables.ltm.mask, huber_ltm, ltm_weight
    )
    rq = param_prior_residuals(state, tables.param_prior)
    cost += 0.5 * jnp.sum(jnp.where(tables.param_prior.mask, rq * rq, 0.0))
    return cost


@highest_matmul
def all_residuals(state, cams, tables, invalid_error=1e6):
    """Dict of per-family whitened residual arrays (pre-Huber)."""
    return {
        "reproj": reproj_residuals(state, cams, tables.reproj),
        "bbox": bbox_residuals(state, cams, tables.bbox, invalid_error),
        "shape": shape_residuals(state, tables.shape),
        "relpose": relpose_residuals(state, tables.relpose),
        "ltm": ltm_residuals(state, tables.ltm),
        "param_prior": param_prior_residuals(state, tables.param_prior),
    }
