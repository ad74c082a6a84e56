"""Core state and factor-table types.

The reference stores state as pointer-chased per-node structs handed to Ceres
(``low_level_feature_pose_graph.h:25-65``, ``object_pose_graph.h:22-87``).
This design is struct-of-arrays with fixed capacities and validity
masks so every solve is a static-shape XLA program:

  - ``BAState``: the optimizable variables — poses (P,6), feature points
    (M,3), ellipsoid objects (K,7).
  - ``*Factors``: one padded table per factor family, each row one residual
    block (measurement + gather indices + square-root information).
  - ``CameraBundle``: per-camera rectification constants and the
    robot-in-camera-frame transform (inverse extrinsics), precomputed on host
    exactly like the factor constructors do
    (reprojection_cost_functor.cpp, bounding_box_factor.cpp).

All tables are JAX pytrees (NamedTuples of arrays) so they can cross jit
boundaries, be donated, and be sharded with jax.sharding.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Host-build mode: table/plan constructors normally commit arrays to device
# (jnp.asarray). Inside ``host_build()`` they return numpy instead, so the
# builder's output can be diff-synced to a device-resident session table
# (solver/device_sync.py) — uploading only changed rows instead of
# re-uploading every table per window (the reference
# rebuilds its Ceres problem per frame, offline_problem_runner.h:100-274;
# our equivalent rebuild is host-side numpy + an incremental device sync).
# ---------------------------------------------------------------------------

_HOST_BUILD = threading.local()


@contextlib.contextmanager
def host_build():
    prev = getattr(_HOST_BUILD, "on", False)
    _HOST_BUILD.on = True
    try:
        yield
    finally:
        _HOST_BUILD.on = prev


def asarray(x):
    """jnp.asarray normally; numpy passthrough inside host_build()."""
    if getattr(_HOST_BUILD, "on", False):
        return np.asarray(x)
    return jnp.asarray(x)

# Parameter block sizes (vslam_obj_opt_types_refactor.h:15-36; default
# CONSTRAIN_ELLIPSOID_ORIENTATION=ON build: yaw-only ellipsoid orientation).
POSE_DIM = 6
POINT_DIM = 3
ELLIPSOID_DIM = 7


class BAState(NamedTuple):
    """Optimizable state. Leading axes are static capacities; rows beyond the
    live counts are padding (masked out via the factor tables)."""

    poses: jnp.ndarray  # (P, 6)  [t, axis-angle]
    points: jnp.ndarray  # (M, 3)
    objects: jnp.ndarray  # (K, 7) [x, y, z, yaw, dx, dy, dz]


class CameraBundle(NamedTuple):
    """Per-camera constants (C cameras).

    ``cam_from_robot_*`` is the robot pose expressed in the camera frame —
    the inverse of the extrinsics, matching ``cam_to_robot_tf_inv_`` /
    ``robot_to_cam_tf_`` in the reference factors.
    """

    cam_from_robot_r: jnp.ndarray  # (C, 3, 3)
    cam_from_robot_t: jnp.ndarray  # (C, 3)
    fx: jnp.ndarray  # (C,)
    fy: jnp.ndarray  # (C,)
    cx: jnp.ndarray  # (C,)
    cy: jnp.ndarray  # (C,)


class ReprojectionFactors(NamedTuple):
    """Visual-feature reprojection factors (reprojection_cost_functor.h).

    residual_k = multiplier_k * (projected_rectified_k - rect_obs_k), k in xy,
    with multiplier = f_axis / reprojection_error_std_dev.
    """

    pose_idx: jnp.ndarray  # (F,) int32
    point_idx: jnp.ndarray  # (F,) int32
    cam_idx: jnp.ndarray  # (F,) int32
    rect_obs: jnp.ndarray  # (F, 2) rectified pixel observation
    multiplier: jnp.ndarray  # (F, 2) [fx/sigma, fy/sigma]
    mask: jnp.ndarray  # (F,) bool — live row

    @property
    def capacity(self):
        return self.pose_idx.shape[0]


class BoundingBoxFactors(NamedTuple):
    """Object bounding-box observation factors (bounding_box_factor.h).

    residual = sqrt_inf @ (predicted_rect_corners - rect_corners); all four
    entries saturate to ``invalid_ellipse_error`` when the dual-quadric
    projection is degenerate (bounding_box_factor.h:81-96).
    """

    obj_idx: jnp.ndarray  # (B,) int32
    pose_idx: jnp.ndarray  # (B,) int32
    cam_idx: jnp.ndarray  # (B,) int32
    rect_corners: jnp.ndarray  # (B, 4) rectified [x_min, x_max, y_min, y_max]
    sqrt_inf: jnp.ndarray  # (B, 4, 4) sqrtm(cov^-1) @ diag(fx,fx,fy,fy)
    mask: jnp.ndarray  # (B,) bool

    @property
    def capacity(self):
        return self.obj_idx.shape[0]


class ShapePriorFactors(NamedTuple):
    """Per-object dimension priors from semantic class (shape_prior_factor.h)."""

    obj_idx: jnp.ndarray  # (S,) int32
    mean_dim: jnp.ndarray  # (S, 3)
    sqrt_inf: jnp.ndarray  # (S, 3, 3)
    mask: jnp.ndarray  # (S,) bool

    @property
    def capacity(self):
        return self.obj_idx.shape[0]


class RelativePoseFactors(NamedTuple):
    """Odometry / synthesized relative-pose factors (relative_pose_factor.h).

    residual[:3] = t(T_before^-1 T_after) - t_meas
    residual[3:] = Log(R(T_before^-1 T_after) @ R_meas^T), 6x6 sqrt_inf whitened.
    """

    before_idx: jnp.ndarray  # (R,) int32
    after_idx: jnp.ndarray  # (R,) int32
    meas_t: jnp.ndarray  # (R, 3)
    meas_r: jnp.ndarray  # (R, 3, 3) measured rotation change
    sqrt_inf: jnp.ndarray  # (R, 6, 6)
    mask: jnp.ndarray  # (R,) bool

    @property
    def capacity(self):
        return self.before_idx.shape[0]


class LtmPriorFactors(NamedTuple):
    """Long-term-map unary priors on ellipsoids (independent_object_map_factor.h)."""

    obj_idx: jnp.ndarray  # (L,) int32
    mean: jnp.ndarray  # (L, 7)
    sqrt_inf: jnp.ndarray  # (L, 7, 7)
    mask: jnp.ndarray  # (L,) bool

    @property
    def capacity(self):
        return self.obj_idx.shape[0]


class ParamPriorFactors(NamedTuple):
    """Unary Gaussian prior on a single scalar parameter (parameter_prior.h).

    Used for rank-deficiency repair during LTM covariance extraction.
    ``block_kind``: 0 = pose, 1 = point, 2 = object. ``param_idx`` indexes
    within the block's parameter vector.
    """

    block_kind: jnp.ndarray  # (Q,) int32
    block_idx: jnp.ndarray  # (Q,) int32
    param_idx: jnp.ndarray  # (Q,) int32
    mean: jnp.ndarray  # (Q,)
    inv_std: jnp.ndarray  # (Q,)
    mask: jnp.ndarray  # (Q,) bool

    @property
    def capacity(self):
        return self.block_kind.shape[0]


class FactorTables(NamedTuple):
    reproj: ReprojectionFactors
    bbox: BoundingBoxFactors
    shape: ShapePriorFactors
    relpose: RelativePoseFactors
    ltm: LtmPriorFactors
    param_prior: ParamPriorFactors


class FreeMasks(NamedTuple):
    """Which parameter blocks are variable (True) vs held constant, matching
    the reference's constant-block handling (object_pose_graph_optimizer.h:424-472)."""

    poses: jnp.ndarray  # (P,) bool
    points: jnp.ndarray  # (M,) bool
    objects: jnp.ndarray  # (K,) bool


def _pad(arr, capacity, dtype=None):
    arr = np.asarray(arr)
    if dtype is not None:
        arr = arr.astype(dtype)
    shape = (capacity,) + arr.shape[1:]
    out = np.zeros(shape, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _mask(n, capacity):
    m = np.zeros((capacity,), dtype=bool)
    m[:n] = True
    return m


def make_reprojection_factors(
    pose_idx, point_idx, cam_idx, rect_obs, multiplier, capacity=None, dtype=np.float64
):
    n = len(pose_idx)
    capacity = capacity or max(n, 1)
    return ReprojectionFactors(
        pose_idx=asarray(_pad(pose_idx, capacity, np.int32)),
        point_idx=asarray(_pad(point_idx, capacity, np.int32)),
        cam_idx=asarray(_pad(cam_idx, capacity, np.int32)),
        rect_obs=asarray(_pad(np.reshape(rect_obs, (n, 2)), capacity, dtype)),
        multiplier=asarray(_pad(np.reshape(multiplier, (n, 2)), capacity, dtype)),
        mask=asarray(_mask(n, capacity)),
    )


def make_bounding_box_factors(
    obj_idx, pose_idx, cam_idx, rect_corners, sqrt_inf, capacity=None, dtype=np.float64
):
    n = len(obj_idx)
    capacity = capacity or max(n, 1)
    return BoundingBoxFactors(
        obj_idx=asarray(_pad(obj_idx, capacity, np.int32)),
        pose_idx=asarray(_pad(pose_idx, capacity, np.int32)),
        cam_idx=asarray(_pad(cam_idx, capacity, np.int32)),
        rect_corners=asarray(
            _pad(np.reshape(rect_corners, (n, 4)), capacity, dtype)
        ),
        sqrt_inf=asarray(_pad(np.reshape(sqrt_inf, (n, 4, 4)), capacity, dtype)),
        mask=asarray(_mask(n, capacity)),
    )


def make_shape_prior_factors(obj_idx, mean_dim, sqrt_inf, capacity=None, dtype=np.float64):
    n = len(obj_idx)
    capacity = capacity or max(n, 1)
    return ShapePriorFactors(
        obj_idx=asarray(_pad(obj_idx, capacity, np.int32)),
        mean_dim=asarray(_pad(np.reshape(mean_dim, (n, 3)), capacity, dtype)),
        sqrt_inf=asarray(_pad(np.reshape(sqrt_inf, (n, 3, 3)), capacity, dtype)),
        mask=asarray(_mask(n, capacity)),
    )


def make_relative_pose_factors(
    before_idx, after_idx, meas_t, meas_r, sqrt_inf, capacity=None, dtype=np.float64
):
    n = len(before_idx)
    capacity = capacity or max(n, 1)
    return RelativePoseFactors(
        before_idx=asarray(_pad(before_idx, capacity, np.int32)),
        after_idx=asarray(_pad(after_idx, capacity, np.int32)),
        meas_t=asarray(_pad(np.reshape(meas_t, (n, 3)), capacity, dtype)),
        meas_r=asarray(_pad(np.reshape(meas_r, (n, 3, 3)), capacity, dtype)),
        sqrt_inf=asarray(_pad(np.reshape(sqrt_inf, (n, 6, 6)), capacity, dtype)),
        mask=asarray(_mask(n, capacity)),
    )


def make_ltm_prior_factors(obj_idx, mean, sqrt_inf, capacity=None, dtype=np.float64):
    n = len(obj_idx)
    capacity = capacity or max(n, 1)
    return LtmPriorFactors(
        obj_idx=asarray(_pad(obj_idx, capacity, np.int32)),
        mean=asarray(_pad(np.reshape(mean, (n, 7)), capacity, dtype)),
        sqrt_inf=asarray(_pad(np.reshape(sqrt_inf, (n, 7, 7)), capacity, dtype)),
        mask=asarray(_mask(n, capacity)),
    )


def make_param_prior_factors(
    block_kind, block_idx, param_idx, mean, inv_std, capacity=None, dtype=np.float64
):
    n = len(block_kind)
    capacity = capacity or max(n, 1)
    return ParamPriorFactors(
        block_kind=asarray(_pad(block_kind, capacity, np.int32)),
        block_idx=asarray(_pad(block_idx, capacity, np.int32)),
        param_idx=asarray(_pad(param_idx, capacity, np.int32)),
        mean=asarray(_pad(mean, capacity, dtype)),
        inv_std=asarray(_pad(inv_std, capacity, dtype)),
        mask=asarray(_mask(n, capacity)),
    )


def empty_reprojection_factors(capacity=1, dtype=np.float64):
    return make_reprojection_factors([], [], [], np.zeros((0, 2)), np.zeros((0, 2)), capacity, dtype)


def empty_bounding_box_factors(capacity=1, dtype=np.float64):
    return make_bounding_box_factors(
        [], [], [], np.zeros((0, 4)), np.zeros((0, 4, 4)), capacity, dtype
    )


def empty_shape_prior_factors(capacity=1, dtype=np.float64):
    return make_shape_prior_factors([], np.zeros((0, 3)), np.zeros((0, 3, 3)), capacity, dtype)


def empty_relative_pose_factors(capacity=1, dtype=np.float64):
    return make_relative_pose_factors(
        [], [], np.zeros((0, 3)), np.zeros((0, 3, 3)), np.zeros((0, 6, 6)), capacity, dtype
    )


def empty_ltm_prior_factors(capacity=1, dtype=np.float64):
    return make_ltm_prior_factors([], np.zeros((0, 7)), np.zeros((0, 7, 7)), capacity, dtype)


def empty_param_prior_factors(capacity=1, dtype=np.float64):
    return make_param_prior_factors([], [], [], [], [], capacity, dtype)


def empty_factor_tables(dtype=np.float64):
    return FactorTables(
        reproj=empty_reprojection_factors(dtype=dtype),
        bbox=empty_bounding_box_factors(dtype=dtype),
        shape=empty_shape_prior_factors(dtype=dtype),
        relpose=empty_relative_pose_factors(dtype=dtype),
        ltm=empty_ltm_prior_factors(dtype=dtype),
        param_prior=empty_param_prior_factors(dtype=dtype),
    )


def make_camera_bundle(extrinsic_r, extrinsic_t, fx, fy, cx, cy, dtype=np.float64):
    """Build a CameraBundle from extrinsics (camera pose in robot frame).

    Precomputes the inverse (robot in camera frame) exactly as the reference
    factor constructors do."""
    extrinsic_r = np.asarray(extrinsic_r, dtype=dtype)
    extrinsic_t = np.asarray(extrinsic_t, dtype=dtype)
    r_inv = np.swapaxes(extrinsic_r, -1, -2)
    t_inv = -np.einsum("...ij,...j->...i", r_inv, extrinsic_t)
    return CameraBundle(
        cam_from_robot_r=asarray(r_inv),
        cam_from_robot_t=asarray(t_inv),
        fx=asarray(np.atleast_1d(fx).astype(dtype)),
        fy=asarray(np.atleast_1d(fy).astype(dtype)),
        cx=asarray(np.atleast_1d(cx).astype(dtype)),
        cy=asarray(np.atleast_1d(cy).astype(dtype)),
    )
