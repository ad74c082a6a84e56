"""ObVi-SLAM in JAX: an accelerator-native object-visual SLAM framework.

A from-scratch re-design of the capabilities of ut-amrl/ObVi-SLAM
(joint object + visual-feature sliding-window / global bundle adjustment
with a long-term object map) built on JAX/XLA, running on NVIDIA GPUs.

Architecture (vs the reference's layer map, SURVEY.md §1):

  - ``geometry``      SO(3)/SE(3) + dual-quadric ellipsoid math, batched,
                      NaN-safe under jit/vmap/grad (ref: vslam_math_util.h,
                      ellipsoid_utils.h).
  - ``factors``       the five residual families as batched kernels with
                      analytic/jacfwd Jacobians (ref: include/refactoring/factors/).
  - ``solver``        Levenberg-Marquardt with Ceres trust-region semantics and
                      on-device Schur-complement landmark marginalization
                      (ref: object_pose_graph_optimizer.h + Ceres SPARSE_SCHUR).
  - ``pose_graph``    host-side struct-of-arrays state store
                      (ref: object_pose_graph.h / low_level_feature_pose_graph.h).
  - ``frontend``      visual-feature gating + bounding-box data association
                      (ref: visual_feature_front_end.h, bounding_box_front_end.h).
  - ``runner``        per-frame loop, window policy, two-phase outlier
                      rejection, jump reversion (ref: offline_problem_runner.h).
  - ``ltm``           long-term object map extraction / priors
                      (ref: long_term_object_map_extraction.h).
  - ``parallel``      mesh sharding of global BA (factors sharded across
                      devices, Schur blocks psum-reduced across them).
  - ``metrics``       ATE/RPE/waypoint-consistency + object metrics
                      (ref: trajectory_metrics_generator.cpp, object_evaluation_utils.h).
"""

__version__ = "0.1.0"
