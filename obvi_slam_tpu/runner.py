"""Offline problem runner: the per-frame optimization loop.

Re-design of ``OfflineProblemRunner`` (``offline_problem_runner.h:100-958``)
and the hook wiring of ``optimization_runner.h`` as explicit typed calls:

  for frame 1..N:
      window  = provide_optimization_window(frame)            (run_opt_utils.h:101-116)
      add frame data (pose-chain init, odom factor, visual frontend,
                      bb frontend)                            (pose_graph_frame_data_adder.h:138+)
      run_optimization_iteration(window, frame):
          [global-BA frames with PGO enabled: tracking solve + PGO+objects]
          phase I BA on window -> per-factor residual ranking ->
          exclude worst feature_outlier_percentage of reproj + bbox blocks ->
          revert values -> phase II without outliers          (:544-894)
          jump check -> revert                                 (:895-905)
  final: run_optimization_iteration(0, N)
  merge loop: while proximity merges found -> merge + full re-opt (:918-958)

Differences from the reference: phase II swaps 0/1 weight vectors instead of
rebuilding the Ceres problem; reverts swap cached numpy arrays instead of
deep-copying a pointer graph.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from obvi_slam_tpu import config as cfg
from obvi_slam_tpu import solver as slv
from obvi_slam_tpu.offline_data import OfflineProblemData
from obvi_slam_tpu.pose_graph import (
    OBJECT_OBSERVATION_FACTOR,
    REPROJECTION_FACTOR,
    PoseGraph,
)
from obvi_slam_tpu.solver.problem import (
    Problem,
    Scope,
    build_problem,
    reweight_for_exclusions,
    update_caps_pool,
    write_back,
)
from obvi_slam_tpu.timing import timer

logger = logging.getLogger(__name__)

import functools

import jax


@functools.cache
def _all_residuals_jit_for(invalid_error: float):
    import obvi_slam_tpu.factors as fac

    return jax.jit(
        lambda state, cams, tables: fac.all_residuals(
            state, cams, tables, invalid_error
        )
    )


def _all_residuals_jit(state, cams, tables, invalid_error):
    return _all_residuals_jit_for(float(invalid_error))(state, cams, tables)


def provide_optimization_window(max_frame_to_opt, max_frame_id, sliding_window_params):
    """run_opt_utils.h:101-116 verbatim."""
    if max_frame_to_opt == max_frame_id:
        return 0
    if max_frame_to_opt % sliding_window_params.global_ba_frequency == 0:
        return 0
    if max_frame_to_opt < sliding_window_params.local_ba_window_size:
        return 0
    return max_frame_to_opt - sliding_window_params.local_ba_window_size


def generate_odom_cov(rel_pose: np.ndarray, cov_params) -> np.ndarray:
    """generateOdomCov (relative_pose_factor_utils.h:17-36)."""
    k_min_std = 1e-3
    transl = rel_pose[:3]
    rot = rel_pose[3:6]
    angle = np.linalg.norm(rot)
    std = np.zeros(6)
    std[:3] = (
        np.abs(transl) * cov_params.transl_error_mult_for_transl_error
        + abs(angle) * cov_params.rot_error_mult_for_transl_error
    )
    std[3:] = (
        np.abs(rot) * cov_params.rot_error_mult_for_rot_error
        + np.linalg.norm(transl) * cov_params.transl_error_mult_for_rot_error
    )
    return np.diag(np.maximum(std, k_min_std) ** 2)


def lm_params_from_config(p: cfg.OptimizationSolverParams) -> slv.LMParams:
    return slv.LMParams(
        max_num_iterations=p.max_num_iterations,
        allow_non_monotonic_steps=p.allow_non_monotonic_steps,
        function_tolerance=p.function_tolerance,
        gradient_tolerance=p.gradient_tolerance,
        parameter_tolerance=p.parameter_tolerance,
        initial_trust_region_radius=p.initial_trust_region_radius,
        max_trust_region_radius=p.max_trust_region_radius,
    )


@dataclass
class RunnerHooks:
    """Optional injection points (the reference's std::function hooks)."""

    # Called as (pg, frame_id) after each frame's data adding.
    frame_data_extra: Optional[Callable] = None
    # Bounding-box frontend: called as (data, pg, frame_id). None = visual-only.
    bb_frontend: Optional[Callable] = None
    # Visualization callback: (pg, stage, frame_id).
    visualization: Optional[Callable] = None
    # Object merge decider at session end: (pg) -> bool (True if merged any).
    object_merger: Optional[Callable] = None
    # Called with (frame_id, summary, phase) after each solve.
    solve_logger: Optional[Callable] = None
    # Checkpoint emitter: called as (pg, label) at the reference's four dump
    # points (offline_object_visual_slam_main.cpp:394-409,627-653,
    # optimization_runner.h:499-506):
    #   "pose_graph_state_checkpoint_pre_optimization_<N>_attempt_<k>"
    #       before every final-frame optimization attempt,
    #   "pose_graph_state_checkpoint_post_frame_add"
    #       after all data + the final optimization, before postprocessing,
    #   "pose_graph_state_checkpoint_post_postprocessing"
    #       after the merge loop,
    #   "long_term_map_checkpoint"  at output extraction (pre-LTM; emitted by
    #       the CLI's output path, not the runner).
    checkpoint: Optional[Callable] = None


@dataclass
class OptLogRecord:
    """One row of the per-solve log (optimization_logger.h:94+ schema)."""

    frame_id: int
    global_ba: bool
    phase: int
    attempt: int
    num_poses: int
    num_features: int
    num_objects: int
    initial_cost: float
    final_cost: float
    iterations: int
    termination: str


class OfflineProblemRunner:
    def __init__(
        self,
        config: cfg.FullOVSLAMConfig,
        hooks: RunnerHooks = None,
        dtype=np.float64,
        mesh=None,
        shard_local_ba: bool = False,
        use_fused_solver: bool = None,
        use_device_sync: bool = None,
    ):
        self.config = config
        self.hooks = hooks or RunnerHooks()
        self.dtype = dtype
        self.opt_log: List[OptLogRecord] = []
        self.visual_frontend = None  # set by run_optimization
        # Session high-water capacity pools, one per solve class: passed as
        # ``caps`` to build_problem so jit signatures change only on
        # high-water growth (problem.observed_caps).
        self._caps_pools = {}
        # Device-resident session tables (solver/device_sync.py): per solve
        # class, the built problem is diff-synced to persistent device
        # buffers — only changed rows cross the host->device link, replacing
        # the per-window full re-upload. None = auto (on when no mesh; the
        # sharded path places
        # arrays itself). Global-BA problems additionally pin landmark rows
        # to first-appearance order (row_registry) so successive global
        # builds are append-only.
        self._use_device_sync = use_device_sync
        self._device_syncs = {}
        self._row_registries = {}
        # Multi-chip scale-out (the capability the reference lacks — its
        # solver is Ceres threads only, SURVEY.md §2.11): when a
        # jax.sharding.Mesh is given, global-BA problems are resharded onto
        # it (factor tables/plan/weights on the factor axis, state
        # replicated) before the solve; XLA partitions compute_step and
        # all-reduces the H/b/S accumulations across devices. Local BA windows are
        # usually too small to amortize collectives — opt in with
        # shard_local_ba.
        self.mesh = mesh
        self.shard_local_ba = shard_local_ba
        # None = auto (fused on accelerators, host loop on CPU); see solve().
        self.use_fused_solver = use_fused_solver

    # ------------------------------------------------------------------
    def caps_pool(self, key: str) -> dict:
        return self._caps_pools.setdefault(key, {})

    # ------------------------------------------------------------------
    def _window_caps_seed(self, data: OfflineProblemData, lo: int, hi: int):
        """Raw-count caps upper bound for a window of frames [lo, hi].

        Bounds what build_problem can produce for any scope over those
        frames: the frontend only ADMITS observations present in the raw
        data, so raw counts dominate every table/plan size. Objects are the
        one frontend-created quantity — bounded by raw bounding boxes /
        min_observations (the association gate). Under-estimates are safe:
        caps are monotone minimums, the actual window always wins (at the
        cost of one extra jit signature)."""
        from obvi_slam_tpu.solver.problem import _bucket
        from obvi_slam_tpu.solver.schur import _BAND_TP, _round_up

        obs = pairs = cross = feats = 0
        max_frames_per_track = 0
        tile_counts: Dict[int, int] = {}
        band_ok = True
        for track in data.feature_tracks.values():
            frames_in = [f for f in track if lo <= f <= hi]
            if not frames_in:
                continue
            feats += 1
            nf = len(frames_in)
            pairs += nf
            cross += nf * nf
            max_frames_per_track = max(max_frames_per_track, nf)
            obs += sum(len(track[f]) for f in frames_in)
            # Banded-gram home tiles (pose row == frame - lo for contiguous
            # global windows; local windows never reach band scale).
            fr0, fr1 = min(frames_in) - lo, max(frames_in) - lo
            home = fr0 // _BAND_TP
            tile_counts[home] = tile_counts.get(home, 0) + 1
            if fr1 - home * _BAND_TP >= 2 * _BAND_TP:
                band_ok = False

        bbs = 0
        for f, by_cam in getattr(data, "bounding_boxes", {}).items():
            if lo <= f <= hi:
                bbs += sum(len(v) for v in by_cam.values())
        n_frames = hi - lo + 1
        pose_cap = _bucket(n_frames + 1, minimum=8)

        seed = {
            "reproj": _bucket(max(obs, 1)),
            "bbox": _bucket(max(bbs, 1)),
            "shape": _bucket(16),
            "ltm": _bucket(16),
            "relpose": _bucket(n_frames + 1),
            "n_pose": pose_cap,
            "n_point": _bucket(max(feats, 1)),
            "pt_pair": _round_up(pairs),
            "pt_cross": _round_up(cross),
            "pt_dest": _round_up(min(cross, (n_frames + 1) ** 2)),
            "pt_slot_land": _round_up(feats),
            "pt_slot_c": _round_up(max_frames_per_track, bucket=4),
            # Empty-table defaults (what a build with no bounding boxes /
            # no banding produces) so even the key SET is stable from the
            # first build.
            "n_obj": _bucket(1, minimum=8),
            "ob_pair": _round_up(0),
            "ob_cross": _round_up(0),
            "ob_dest": _round_up(0),
            "ob_slot_land": _round_up(0),
            "ob_slot_c": _round_up(0, bucket=4),
            "pt_band_lg": 0,
            "rel_band_lg": 0,
        }
        if bbs:
            try:
                min_obs = max(
                    1,
                    int(
                        self.config.bounding_box_front_end_params
                        .feature_based_bb_association_params.min_observations
                    ),
                )
            except AttributeError:
                min_obs = 1
            n_obj = max(1, bbs // min_obs)
            # One-object worst case for the per-object cross pairs. The
            # plan dedups (pose, object) PAIRS, so each object contributes
            # at most n_frames+1 pairs regardless of camera count, and
            # sum(pairs_o^2) <= sum(pairs_o) * max(pairs_o)
            #              <= bbs * (n_frames + 1)
            # (pairs_o <= bbs_o holds since every pair needs >= 1 raw box).
            ob_cross = min(bbs * bbs, bbs * (n_frames + 1))
            seed.update(
                {
                    "n_obj": _bucket(n_obj, minimum=8),
                    "ob_pair": _round_up(bbs),
                    "ob_cross": _round_up(ob_cross),
                    "ob_dest": _round_up(min(ob_cross, (n_frames + 1) ** 2)),
                    "ob_slot_land": _round_up(n_obj),
                    "ob_slot_c": _round_up(
                        min(bbs, n_frames + 1), bucket=4
                    ),
                    "shape": _bucket(n_obj),
                }
            )
        if pose_cap >= 3 * _BAND_TP and band_ok and tile_counts:
            # Banded layouts engage at this pose capacity: seed the group
            # sizes so the first banded build matches the session high water
            # (Lg buckets at 128-row steps, rel band <= 64 relpose + 64
            # diagonal rows per tile; see schur._band_layout).
            seed["pt_band_lg"] = -(-max(tile_counts.values()) // 128) * 128
            seed["rel_band_lg"] = 128
        return seed

    def _seed_pool(self, key: str, seed: dict) -> dict:
        pool = self.caps_pool(key)
        for k, v in seed.items():
            pool[k] = max(pool.get(k, 0), int(v))
        return pool

    def presize_local_caps(self, data: OfflineProblemData):
        """Seed the local-BA caps pool from the first full window's RAW
        observation counts (an upper bound on what the frontend admits).

        Why: each caps high-water growth is a fresh jit signature, and each
        new signature is a compile that costs far more than the solve it
        serves. The growing-prefix windows of frames 1..W otherwise mint
        ~W/2 signatures before the pool stabilizes. Seeding with frames
        [0..W] collapses that to ~1 (later windows can still grow it —
        capacities stay monotone minimums, results are identical because
        padding rows are masked)."""
        w = self.config.sliding_window_params.local_ba_window_size
        return self._seed_pool("local", self._window_caps_seed(data, 0, w))

    def presize_session_caps(
        self, data: OfflineProblemData, max_frame_id: Optional[int] = None
    ):
        """Seed EVERY session caps pool from raw whole-session counts so jit
        signatures are stable from frame 1 (r5; extends presize_local_caps
        to the global-BA family).

        The growing global-BA windows (frames 0..F for every global-BA F)
        otherwise mint ~10 signatures per 40-frame session (counted by
        tools/caps_churn_probe.py), a compile each. With full-horizon
        seeding every global-family solve runs at final-session capacity
        from the start — the early windows pay padding compute instead of
        a compile per window. Pools seeded: local (first window), global, and — when
        the PGO-on-global-BA path is enabled — pgo / pgo_vf / pgo_tracking
        (same horizon; pgo relpose factors are the synthesized consecutive
        chain, bounded by the same n_frames+1)."""
        if max_frame_id is None:
            max_frame_id = data.max_frame_id()
        self.presize_local_caps(data)
        session = self._window_caps_seed(data, 0, max_frame_id)
        self._seed_pool("global", session)
        en = self.config.optimization_factors_enabled_params
        if (
            en.use_pose_graph_on_global_ba
            or en.use_pose_graph_on_final_global_ba
        ):
            self._seed_pool("pgo", session)
            self._seed_pool("pgo_vf", session)
            # Tracking solves span poses_prior_to_window_to_keep_constant+1
            # frames anywhere in the session: bound with the max over a
            # sliding scan of that width.
            n_const = max(1, en.poses_prior_to_window_to_keep_constant)
            track_seed: Dict[str, int] = {}
            step = max(1, self.config.sliding_window_params.global_ba_frequency)
            for f in range(0, max_frame_id + 1, step):
                ws = self._window_caps_seed(
                    data, max(0, f - n_const), min(f, max_frame_id)
                )
                for k, v in ws.items():
                    track_seed[k] = max(track_seed.get(k, 0), v)
            self._seed_pool("pgo_tracking", track_seed)
        return self._caps_pools

    # ------------------------------------------------------------------
    def _sync_enabled(self) -> bool:
        if self.mesh is not None:
            return False
        if self._use_device_sync is None:
            return True
        return bool(self._use_device_sync)

    def device_sync_for(self, key: str):
        from obvi_slam_tpu.solver.device_sync import DeviceSync

        return self._device_syncs.setdefault(key, DeviceSync())

    def sync_report(self) -> dict:
        """Bytes uploaded through each session DeviceSync (observability for
        the e2e bench: bytes-per-solve is the number the session tables are
        meant to shrink)."""
        return {
            k: {
                "total_bytes": s.total_bytes,
                "n_syncs": s.n_syncs,
                "bytes_per_sync": s.total_bytes / max(s.n_syncs, 1),
            }
            for k, s in self._device_syncs.items()
        }

    def build_problem_synced(
        self, pg, scope, key: str, residual_params=None, use_registry=None,
        **build_kw,
    ):
        """build_problem + caps-pool update + device sync (or mesh shard).

        The single entry point pipeline code should use: returns a Problem
        whose arrays live in the session's device-resident buffers when
        sync is enabled. ``use_registry``: pin landmark rows to
        first-appearance order (append-only tables) — default for the
        whole-session pools; never for sliding windows."""
        pool = self.caps_pool(key)
        use_sync = self._sync_enabled()
        registry = None
        if use_registry is None:
            use_registry = key == "global"
        if use_sync and use_registry:
            registry = self._row_registries.setdefault(key, {})
        problem = build_problem(
            pg,
            scope,
            residual_params
            if residual_params is not None
            else self.config.object_visual_pose_graph_residual_params,
            dtype=self.dtype,
            caps=pool,
            to_device=not use_sync,
            row_registry=registry,
            **build_kw,
        )
        update_caps_pool(pool, problem)
        if use_sync:
            problem = self._sync_problem(key, problem)
        return problem

    def write_back_synced(self, key: str, pg, problem, state):
        """write_back + adopt the solved state into the session DeviceSync
        (next build's diff then sees only externally changed rows)."""
        fetched = write_back(pg, problem, state)
        if self._sync_enabled():
            from obvi_slam_tpu import types as T

            self.device_sync_for(key).adopt(
                key + "[0]", state, T.BAState(*fetched)
            )
        return fetched

    def _sync_problem(self, key: str, problem):
        from dataclasses import replace

        sync = self.device_sync_for(key)
        state, cams, tables, plan, free, weights, aux = sync.sync(
            key,
            (
                problem.state,
                problem.cams,
                problem.tables,
                problem.plan,
                problem.free,
                problem.weights,
                problem.aux,
            ),
        )
        return replace(
            problem,
            state=state,
            cams=cams,
            tables=tables,
            plan=plan,
            free=free,
            weights=weights,
            aux=aux,
        )

    # ------------------------------------------------------------------
    def solve(self, problem, params, weights=None):
        """Run one LM solve on a built Problem.

        Dispatches to the fused on-device trust-region loop
        (solver.lm_fused: lax.while_loop, ONE dispatch per solve) on
        accelerators — per-iteration host round-trips dominate wall time
        there — and to the host loop (solver.lm) on CPU, where dispatch is
        cheap and the host loop avoids re-jitting the whole loop per
        distinct LMParams. Override with use_fused_solver=True/False."""
        use_fused = self.use_fused_solver
        if use_fused is None:
            import jax

            use_fused = jax.default_backend() != "cpu"
        kwargs = dict(
            weights=problem.weights if weights is None else weights,
            params=params,
            huber=problem.huber,
        )
        if self.mesh is not None:
            # Landmark-axis gram sharding (schur._shard_rows): without it
            # the factor sharding dies at the H/b all-reduce and the grams
            # run replicated on every device.
            kwargs["shard_mesh"] = self.mesh
        if use_fused:
            from obvi_slam_tpu import optlog
            from obvi_slam_tpu.solver import lm_fused

            with_records = (
                self.hooks.solve_logger is not None
                or optlog.IterationLoggerFactory.instance().enabled
            )
            return lm_fused.solve_fused(
                problem.state, problem.cams, problem.tables, problem.plan,
                problem.free, with_records=with_records,
                **kwargs,
            )
        return slv.solve(
            problem.state, problem.cams, problem.tables, problem.plan,
            problem.free, **kwargs,
        )

    # ------------------------------------------------------------------
    def _maybe_shard(self, problem, global_ba: bool):
        if self.mesh is None or not (global_ba or self.shard_local_ba):
            return problem
        from obvi_slam_tpu.parallel.sharding import shard_problem

        return shard_problem(problem, self.mesh)

    def _maybe_shard_weights(self, weights, global_ba: bool):
        if self.mesh is None or not (global_ba or self.shard_local_ba):
            return weights
        from obvi_slam_tpu.parallel.sharding import shard_weights

        return shard_weights(weights, self.mesh)

    # ------------------------------------------------------------------
    def _gba_checker(self, frame_id, max_frame_id) -> bool:
        return (
            provide_optimization_window(
                frame_id, max_frame_id, self.config.sliding_window_params
            )
            == 0
        )

    def _iteration_params(self, frame_id, max_frame_id) -> cfg.OptimizationIterationParams:
        """local/global/final param choice (optimization_runner.h:204-216)."""
        if frame_id == max_frame_id:
            return self.config.final_ba_iteration_params
        if self._gba_checker(frame_id, max_frame_id):
            return self.config.global_ba_iteration_params
        return self.config.local_ba_iteration_params

    def _scope(self, min_frame, max_frame) -> Scope:
        en = self.config.optimization_factors_enabled_params
        return Scope(
            min_frame_id=min_frame,
            max_frame_id=max_frame,
            include_object_factors=en.include_object_factors,
            include_visual_factors=en.include_visual_factors,
            fix_poses=en.fix_poses,
            fix_objects=en.fix_objects,
            fix_visual_features=en.fix_visual_features,
            fix_ltm_objects=en.fix_ltm_objects,
            poses_prior_to_window_to_keep_constant=en.poses_prior_to_window_to_keep_constant,
            min_object_observations=en.min_object_observations,
            min_low_level_feature_observations=en.min_low_level_feature_observations,
            min_low_level_feature_observations_per_frame=en.min_low_level_feature_observations_per_frame,
        )

    # ------------------------------------------------------------------
    def add_frame_data(
        self, data: OfflineProblemData, pg: PoseGraph, min_frame_id, frame_to_add
    ):
        """pose_graph_frame_data_adder.h:138-260."""
        init_pose = data.get_robot_pose_estimate(frame_to_add)
        if init_pose is None:
            raise ValueError(f"no initial pose estimate for frame {frame_to_add}")

        from obvi_slam_tpu.frontend.visual_features import _pose_to_rt

        if frame_to_add == 0:
            pg.add_frame(0, init_pose)
        else:
            prev_init = data.get_robot_pose_estimate(frame_to_add - 1)
            prev_optim = pg.get_robot_pose(frame_to_add - 1)
            if prev_init is None or prev_optim is None:
                pg.add_frame(frame_to_add, init_pose)
            else:
                # Chain relative init delta onto the optimized previous pose.
                r_pi, t_pi = _pose_to_rt(prev_init)
                r_ci, t_ci = _pose_to_rt(init_pose)
                rel_r = r_pi.T @ r_ci
                rel_t = r_pi.T @ (t_ci - t_pi)
                r_po, t_po = _pose_to_rt(prev_optim)
                new_r = r_po @ rel_r
                new_t = r_po @ rel_t + t_po
                from scipy.spatial.transform import Rotation

                pg.add_frame(
                    frame_to_add,
                    np.concatenate([new_t, Rotation.from_matrix(new_r).as_rotvec()]),
                )
            # Odometry factor from consecutive initial-pose delta.
            if prev_init is not None:
                r_pi, t_pi = _pose_to_rt(prev_init)
                r_ci, t_ci = _pose_to_rt(init_pose)
                from scipy.spatial.transform import Rotation

                rel = np.concatenate(
                    [
                        r_pi.T @ (t_ci - t_pi),
                        Rotation.from_matrix(r_pi.T @ r_ci).as_rotvec(),
                    ]
                )
                cov = generate_odom_cov(
                    rel,
                    self.config.object_visual_pose_graph_residual_params.relative_pose_cov_params,
                )
                pg.add_pose_factor(frame_to_add - 1, frame_to_add, rel, cov)

        if self.visual_frontend is not None:
            self.visual_frontend.add_visual_feature_observations(
                data, pg, min_frame_id, frame_to_add
            )
        if self.hooks.bb_frontend is not None:
            self.hooks.bb_frontend(data, pg, frame_to_add)
        if self.hooks.frame_data_extra is not None:
            self.hooks.frame_data_extra(pg, frame_to_add)

    # ------------------------------------------------------------------
    def run_optimization_iteration(
        self,
        data: OfflineProblemData,
        pg: PoseGraph,
        start_opt_with_frame: int,
        next_frame_id: int,
        max_frame_id: int,
        attempt_num: int = 0,
    ) -> bool:
        iteration_params = self._iteration_params(next_frame_id, max_frame_id)
        global_ba = self._gba_checker(next_frame_id, max_frame_id)
        en = self.config.optimization_factors_enabled_params

        # PGO-on-global-BA path (runPgoPlusEllipsoids) — wired when enabled.
        run_visual_feature_opt = True
        if global_ba:
            if next_frame_id == max_frame_id and attempt_num > 0:
                run_pgo = en.use_pose_graph_on_final_global_ba
                if run_pgo:
                    run_visual_feature_opt = en.use_visual_features_on_final_global_ba
            else:
                run_pgo = en.use_pose_graph_on_global_ba
                if run_pgo:
                    run_visual_feature_opt = en.use_visual_features_on_global_ba
            if run_pgo:
                from obvi_slam_tpu.pgo import run_pgo_plus_ellipsoids, run_tracking_solve

                with timer("obj_only_pgo_full_process"):
                    run_tracking_solve(self, data, pg, next_frame_id)
                    run_pgo_plus_ellipsoids(
                        self, data, pg, next_frame_id, next_frame_id == max_frame_id,
                        attempt_num,
                    )

        if not run_visual_feature_opt:
            return True

        scope = self._scope(start_opt_with_frame, next_frame_id)
        two_phase = iteration_params.feature_outlier_percentage > 0

        ba_name = "global_bundle_adjustment" if global_ba else "local_bundle_adjustment"
        with timer(ba_name):
            with timer(
                ("phase_one_gba_build_opt" if global_ba else "phase_one_lba_build_opt")
            ):
                key = "global" if global_ba else "local"
                problem = self.build_problem_synced(pg, scope, key)
                if not self._sync_enabled():
                    problem = self._maybe_shard(problem, global_ba)
            snapshot = pg.snapshot_values()

            use_fused = self.use_fused_solver
            if use_fused is None:
                use_fused = jax.default_backend() != "cpu"
            if two_phase and use_fused and problem.aux is not None:
                # Fused two-phase: solve_1 + outlier ranking + factor
                # re-selection + solve_2 as ONE device program
                # (lm_fused.solve_two_phase_jit) — removes the residual
                # readback, host reweight, weight re-upload, and second
                # dispatch fence per window. The timer covers BOTH phases
                # (the phase boundary no longer exists on the host).
                state, s1, s2 = self._solve_two_phase_fused(
                    problem, iteration_params, global_ba
                )
                self._log_solve(
                    problem, s1, next_frame_id, global_ba, 1, attempt_num
                )
                self._log_solve(
                    problem, s2, next_frame_id, global_ba, 2, attempt_num
                )
                self.write_back_synced(key, pg, problem, state)
                if iteration_params.allow_reversion_after_detecting_jumps:
                    if not self._consecutive_poses_stable(
                        pg,
                        scope.min_frame_id,
                        scope.max_frame_id,
                        iteration_params.consecutive_pose_transl_tol,
                        iteration_params.consecutive_pose_orient_tol,
                    ):
                        logger.warning(
                            "Jump detected after optimizing frame %d; "
                            "reverting",
                            next_frame_id,
                        )
                        pg.restore_values(snapshot)
                if self.hooks.visualization is not None:
                    self.hooks.visualization(
                        pg, "AFTER_EACH_OPTIMIZATION", next_frame_id
                    )
                return True

            with timer(
                ("phase_one_gba_solve_opt" if global_ba else "phase_one_lba_solve_opt")
            ):
                state, summary = self.solve(
                    problem,
                    lm_params_from_config(iteration_params.phase_one_opt_params),
                )
            self._log_solve(problem, summary, next_frame_id, global_ba, 1, attempt_num)

            if two_phase:
                # Outlier selection on post-phase-1 residuals. Jitted + ONE
                # batched device->host transfer: the previous eager call
                # dispatched every primitive separately, one device round
                # trip per op.
                res = jax.device_get(
                    _all_residuals_jit(
                        state, problem.cams, problem.tables,
                        problem.huber.invalid_ellipse_error,
                    )
                )
                excluded: Set[Tuple[int, int]] = set()
                for ftype, res_key, rows, w in (
                    (REPROJECTION_FACTOR, "reproj", problem.reproj_rows, problem.base_weights_np["reproj"]),
                    (OBJECT_OBSERVATION_FACTOR, "bbox", problem.bbox_rows, problem.base_weights_np["bbox"]),
                ):
                    r = np.asarray(res[res_key])[: len(rows)]
                    sq = np.sum(r * r, axis=1)
                    live = np.nonzero(w > 0)[0]
                    # Mirror the device pass exactly (solver/two_phase.py
                    # _outlier_mask): stable sort over the same f32 keys and
                    # the SAME f32 floor(n_live * pct) count, so host and
                    # fused-device paths select identical exclusion sets
                    # (ties and near-integer products included).
                    n_out = int(
                        np.floor(
                            np.float32(len(live))
                            * np.float32(
                                iteration_params.feature_outlier_percentage
                            )
                        )
                    )
                    if n_out > 0:
                        worst = live[np.argsort(-sq[live], kind="stable")[:n_out]]
                        for i in worst:
                            excluded.add((ftype, int(rows[i])))

                # Phase II: revert values, re-solve without outliers.
                pg.restore_values(snapshot)
                with timer(
                    ("phase_two_gba_build_opt" if global_ba else "phase_two_lba_build_opt")
                ):
                    if self._sync_enabled():
                        from obvi_slam_tpu.types import host_build

                        with host_build():
                            weights2 = reweight_for_exclusions(
                                pg, problem, excluded
                            )
                        weights2 = self.device_sync_for(key).sync(
                            key + "/w2", weights2
                        )
                    else:
                        weights2 = self._maybe_shard_weights(
                            reweight_for_exclusions(pg, problem, excluded),
                            global_ba,
                        )
                with timer(
                    ("phase_two_gba_solve_opt" if global_ba else "phase_two_lba_solve_opt")
                ):
                    state, summary = self.solve(
                        problem,
                        lm_params_from_config(iteration_params.phase_two_opt_params),
                        weights=weights2,
                    )
                self._log_solve(problem, summary, next_frame_id, global_ba, 2, attempt_num)

            self.write_back_synced(key, pg, problem, state)

            # Jump detection -> full revert (offline_problem_runner.h:895-905).
            if iteration_params.allow_reversion_after_detecting_jumps:
                if not self._consecutive_poses_stable(
                    pg,
                    scope.min_frame_id,
                    scope.max_frame_id,
                    iteration_params.consecutive_pose_transl_tol,
                    iteration_params.consecutive_pose_orient_tol,
                ):
                    logger.warning(
                        "Jump detected after optimizing frame %d; reverting",
                        next_frame_id,
                    )
                    pg.restore_values(snapshot)

        if self.hooks.visualization is not None:
            self.hooks.visualization(pg, "AFTER_EACH_OPTIMIZATION", next_frame_id)
        return True

    def _solve_two_phase_fused(self, problem, iteration_params, global_ba):
        """Both phases of the window iteration in one device dispatch."""
        from obvi_slam_tpu import optlog
        from obvi_slam_tpu.solver import lm_fused
        from obvi_slam_tpu.solver.two_phase import TwoPhaseConfig

        sc = problem.scope
        tp_cfg = TwoPhaseConfig(
            feature_outlier_percentage=float(
                iteration_params.feature_outlier_percentage
            ),
            min_low_level_feature_observations=int(
                sc.min_low_level_feature_observations
            ),
            min_low_level_feature_observations_per_frame=int(
                sc.min_low_level_feature_observations_per_frame
            ),
            min_object_observations=int(sc.min_object_observations),
            include_visual_factors=bool(sc.include_visual_factors),
            include_object_factors=bool(sc.include_object_factors),
            include_shape_priors=bool(sc.include_shape_priors),
            fix_objects=bool(sc.fix_objects),
            fix_ltm_objects=bool(sc.fix_ltm_objects),
            force_include_ltm_objs=bool(sc.force_include_ltm_objs),
        )
        with_records = (
            self.hooks.solve_logger is not None
            or optlog.IterationLoggerFactory.instance().enabled
        )
        with timer(
            "phase_one_gba_solve_opt" if global_ba else "phase_one_lba_solve_opt"
        ):
            return lm_fused.solve_two_phase_fused(
                problem.state,
                problem.cams,
                problem.tables,
                problem.plan,
                problem.free,
                problem.weights,
                problem.aux,
                lm_params_from_config(iteration_params.phase_one_opt_params),
                lm_params_from_config(iteration_params.phase_two_opt_params),
                problem.huber,
                tp_cfg,
                with_records=with_records,
                shard_mesh=self.mesh if self.mesh is not None else None,
            )

    def _consecutive_poses_stable(self, pg, min_frame, max_frame, transl_tol, orient_tol):
        """isConsecutivePosesStable_ (offline_problem_runner.h:337-374)."""
        from obvi_slam_tpu.frontend.visual_features import _pose_to_rt

        for frame in range(min_frame + 1, max_frame + 1):
            prev = pg.get_robot_pose(frame - 1)
            curr = pg.get_robot_pose(frame)
            if prev is None or curr is None:
                continue
            rp, tp = _pose_to_rt(prev)
            rc, tc = _pose_to_rt(curr)
            rel_t = rp.T @ (tc - tp)
            cos_a = np.clip((np.trace(rp.T @ rc) - 1) / 2, -1, 1)
            if np.linalg.norm(rel_t) > transl_tol or abs(np.arccos(cos_a)) > orient_tol:
                return False
        return True

    def _log_solve(self, problem, summary, frame_id, global_ba, phase, attempt):
        rec = OptLogRecord(
            frame_id=frame_id,
            global_ba=global_ba,
            phase=phase,
            attempt=attempt,
            num_poses=len(problem.pose_rows),
            num_features=len(problem.point_rows),
            num_objects=len(problem.obj_rows),
            initial_cost=summary.initial_cost,
            final_cost=summary.final_cost,
            iterations=summary.num_iterations,
            termination=summary.termination,
        )
        self.opt_log.append(rec)
        from obvi_slam_tpu import optlog

        ilf = optlog.IterationLoggerFactory.instance()
        if ilf.enabled:
            opt_type = (
                (optlog.GBA_PHASE1_TYPE if phase == 1 else optlog.GBA_PHASE2_TYPE)
                if global_ba
                else (optlog.LBA_PHASE1_TYPE if phase == 1 else optlog.LBA_PHASE2_TYPE)
            )
            ilf.log_iterations(
                opt_type, str(frame_id), summary, self._num_free_params(problem)
            )
        if self.hooks.solve_logger is not None:
            self.hooks.solve_logger(frame_id, summary, phase)

    @staticmethod
    def _num_free_params(problem) -> int:
        """num_parameters_reduced equivalent (free blocks only)."""
        p, x, o = jax.device_get(
            (problem.free.poses, problem.free.points, problem.free.objects)
        )
        return int(6 * np.sum(p) + 3 * np.sum(x) + 7 * np.sum(o))

    # ------------------------------------------------------------------
    def run_optimization(
        self,
        data: OfflineProblemData,
        pg: PoseGraph,
        visual_frontend=None,
        start_at_frame: int = 0,
        add_data_for_starting_frame: bool = True,
        max_frame_id: Optional[int] = None,
    ) -> bool:
        """Main loop (offline_problem_runner.h:100-274)."""
        self.visual_frontend = visual_frontend
        if max_frame_id is None:
            max_frame_id = data.max_frame_id()
        lt = self.config.limit_traj_eval_params
        if lt.should_limit_trajectory_evaluation:
            max_frame_id = min(lt.max_frame_id, max_frame_id)

        with timer("offline_runner_online_portion"):
            # Collapse the growing-window jit-signature churn for every
            # solve family (see presize_session_caps).
            self.presize_session_caps(data, max_frame_id)
            if start_at_frame == 0 and add_data_for_starting_frame:
                self.add_frame_data(data, pg, 0, 0)

            first_frame = max(1, start_at_frame)
            for next_frame_id in range(first_frame, max_frame_id + 1):
                with timer("optimization_iteration"):
                    window_start = provide_optimization_window(
                        next_frame_id, max_frame_id, self.config.sliding_window_params
                    )
                    if next_frame_id != start_at_frame or add_data_for_starting_frame:
                        with timer("frame_data_adder"):
                            self.add_frame_data(data, pg, window_start, next_frame_id)
                    if not self.run_optimization_iteration(
                        data, pg, window_start, next_frame_id, max_frame_id
                    ):
                        return False

        with timer("offline_runner_offline_portion"):
            # Final refinement over the whole trajectory.
            self._checkpoint(
                pg,
                "pose_graph_state_checkpoint_pre_optimization_"
                f"{max_frame_id}_attempt_1",
            )
            if not self.run_optimization_iteration(
                data, pg, 0, max_frame_id, max_frame_id, attempt_num=1
            ):
                return False
            self._checkpoint(pg, "pose_graph_state_checkpoint_post_frame_add")

            # Post-session merge loop.
            if self.hooks.object_merger is not None:
                with timer("post_session_map_merge"):
                    post_round = 2
                    while self.hooks.object_merger(pg):
                        self._checkpoint(
                            pg,
                            "pose_graph_state_checkpoint_pre_optimization_"
                            f"{max_frame_id}_attempt_{post_round}",
                        )
                        if not self.run_optimization_iteration(
                            data, pg, 0, max_frame_id, max_frame_id, attempt_num=post_round
                        ):
                            return False
                        post_round += 1
            self._checkpoint(
                pg, "pose_graph_state_checkpoint_post_postprocessing"
            )
        return True

    def _checkpoint(self, pg, label: str):
        if self.hooks.checkpoint is not None:
            self.hooks.checkpoint(pg, label)
