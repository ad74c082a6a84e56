#!/usr/bin/env python
"""Full single-session pipeline — the ``offline_object_visual_slam_main``
equivalent (src/refactoring/offline_object_visual_slam_main.cpp:659-1106).

Reads config + calibration + initial trajectory + detections + ORB feature
output (+ optional previous-session LTM), runs the sliding-window/global BA
loop with the object pipeline, extracts the long-term map, writes results.
"""

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--params_config_file", required=True)
    parser.add_argument("--intrinsics_file", required=True)
    parser.add_argument("--extrinsics_file", required=True)
    parser.add_argument("--poses_by_node_id_file", required=True)
    parser.add_argument("--bounding_boxes_by_node_id_file", default="")
    parser.add_argument("--low_level_feats_dir", required=True)
    parser.add_argument("--long_term_map_input", default="")
    parser.add_argument("--long_term_map_output", default="")
    parser.add_argument("--robot_poses_results_file", default="")
    parser.add_argument(
        "--bb_associations_out_file",
        default="",
        help="bounding-box association results artifact "
        "(ObjectDataAssociationResults, main.cpp:1084-1096)",
    )
    parser.add_argument("--ellipsoids_results_file", default="")
    parser.add_argument("--visual_feature_results_file", default="")
    parser.add_argument("--checkpoint_output_dir", default="")
    parser.add_argument("--logs_directory", default="")
    parser.add_argument("--timing_report_file", default="")
    parser.add_argument("--opt_log_file", default="")
    parser.add_argument("--platform", default="", help="jax platform override (cpu/gpu)")
    parser.add_argument("--f64", action="store_true", help="double-precision solves")
    parser.add_argument(
        "--shard_devices",
        type=int,
        default=0,
        help="shard global-BA solves across the first N jax devices "
        "(factor-axis data parallelism over a Mesh; 0 = single device). "
        "The scale-out capability the reference lacks (SURVEY.md §2.11).",
    )
    parser.add_argument(
        "--shard_local_ba",
        action="store_true",
        help="also shard sliding-window (local BA) solves on the mesh",
    )
    parser.add_argument(
        "--detector_command",
        default="",
        help="live detector worker command (the /yolov5_detect_objs service "
        "equivalent, bounding_box_retriever.h:33-171): a process speaking "
        "newline-delimited JSON {image_path,...} -> {detections: [{label, "
        "conf, xyxy}]}. Used for frames absent from "
        "--bounding_boxes_by_node_id_file; requires --images_dir",
    )
    parser.add_argument(
        "--images_dir",
        default="",
        help="frame images as <images_dir>/<camera_id>/<frame_id>.png for "
        "the live detector path",
    )
    parser.add_argument(
        "--debug_images_output_directory",
        default="",
        help="dump per-frame bounding-box-association debug images here "
        "(SaveToFileVisualizer equivalent, "
        "offline_object_visual_slam_main.cpp:92)",
    )
    parser.add_argument(
        "--fused_solver",
        choices=("auto", "on", "off"),
        default="auto",
        help="run the whole LM trust-region loop on device (lax.while_loop, "
        "one dispatch per solve). auto = on for accelerators, off for CPU",
    )
    parser.add_argument(
        "--profile_trace_dir",
        default="",
        help="capture a jax.profiler trace of the whole session into this "
        "directory (TensorBoard/Perfetto format) — the device-side analog of "
        "the reference's RUN_TIMERS cumulative tracing (SURVEY.md §5); the "
        "per-phase wall-clock table (--timing_report_file) is always on",
    )
    args = parser.parse_args(argv)

    import jax

    from obvi_slam_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    import numpy as np

    from obvi_slam_tpu import config as cfg
    from obvi_slam_tpu import io as oio
    from obvi_slam_tpu.config import shape_prior_map
    from obvi_slam_tpu.frontend import (
        FeatureBasedBoundingBoxFrontEnd,
        VisualFeatureFrontend,
        apply_merges,
        make_bb_frontend_hook,
        merge_objects_by_center_proximity,
    )
    from obvi_slam_tpu.io.readers import make_cameras
    from obvi_slam_tpu.ltm import (
        LongTermObjectMap,
        extract_long_term_object_map,
        seed_pose_graph_from_ltm,
    )
    from obvi_slam_tpu.offline_data import OfflineProblemData
    from obvi_slam_tpu.pose_graph import PoseGraph
    from obvi_slam_tpu.runner import OfflineProblemRunner, RunnerHooks
    from obvi_slam_tpu.timing import TimerRegistry

    if args.logs_directory:
        os.makedirs(args.logs_directory, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        filename=(
            os.path.join(args.logs_directory, "obvi_slam_tpu.log")
            if args.logs_directory
            else None
        ),
    )
    logger = logging.getLogger("main")

    t_start = time.time()
    config = cfg.read_config(args.params_config_file)
    logger.info("Loaded config %s", config.config_version_id)

    intrinsics = oio.read_camera_intrinsics(args.intrinsics_file)
    extrinsics = oio.read_camera_extrinsics(args.extrinsics_file)
    cameras, img_hw = make_cameras(intrinsics, extrinsics)

    initial_poses = oio.read_poses_by_node_id(args.poses_by_node_id_file)
    bounding_boxes = (
        oio.read_bounding_boxes_by_node_id(args.bounding_boxes_by_node_id_file)
        if args.bounding_boxes_by_node_id_file
        else {}
    )
    tracks, init_positions = oio.read_orb_output_directory(
        args.low_level_feats_dir,
        max_frame_id=(
            config.limit_traj_eval_params.max_frame_id
            if config.limit_traj_eval_params.should_limit_trajectory_evaluation
            else None
        ),
    )
    logger.info(
        "Loaded %d poses, %d feature tracks, %d frames with detections",
        len(initial_poses),
        len(tracks),
        len(bounding_boxes),
    )

    data = OfflineProblemData(
        cameras=cameras,
        feature_tracks=tracks,
        feature_init_positions=init_positions,
        initial_poses=initial_poses,
        bounding_boxes=bounding_boxes,
    )

    prev_ltm = None
    pg = PoseGraph(cameras, shape_prior_map(config))
    if args.long_term_map_input:
        prev_ltm = LongTermObjectMap.load(args.long_term_map_input)
        seed_pose_graph_from_ltm(pg, prev_ltm)
        logger.info("Seeded %d LTM objects", len(prev_ltm.ellipsoids))

    bb_frontend = FeatureBasedBoundingBoxFrontEnd(
        pg,
        config.feature_based_bb_association_params,
        config.bounding_box_covariance_generator_params,
        config.geometric_similarity_scorer_params,
        img_heights_and_widths=img_hw,
        ltm_front_end_data=prev_ltm.front_end_data if prev_ltm else None,
    )
    hooks = RunnerHooks(
        bb_frontend=make_bb_frontend_hook(bb_frontend) if bounding_boxes else None
    )
    if args.detector_command:
        import shlex

        from obvi_slam_tpu.frontend.bb_retriever import (
            SubprocessDetectorQuerier,
            make_bb_frontend_hook_with_querier,
        )

        def _image_provider(frame_id, camera_id):
            path = os.path.join(
                args.images_dir, str(camera_id), f"{frame_id}.png"
            )
            if not os.path.exists(path):
                return None
            return path, img_hw.get(camera_id, (480, 640))

        querier = SubprocessDetectorQuerier(
            shlex.split(args.detector_command), _image_provider
        )
        hooks.bb_frontend = make_bb_frontend_hook_with_querier(
            bb_frontend, querier, sorted(intrinsics.keys())
        )
    if args.debug_images_output_directory:
        from obvi_slam_tpu.visualization import (
            SaveToFileVisualizer,
            SaveToFileVisualizerConfig,
        )

        # Both knobs come from feature_based_bb_association_params, matching
        # the reference's wiring (offline_object_visual_slam_main.cpp:823-832).
        fe_params = config.feature_based_bb_association_params
        save_to_file_viz = SaveToFileVisualizer(
            args.debug_images_output_directory,
            SaveToFileVisualizerConfig(
                feature_validity_window=fe_params.feature_validity_window,
                bounding_box_inflation_size=fe_params.bounding_box_inflation_size,
            ),
            img_heights_and_widths=img_hw,
        )
        hooks.visualization = lambda p, stage, frame_id: (
            save_to_file_viz.bounding_box_front_end_visualization(
                p, bb_frontend, frame_id
            )
            if stage == "AFTER_EACH_OPTIMIZATION"
            else None
        )
    if args.checkpoint_output_dir:
        os.makedirs(args.checkpoint_output_dir, exist_ok=True)

        def _write_checkpoint(p, label):
            # Reference file naming (object_and_reprojection_feature_pose_
            # graph_file_storage_io.h:17-24 + main.cpp:394-409,627-653).
            path = os.path.join(args.checkpoint_output_dir, label + ".json")
            with open(path, "w") as f:
                json.dump(p.get_state(), f)
            logger.info("Checkpoint written: %s", path)

        hooks.checkpoint = _write_checkpoint
    if args.logs_directory:
        from obvi_slam_tpu.optlog import IterationLoggerFactory

        IterationLoggerFactory.instance().set_logging_directory(
            args.logs_directory
        )
    hooks.object_merger = lambda p: apply_merges(
        p,
        merge_objects_by_center_proximity(
            p,
            config.post_session_object_merge_params.max_merge_distance,
            config.post_session_object_merge_params.x_y_only_merge,
        ),
        bb_frontend,
    )
    mesh = None
    if args.shard_devices > 1:
        from obvi_slam_tpu.parallel.sharding import make_mesh

        devices = jax.devices()
        if args.shard_devices > len(devices):
            raise SystemExit(
                f"--shard_devices {args.shard_devices} exceeds the "
                f"{len(devices)} available jax devices"
            )
        mesh = make_mesh(devices[: args.shard_devices])
    runner = OfflineProblemRunner(
        config,
        hooks,
        mesh=mesh,
        shard_local_ba=args.shard_local_ba,
        use_fused_solver={"auto": None, "on": True, "off": False}[args.fused_solver],
    )
    max_frame = max(initial_poses)
    vf = VisualFeatureFrontend(
        gba_checker=lambda f: runner._gba_checker(f, max_frame),
        reprojection_error_provider=lambda *a: config.visual_feature_params.reprojection_error_std_dev,
        min_parallax_pixel=config.visual_feature_params.min_visual_feature_parallax_pixel_requirement,
        min_parallax_transl=config.visual_feature_params.min_visual_feature_parallax_robot_transl_requirement,
        min_parallax_orient=config.visual_feature_params.min_visual_feature_parallax_robot_orient_requirement,
        enforce_pixel_parallax=config.visual_feature_params.enforce_min_pixel_parallax_requirement,
        enforce_pose_parallax=config.visual_feature_params.enforce_min_robot_pose_parallax_requirement,
        inlier_epipolar_err_thresh=config.visual_feature_params.inlier_epipolar_err_thresh,
        check_past_n_frames=config.visual_feature_params.check_past_n_frames_for_epipolar_err,
        enforce_epipolar=config.visual_feature_params.enforce_epipolar_error_requirement,
    )

    # Pre-compile the LTM marginal-covariance program OFF the critical path:
    # presize the session caps pools now (run_optimization re-seeds them
    # idempotently), build a zero-row dummy problem at the final session
    # signature, and compile it in a background thread while the frame loop
    # runs. Without this the extraction compiles cold AFTER the whole session,
    # on the session's critical path.
    ltm_warm_thread = None
    if args.long_term_map_output and jax.default_backend() != "cpu":
        import threading

        from obvi_slam_tpu.ltm import warm_marginal_covariance_program

        # Dummy problem built HERE (pg is mutated by the frame loop); only
        # the compile itself runs in the background. The whole warmup —
        # including the build — is best-effort: a failure must degrade to a
        # cold extraction, never kill the session.
        try:
            runner.presize_session_caps(data, max_frame)
            _compile_ltm = warm_marginal_covariance_program(
                pg, config, dict(runner.caps_pool("global"))
            )

            def _warm():
                try:
                    _compile_ltm()
                except Exception as e:  # never let warmup kill the run
                    logger.warning("LTM program warmup failed: %s", e)

            ltm_warm_thread = threading.Thread(target=_warm, daemon=True)
            ltm_warm_thread.start()
        except Exception as e:
            logger.warning("LTM warmup setup failed: %s", e)

    if args.profile_trace_dir:
        os.makedirs(args.profile_trace_dir, exist_ok=True)
        with jax.profiler.trace(args.profile_trace_dir):
            ok = runner.run_optimization(data, pg, visual_frontend=vf)
    else:
        ok = runner.run_optimization(data, pg, visual_frontend=vf)
    if not ok:
        logger.error("Optimization failed")
        return 1

    # Checkpoint the pose graph state (post-optimization; kept for the
    # resume CLI alongside the reference's four named checkpoint points,
    # which the runner hook emitted during the run).
    if args.checkpoint_output_dir:
        with open(
            os.path.join(args.checkpoint_output_dir, "pose_graph_state.json"), "w"
        ) as f:
            json.dump(pg.get_state(), f)

    # LTM extraction (with fallback to previous map on failure).
    if args.long_term_map_output:
        # Pre-LTM checkpoint (optimization_runner.h:499-506).
        if args.checkpoint_output_dir:
            with open(
                os.path.join(
                    args.checkpoint_output_dir, "long_term_map_checkpoint.json"
                ),
                "w",
            ) as f:
                json.dump(pg.get_state(), f)
        ltm = extract_long_term_object_map(
            pg, config, bb_frontend.get_front_end_obj_map_data(),
            prev_ltm=prev_ltm, caps=runner.caps_pool("global"),
        )
        if ltm is not None:
            ltm.save(args.long_term_map_output)
            logger.info(
                "Saved LTM with %d objects to %s",
                len(ltm.ellipsoids),
                args.long_term_map_output,
            )
        else:
            logger.error("LTM extraction failed with no fallback")

    if args.robot_poses_results_file:
        oio.write_robot_pose_results(args.robot_poses_results_file, pg)
    if args.bb_associations_out_file:
        oio.write_bb_association_results(args.bb_associations_out_file, pg)
    if args.ellipsoids_results_file:
        oio.write_ellipsoid_results(args.ellipsoids_results_file, pg)
    if args.visual_feature_results_file:
        oio.write_visual_feature_results(args.visual_feature_results_file, pg)
    if args.opt_log_file:
        with open(args.opt_log_file, "w") as f:
            f.write(
                "frame_id,global_ba,phase,attempt,num_poses,num_features,"
                "num_objects,initial_cost,final_cost,iterations,termination\n"
            )
            for r in runner.opt_log:
                f.write(
                    f"{r.frame_id},{int(r.global_ba)},{r.phase},{r.attempt},"
                    f"{r.num_poses},{r.num_features},{r.num_objects},"
                    f"{r.initial_cost},{r.final_cost},{r.iterations},{r.termination}\n"
                )
    if args.timing_report_file:
        with open(args.timing_report_file, "w") as f:
            json.dump(TimerRegistry.instance().summary(), f, indent=1)
    if args.logs_directory:
        from obvi_slam_tpu.optlog import IterationLoggerFactory

        # ceres_iterations_<type>.csv flush (main.cpp:1108).
        IterationLoggerFactory.instance().write_all()

    logger.info(
        "Session complete: %d frames, %d features, %d objects in %.1fs",
        len(pg.robot_poses),
        len(pg.features),
        len(pg.objects),
        time.time() - t_start,
    )
    print(
        f"frames={len(pg.robot_poses)} features={len(pg.features)} "
        f"objects={len(pg.objects)} wall={time.time() - t_start:.1f}s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
