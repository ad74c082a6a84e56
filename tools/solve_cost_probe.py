"""Probe: at presized session caps, what does ONE warm global-BA two-phase
solve cost on the device, vs build+sync? Duplicate-call methodology (r4).

Usage: timeout 900 python tools/solve_cost_probe.py [--frames 16]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tests"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=16)
    args = parser.parse_args(argv)

    import jax

    from obvi_slam_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    import test_tum_fixture as T
    from obvi_slam_tpu.frontend import VisualFeatureFrontend
    from obvi_slam_tpu.pose_graph import PoseGraph
    from obvi_slam_tpu.runner import OfflineProblemRunner

    data, gt_poses = T.load_tum_session(max_frames=args.frames)
    config = T.tum_config()
    runner = OfflineProblemRunner(config, dtype=np.float32)
    pg = PoseGraph(data.cameras)
    vf = VisualFeatureFrontend(
        gba_checker=lambda f: runner._gba_checker(f, data.max_frame_id()),
        reprojection_error_provider=lambda *a: config.visual_feature_params.reprojection_error_std_dev,
        inlier_epipolar_err_thresh=config.visual_feature_params.inlier_epipolar_err_thresh,
        check_past_n_frames=config.visual_feature_params.check_past_n_frames_for_epipolar_err,
    )
    # Run the session normally (warms every program + builds the pose graph),
    # logging per-window wall times.
    import obvi_slam_tpu.runner as runner_mod

    orig_iter = OfflineProblemRunner.run_optimization_iteration

    def timed_iter(self, data_, pg_, start, nfi, mfi, attempt_num=0):
        t = time.perf_counter()
        r = orig_iter(self, data_, pg_, start, nfi, mfi, attempt_num)
        gba = self._gba_checker(nfi, mfi)
        print(f"  window f={nfi} {'G' if gba else 'L'} {time.perf_counter()-t:.3f}s", flush=True)
        return r

    OfflineProblemRunner.run_optimization_iteration = timed_iter
    t0 = time.perf_counter()
    ok = runner.run_optimization(data, pg, visual_frontend=vf)
    OfflineProblemRunner.run_optimization_iteration = orig_iter
    assert ok
    print(f"session wall: {time.perf_counter() - t0:.1f}s")

    # Now: timed stages of ONE more global window, everything warm.
    scope = runner._scope(0, data.max_frame_id())
    it_params = config.final_ba_iteration_params

    for rep in range(3):
        t0 = time.perf_counter()
        problem = runner.build_problem_synced(pg, scope, "global")
        t1 = time.perf_counter()
        state, s1, s2 = runner._solve_two_phase_fused(problem, it_params, True)
        t2 = time.perf_counter()
        runner.write_back_synced("global", pg, problem, state)
        t3 = time.perf_counter()
        print(
            f"rep{rep}: build+sync {t1-t0:.3f}s  solve {t2-t1:.3f}s "
            f"(it {s1.num_iterations}+{s2.num_iterations})  writeback {t3-t2:.3f}s  "
            f"sync_bytes {runner.device_sync_for('global').last_bytes/1e3:.0f}KB"
        )

    # Pure duplicate solve (no rebuild): device execution + dispatch only.
    for rep in range(3):
        t0 = time.perf_counter()
        state, s1, s2 = runner._solve_two_phase_fused(problem, it_params, True)
        t1 = time.perf_counter()
        print(f"dup{rep}: solve {t1-t0:.3f}s (it {s1.num_iterations}+{s2.num_iterations})")

    # Host build alone (no sync) for attribution.
    from obvi_slam_tpu.solver.problem import build_problem

    for rep in range(2):
        t0 = time.perf_counter()
        build_problem(
            pg, scope,
            runner.config.object_visual_pose_graph_residual_params,
            dtype=np.float32, caps=runner.caps_pool("global"),
            to_device=False,
            row_registry=runner._row_registries.get("global"),
        )
        print(f"host_build{rep}: {time.perf_counter()-t0:.3f}s")


if __name__ == "__main__":
    main()
