"""Object-pipeline end-to-end run: the FULL ObVi-SLAM workload — visual
frontend, bounding-box frontend (associate->init->merge + pending mini-BA),
joint BA with objects, two-phase outlier rejection, PGO-plus-ellipsoids on
global-BA frames, post-session merge loop, LTM extraction — via the main CLI
(cli/offline_object_visual_slam_main.py) called in this process, i.e. the
reference workload of ``offline_object_visual_slam_main.cpp:659-1106``.

Scene: the seeded synthetic object session (``synthetic.make_object_session``
— chairs + surface/background features + projected-ellipsoid bounding boxes)
with the in-repo config (``config.object_session_config``). Reports wall
seconds per repeat, ATE, and the LTM objects matched to ground truth.

Usage: python tools/bench_e2e_objects.py [--frames 30] [--repeat 2]
       [--platform cpu] [--f64] [--work_dir DIR] [--json_out PATH]
"""

import argparse
import csv
import importlib.util
import json
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _load_cli_main():
    spec = importlib.util.spec_from_file_location(
        "offline_object_visual_slam_main",
        REPO / "cli" / "offline_object_visual_slam_main.py",
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def run_object_session(
    work_dir, n_frames=30, seed=33, repeat=1, extra_argv=(), pgo=True
):
    """Export the synthetic session, run the main CLI ``repeat`` times in
    this process (run 1 cold, later runs with warm jit caches) and score the
    last run. Raises if any run returns non-zero."""
    import numpy as np

    from obvi_slam_tpu.config import object_session_config, write_config
    from obvi_slam_tpu.synthetic import export_session, make_object_session
    from obvi_slam_tpu.timing import TimerRegistry

    out = pathlib.Path(work_dir)
    data, gt_poses, gt_objects = make_object_session(n_frames=n_frames, seed=seed)
    export_session(data, gt_poses, out)
    write_config(object_session_config(pgo=pgo), str(out / "config.json"))
    res = out / "results"
    argv = [
        "--params_config_file", str(out / "config.json"),
        "--intrinsics_file", str(out / "intrinsics.csv"),
        "--extrinsics_file", str(out / "extrinsics.csv"),
        "--poses_by_node_id_file", str(out / "poses.csv"),
        "--bounding_boxes_by_node_id_file", str(out / "bounding_boxes.csv"),
        "--low_level_feats_dir", str(out / "orb_out"),
        "--long_term_map_output", str(res / "ltm.json"),
        "--robot_poses_results_file", str(res / "robot_poses.csv"),
        "--ellipsoids_results_file", str(res / "ellipsoids.csv"),
        "--visual_feature_results_file", str(res / "features.csv"),
        "--timing_report_file", str(res / "timing.json"),
        "--logs_directory", str(res / "logs"),
        "--opt_log_file", str(res / "opt_log.csv"),
    ] + list(extra_argv)
    cli_main = _load_cli_main()
    walls = []
    for _ in range(max(repeat, 1)):
        TimerRegistry.instance().reset()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        walls.append(time.perf_counter() - t0)
        if rc not in (0, None):
            raise RuntimeError(f"offline_object_visual_slam_main returned {rc}")

    # ATE vs ground truth (translation RMSE after node-id sync).
    est = {}
    with open(res / "robot_poses.csv") as f:
        for row in csv.DictReader(f):
            est[int(row["node_id"])] = np.array(
                [float(row["transl_x"]), float(row["transl_y"]),
                 float(row["transl_z"])]
            )
    errs = [
        np.sum((est[i] - gt_poses[i][:3]) ** 2)
        for i in range(len(gt_poses))
        if i in est
    ]
    ate = float(np.sqrt(np.mean(errs))) if errs else float("nan")
    with open(res / "ltm.json") as f:
        ltm_centers = np.array(
            [e[1][:3] for e in json.load(f)["ellipsoids"].values()]
        ).reshape(-1, 3)
    # Distance from each ground-truth object to its nearest LTM ellipsoid.
    gt_to_ltm = [
        float(np.min(np.linalg.norm(ltm_centers - g[:3], axis=1)))
        if len(ltm_centers) else float("inf")
        for g in gt_objects
    ]
    with open(res / "timing.json") as f:
        phases = json.load(f)
    with open(res / "opt_log.csv") as f:
        solves = list(csv.DictReader(f))
    return {
        "frames": n_frames,
        "walls_s": walls,
        "fps": [n_frames / w for w in walls],
        "ate_rmse_transl_m": ate,
        "n_poses_estimated": len(est),
        "est_transl": {i: est[i].tolist() for i in sorted(est)},
        "n_ltm_objects": int(len(ltm_centers)),
        "n_gt_objects": int(len(gt_objects)),
        "gt_to_ltm_m": gt_to_ltm,
        "n_solves": len(solves),
        # A solve that ends below its initial cost took an accepted step.
        "n_solves_decreasing": sum(
            float(r["final_cost"]) < float(r["initial_cost"]) for r in solves
        ),
        "phases": phases,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--seed", type=int, default=33)
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--platform", default="")
    parser.add_argument("--f64", action="store_true",
                        help="double-precision solves in the CLI")
    parser.add_argument("--json_out", default="")
    parser.add_argument("--work_dir", default="")
    args = parser.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    work = args.work_dir or tempfile.mkdtemp(prefix="e2e_obj_")
    record = run_object_session(work, args.frames, args.seed, args.repeat,
                                extra_argv=["--f64"] if args.f64 else [])
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ("phases", "est_transl")}))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
