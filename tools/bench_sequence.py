"""Multi-session LTM chain perf artifact (BASELINE config 5): three object
sessions over a SHARED scene chained through cli/sequence_executor.py — each
session's long-term map seeds the next (cross-session association instead of
object duplication), the reference's core contribution
(ltm_trajectory_sequence_executor.py:44-85,
long_term_map_factor_creator.h:222-340).

Reports per-session wall/fps, the LTM object count carried across sessions,
and the cross-session map consistency (matched-object center deviation
between consecutive session maps — the waypoint-consistency analog for
objects).

Usage: python tools/bench_sequence.py [--sessions 3] [--frames 20]
       [--platform cpu] [--json_out PATH]
"""

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sessions", type=int, default=3)
    parser.add_argument("--frames", type=int, default=20)
    parser.add_argument("--platform", default="")
    parser.add_argument("--json_out", default="")
    parser.add_argument("--work_dir", default="")
    args = parser.parse_args(argv)

    import numpy as np

    from obvi_slam_tpu.synthetic import export_session, make_object_session
    from test_cli import write_small_config

    out = pathlib.Path(args.work_dir or tempfile.mkdtemp(prefix="seq_bench_"))
    out.mkdir(parents=True, exist_ok=True)

    # Same GT scene (objects at fixed world positions), different per-session
    # trajectory noise: seeds chosen so make_object_session regenerates the
    # same two chairs (its object placement is deterministic in n_frames).
    seq = []
    for i in range(args.sessions):
        data, gt_poses, gt_objects = make_object_session(
            n_frames=args.frames, seed=60 + i
        )
        sdir = out / f"sess{i}"
        export_session(data, gt_poses, sdir)
        seq.append(
            {
                "name": f"session_{i}",
                "intrinsics_file": str(sdir / "intrinsics.csv"),
                "extrinsics_file": str(sdir / "extrinsics.csv"),
                "poses_by_node_id_file": str(sdir / "poses.csv"),
                "bounding_boxes_by_node_id_file": str(
                    sdir / "bounding_boxes.csv"
                ),
                "low_level_feats_dir": str(sdir / "orb_out"),
            }
        )
    write_small_config(out / "config.json")
    with open(out / "sequence.json", "w") as f:
        json.dump(seq, f)

    seq_out = out / "seq_out"
    cli_args = [
        sys.executable, str(REPO / "cli" / "sequence_executor.py"),
        "--sequence_file", str(out / "sequence.json"),
        "--output_dir", str(seq_out),
        "--params_config_file", str(out / "config.json"),
    ]
    if args.platform:
        cli_args += ["--platform", args.platform]
    t0 = time.perf_counter()
    r = subprocess.run(cli_args, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        print(r.stdout[-1500:], file=sys.stderr)
        print(r.stderr[-3000:], file=sys.stderr)
        raise SystemExit(r.returncode)

    sessions = []
    prev_centers = None
    consistency = []
    for i in range(args.sessions):
        sdir = seq_out / f"session_{i}"
        with open(sdir / "long_term_map.json") as f:
            ltm = json.load(f)
        with open(sdir / "timing.json") as f:
            timing = json.load(f)
        sess_wall = timing.get("offline_runner_online_portion", {}).get(
            "total_s"
        )
        centers = {
            k: np.asarray(v[1][:3]) for k, v in ltm["ellipsoids"].items()
        }
        if prev_centers is not None:
            # Cross-session map consistency: matched objects (same LTM id —
            # the seeding carries ids) must land at the same world position.
            devs = [
                float(np.linalg.norm(centers[k] - prev_centers[k]))
                for k in centers
                if k in prev_centers
            ]
            consistency.append(
                {
                    "n_matched": len(devs),
                    "max_center_dev_m": max(devs) if devs else None,
                    "mean_center_dev_m": (
                        float(np.mean(devs)) if devs else None
                    ),
                }
            )
        prev_centers = centers
        sessions.append(
            {
                "name": f"session_{i}",
                "n_ltm_objects": len(ltm["ellipsoids"]),
                "online_wall_s": sess_wall,
                "fps": (
                    args.frames / sess_wall if sess_wall else None
                ),
            }
        )

    record = {
        "sessions": sessions,
        "total_wall_s": wall,
        "frames_per_session": args.frames,
        "cross_session_consistency": consistency,
        "chained": all(
            s["n_ltm_objects"] == sessions[0]["n_ltm_objects"]
            for s in sessions
        ),
    }
    print(json.dumps(record))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
