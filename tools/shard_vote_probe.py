"""Does a sharded session hang without the fused loop's mesh-wide exit vote?

Runs the seeded synthetic object session through the main CLI, in this
process, with ``--shard_devices N``, optionally with one of two suspects
removed:

  --no_vote      every device leaves the fused LM loop on its own copy of the
                 exit test (``lm_fused.mesh_all`` replaced by the identity);
  --no_ltm_warm  no background thread compiling and running the LTM
                 marginal-covariance program during the session (its setup
                 is made to fail, which the CLI turns into a cold extraction).

A session that hangs ends when XLA aborts the process at its collective
rendezvous timeout; one that runs through prints ``completed`` with its wall
time and ATE.

Usage: python tools/shard_vote_probe.py [--devices 4] [--frames 60]
       [--no_vote] [--no_ltm_warm]
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_e2e_objects import run_object_session  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=4)
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--no_vote", action="store_true")
    parser.add_argument("--no_ltm_warm", action="store_true")
    args = parser.parse_args(argv)

    from obvi_slam_tpu import ltm
    from obvi_slam_tpu.compile_cache import enable_compile_cache
    from obvi_slam_tpu.solver import lm_fused

    enable_compile_cache()
    if args.no_vote:
        lm_fused.mesh_all = lambda pred, mesh: pred
    if args.no_ltm_warm:
        def no_warm(*a, **k):
            raise RuntimeError("LTM warm-up switched off")

        ltm.warm_marginal_covariance_program = no_warm
    print(f"sharded session: {args.devices} devices, {args.frames} frames, "
          f"vote {'off' if args.no_vote else 'on'}, LTM warm-up thread "
          f"{'off' if args.no_ltm_warm else 'on'}", flush=True)
    t0 = time.perf_counter()
    rec = run_object_session(
        tempfile.mkdtemp(prefix="shard_vote_probe_"), n_frames=args.frames,
        extra_argv=["--shard_devices", str(args.devices)],
    )
    print(f"completed in {time.perf_counter() - t0:.1f} s; ATE "
          f"{rec['ate_rmse_transl_m']:.5f} m", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
