#!/usr/bin/env python
"""Proof that the object-visual SLAM main path runs on an NVIDIA GPU.

    python chip_smoke.py          # one card: session, global_ba
    python chip_smoke.py --four   # four cards: sharded global BA + session

One process drives every phase. It first prints the card's name and power
limit, rebuilds the host library from the tracked sources, and refuses to run
unless JAX's first device is a GPU: there is no CPU fallback. Any failed phase
exits non-zero without the final line. On success the last line of standard
output is ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Phases (each is a function of the device and the sizes, so the CPU tests run
them at tiny sizes):

- ``session``: the seeded 60-frame synthetic object session through
  ``cli/offline_object_visual_slam_main.main`` in this process, twice (cold,
  then warm). Checks the return code, that the solves took accepted steps,
  the trajectory against the same session solved in float64 on the CPU, the
  ATE against ground truth, and that the long-term map holds the
  ground-truth objects.
- ``global_ba``: the reference-scale problem (UT-campus shape: 1,024 poses,
  16,384 points, 64 objects, f32). Checks that the band layout and the
  block-tridiagonal + Woodbury solve engage, prints the fused solver's
  ``memory_analysis()``, runs 10 fused LM iterations (finite, falling cost)
  and compares one f32 ``compute_step`` with the float64 step on the card.
- ``--four``: the 1,024-pose fused solve sharded over a four-card mesh and the
  session with ``--shard_devices 4``, each against the same work on card 0.
"""

import argparse
import csv
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "tools"))

from bench_e2e_objects import run_object_session  # noqa: E402

from obvi_slam_tpu import synthetic as syn  # noqa: E402
from obvi_slam_tpu.card import card_line, require_gpu  # noqa: E402

SESSION_FRAMES = 60
SESSION_SEED = 33
# The session's trajectory from the main CLI in float64 on the CPU, per frame
# count: ``python tools/bench_e2e_objects.py --frames N --platform cpu --f64
# --work_dir D`` writes it to D/results/robot_poses.csv.
SESSION_REFERENCE = REPO / "tests" / "data" / "object_session_seed33_{}f_f64.csv"
# RMS distance (m) of the session's trajectory from that reference. At 60
# frames the solves move the trajectory 16.5 mm RMS away from its initial
# guess, so a session whose solver does nothing misses by 16.5 mm; the same
# session in float32 on the CPU lands 0.03 mm from the reference.
REF_TRAJ_TOL_M = 4e-3
# Translational ATE bound (m). The float64 CPU session ends at 0.01827 m
# (the initial trajectory is 0.01770 m off: the solves move the poses but
# barely change their distance to ground truth, hence the check above).
ATE_BOUND_M = 0.03
# An LTM ellipsoid centre must lie this close to each ground-truth object,
# per session length: the float64 CPU session gives 4.5 and 7.3 mm at 60
# frames, 24 and 91 mm at 12 (fewer views of each chair).
LTM_MATCH_M = {60: 0.03, 12: 0.15}
# The f32 step against the f64 step; the same bound holds a sharded step and
# a sharded solve's final cost to card 0: sharding changes only the order of
# f32 sums.
STEP_REL_ERR = syn.F32_STEP_REL_ERR
# RMS distance (m) between the session trajectories on four cards and on
# card 0. Sharded global BA changes the order of f32 sums, which can move a
# two-phase outlier choice.
SHARD_TRAJ_TOL_M = 5e-3
GBA_ITERS = 10


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def build_native():
    subprocess.run(
        ["make", "-B", "-C", str(REPO / "obvi_slam_tpu" / "native")],
        check=True, capture_output=True,
    )


def _traj(transl_by_id):
    import numpy as np

    return np.array([transl_by_id[i] for i in sorted(transl_by_id)])


def _traj_rms(a, b):
    import numpy as np

    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def read_reference(n_frames):
    """The float64 CPU trajectory of the n_frames session: {frame: xyz}."""
    path = Path(str(SESSION_REFERENCE).format(n_frames))
    check(path.exists(), f"no float64 reference for {n_frames} frames: {path}")
    with open(path) as f:
        return {int(r["node_id"]): [float(r[k]) for k in
                                    ("transl_x", "transl_y", "transl_z")]
                for r in csv.DictReader(f)}


# ---------------------------------------------------------------- session


def phase_session(device, n_frames=SESSION_FRAMES, seed=SESSION_SEED,
                  work_dir=None, repeat=2, extra_argv=(), card=""):
    """The main CLI on the synthetic object session, ``repeat`` times."""
    import jax

    check(seed == SESSION_SEED, f"no float64 reference for seed {seed}")
    ref = read_reference(n_frames)
    ltm_bound = LTM_MATCH_M[n_frames]
    work_dir = work_dir or tempfile.mkdtemp(prefix="chip_smoke_session_")
    with jax.default_device(device):
        rec = run_object_session(
            work_dir, n_frames=n_frames, seed=seed, repeat=repeat,
            extra_argv=extra_argv,
        )
    for i, (w, fps) in enumerate(zip(rec["walls_s"], rec["fps"])):
        print(f"[session] {'cold' if i == 0 else 'warm'} run {i}: {w:.2f} s, "
              f"{fps:.3f} frames/s ({n_frames} frames; {card})", flush=True)
    check(rec["n_poses_estimated"] == n_frames,
          f"session estimated {rec['n_poses_estimated']} of {n_frames} poses")
    d_ref = _traj_rms(_traj(rec["est_transl"]), _traj(ref))
    print(f"[session] {rec['n_solves_decreasing']} of {rec['n_solves']} "
          f"solves lowered their cost; trajectory RMS distance from the "
          f"float64 CPU session {d_ref:.3e} m (bound {REF_TRAJ_TOL_M} m); "
          f"ATE {rec['ate_rmse_transl_m']:.5f} m (bound {ATE_BOUND_M} m); "
          f"LTM objects {rec['n_ltm_objects']}, ground-truth to nearest LTM "
          f"centre {rec['gt_to_ltm_m']} m (bound {ltm_bound} m)", flush=True)
    check(rec["n_solves_decreasing"] > 0, "no solve took an accepted step")
    check(d_ref < REF_TRAJ_TOL_M,
          f"trajectory {d_ref} m from the float64 reference")
    check(rec["ate_rmse_transl_m"] < ATE_BOUND_M,
          f"session ATE {rec['ate_rmse_transl_m']} m >= {ATE_BOUND_M} m")
    check(rec["n_ltm_objects"] == rec["n_gt_objects"]
          and max(rec["gt_to_ltm_m"]) < ltm_bound,
          f"LTM does not hold the ground-truth objects: "
          f"{rec['n_ltm_objects']} objects, {rec['gt_to_ltm_m']} m")
    return rec


# -------------------------------------------------------------- global BA


def compile_fused(problem, iters, shard_mesh=None):
    from obvi_slam_tpu.solver import lm_fused
    from obvi_slam_tpu.solver.lm import LMParams

    state0, _, cams, tables, plan, free, weights, huber = problem
    return lm_fused.compile_solve_fused(
        state0, cams, tables, plan, free, weights,
        LMParams.fixed_iterations(iters), huber, with_records=True,
        shard_mesh=shard_mesh,
    )


def run_fused(compiled, args):
    """Run a compiled fused solve: (final carry, initial cost, costs per
    iteration)."""
    import jax
    import numpy as np

    final, init_cost = compiled(*args)
    jax.block_until_ready(final)
    return final, float(init_cost), np.asarray(final.rec_cost)[: int(final.it)]


def phase_global_ba(device, sizes=syn.GLOBAL_BA_1024, iters=GBA_ITERS,
                    band_solve=True, card=""):
    """Fused global BA on ``device`` plus the f32-vs-f64 step check.
    ``band_solve``: whether the block-tridiagonal solve must engage."""
    import jax
    import numpy as np

    from obvi_slam_tpu.solver import schur

    n_poses = sizes["n_poses"]
    p32 = syn.put_problem(syn.synthetic_problem(**sizes, dtype=np.float32),
                          device)
    layout, solve = schur.band_engagement(p32[4], n_poses)
    print(f"[global_ba] {n_poses} poses, {sizes['n_points']} points, "
          f"{sizes['n_objects']} objects: reprojection rows "
          f"{int(p32[3].reproj.mask.sum())}, bbox rows "
          f"{int(p32[3].bbox.mask.sum())}; band layout {layout}, band solve "
          f"{solve}", flush=True)
    check(layout, "band layout did not engage")
    check(solve == band_solve, f"band solve {solve} at {n_poses} poses")

    t0 = time.perf_counter()
    compiled, args = compile_fused(p32, iters)
    t_compile = time.perf_counter() - t0
    print(f"[global_ba] fused solve compiled in {t_compile:.1f} s; "
          f"memory_analysis: {compiled.memory_analysis()}", flush=True)
    run_fused(compiled, args)  # warm
    t0 = time.perf_counter()
    final, init_cost, rec_cost = run_fused(compiled, args)
    dt = time.perf_counter() - t0
    cost = float(final.cost)
    print(f"[global_ba] {len(rec_cost)} fused LM iterations in {dt:.3f} s "
          f"({len(rec_cost) / dt:.2f} it/s; {card}); cost {init_cost:.6e} -> "
          f"{cost:.6e}; per-iteration {rec_cost.tolist()}", flush=True)
    check(len(rec_cost) == iters, f"ran {len(rec_cost)} of {iters} iterations")
    check(np.all(np.isfinite(rec_cost)) and np.isfinite(cost),
          "non-finite cost")
    check(cost < 0.5 * init_cost, f"cost did not fall: {init_cost} -> {cost}")
    check(np.all(np.diff(np.append(rec_cost, cost)) <= 0),
          "cost rose across an iteration")

    dp32, mcc32 = syn.step_pose_delta(p32, device)
    with jax.enable_x64(True):
        p64 = syn.synthetic_problem(**sizes, dtype=np.float64)
        dp64, mcc64 = syn.step_pose_delta(p64, device)
        dp64, mcc64 = np.asarray(dp64), float(mcc64)
    err = syn.rel_err(dp32, dp64)
    print(f"[global_ba] compute_step f32 vs f64 pose-delta relative error "
          f"{err:.3e} (bound {STEP_REL_ERR}); model cost change f32 "
          f"{float(mcc32):.6e}, f64 {mcc64:.6e}", flush=True)
    check(np.all(np.isfinite(np.asarray(dp32))), "non-finite f32 step")
    check(err < STEP_REL_ERR, f"f32 step error {err} >= {STEP_REL_ERR}")
    return {"cost": cost, "init_cost": init_cost, "step_rel_err": err,
            "iters_per_s": len(rec_cost) / dt}


# ------------------------------------------------------------- four cards


def _devices_of(tree):
    import jax

    return {
        len(x.sharding.device_set)
        for x in jax.tree_util.tree_leaves(tree)
        if hasattr(x, "sharding")
    }


def replica_spread(tree):
    """Largest |difference| between the devices' copies of the replicated
    arrays in ``tree``: 0.0 when every copy is the same bit for bit."""
    import jax
    import numpy as np

    spread = []
    for x in jax.tree_util.tree_leaves(tree):
        if x.sharding.is_fully_replicated:
            copies = [np.asarray(s.data, np.float64)
                      for s in x.addressable_shards]
            spread += [float(np.max(np.abs(c - copies[0]))) for c in copies]
    check(spread, "no replicated array")
    return max(spread)


def phase_four(devices, sizes=syn.GLOBAL_BA_1024, iters=GBA_ITERS,
               session_frames=SESSION_FRAMES, card=""):
    """The 1,024-pose fused solve sharded over ``devices`` and the session
    with ``--shard_devices``, each against the same work on devices[0]."""
    from obvi_slam_tpu import parallel as par
    from obvi_slam_tpu.solver import schur

    import numpy as np

    n = len(devices)
    mesh = par.make_mesh(devices)
    problem = syn.synthetic_problem(**sizes, dtype=np.float32)
    state0, gt, cams, tables, plan, free, weights, huber = problem
    n_tiles = plan.pt_band_local_pose.shape[0]
    domains = schur._dd_domains(mesh, n_tiles)
    print(f"[four] mesh of {n} devices, {n_tiles} band tiles, {domains} "
          f"domains", flush=True)
    check(domains == n, f"expected {n} domains, got {domains}")
    sharded = (
        par.replicate(state0, mesh), gt, par.replicate(cams, mesh),
        par.shard_tables(tables, mesh), par.shard_plan(plan, mesh),
        par.replicate(free, mesh), par.shard_weights(weights, mesh), huber,
    )
    spread = _devices_of((sharded[3], sharded[4], sharded[6]))
    check(spread == {n}, f"a table is not spread over the mesh: {spread}")
    check(not sharded[3].reproj.pose_idx.sharding.is_fully_replicated,
          "the reprojection table is replicated, not sharded")

    dp1, _ = syn.step_pose_delta(problem, devices[0])
    with mesh:
        dpn, mccn = syn.step_pose_delta(sharded, None, shard_mesh=mesh)
    err = syn.rel_err(dpn, dp1)
    print(f"[four] compute_step pose delta, {n} cards vs card 0: relative "
          f"error {err:.3e} (bound {STEP_REL_ERR}); largest difference "
          f"between the cards' copies of the replicated model cost change "
          f"{replica_spread(mccn):.3e}", flush=True)
    check(err < STEP_REL_ERR, f"sharded step error {err} >= {STEP_REL_ERR}")

    compiled1, args1 = compile_fused(syn.put_problem(problem, devices[0]),
                                     iters)
    final1, init1, _ = run_fused(compiled1, args1)
    cost1 = float(final1.cost)
    with mesh:
        compiled_n, args_n = compile_fused(sharded, iters, shard_mesh=mesh)
        run_fused(compiled_n, args_n)  # warm
        t0 = time.perf_counter()
        final_n, _, _ = run_fused(compiled_n, args_n)
        dt = time.perf_counter() - t0
    cost_n = float(final_n.cost)
    t0 = time.perf_counter()
    run_fused(compiled1, args1)
    dt1 = time.perf_counter() - t0
    rel_cost = abs(cost_n - cost1) / abs(cost1)
    print(f"[four] {iters} fused LM iterations: cost {init1:.6e} -> card 0 "
          f"{cost1:.6e} in {dt1:.3f} s, {n} cards {cost_n:.6e} in {dt:.3f} s "
          f"(relative difference {rel_cost:.3e}; {card}); largest difference "
          f"between the cards' copies of the replicated loop state (costs, "
          f"radius, points, objects) {replica_spread(final_n):.3e}",
          flush=True)
    check(np.isfinite(cost_n) and rel_cost < STEP_REL_ERR,
          f"sharded final cost {cost_n} vs card 0 {cost1}")

    one = phase_session(devices[0], n_frames=session_frames, repeat=1,
                        card=card)
    many = phase_session(devices[0], n_frames=session_frames, repeat=1,
                         extra_argv=["--shard_devices", str(n)], card=card)
    d_traj = _traj_rms(_traj(one["est_transl"]), _traj(many["est_transl"]))
    print(f"[four] session ATE card 0 {one['ate_rmse_transl_m']:.5f} m, "
          f"{n} cards {many['ate_rmse_transl_m']:.5f} m; trajectory RMS "
          f"difference {d_traj:.2e} m (bound {SHARD_TRAJ_TOL_M} m)", flush=True)
    check(d_traj < SHARD_TRAJ_TOL_M,
          f"sharded session trajectory differs from card 0 by {d_traj} m")


# ------------------------------------------------------------------- main


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card phase")
    args = parser.parse_args(argv)

    card = card_line()
    print(f"card: {card}", flush=True)
    build_native()
    dev = require_gpu("chip_smoke")

    import jax

    from obvi_slam_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    print(f"jax {jax.__version__}: {len(devices)} x {dev.device_kind} "
          f"({dev.platform})", flush=True)
    if args.four:
        if len(devices) < 4:
            raise SystemExit(f"--four needs 4 devices, found {len(devices)}")
        phases = [("four", lambda: phase_four(devices[:4], card=card))]
    else:
        phases = [
            ("session", lambda: phase_session(dev, card=card)),
            ("global_ba", lambda: phase_global_ba(dev, card=card)),
        ]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
