"""chip_smoke.py on the CPU: its phases at tiny sizes on a passed-in CPU
device, its refusal to run without a GPU, and (on a machine with a card
only) the whole script."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

TINY_GBA = dict(n_poses=192, n_points=768, n_objects=8, obs_per_point=6,
                obs_per_object=8)


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def test_session_phase_on_cpu(cpu, tmp_path, monkeypatch):
    # The CLI would point jax's persistent cache at the repo; keep this
    # worker's compiles in memory.
    import obvi_slam_tpu.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda: None)
    rec = cs.phase_session(cpu, n_frames=12, work_dir=tmp_path, repeat=1,
                           card="cpu test")
    assert rec["n_poses_estimated"] == 12
    assert rec["ate_rmse_transl_m"] < cs.ATE_BOUND_M
    assert rec["n_ltm_objects"] == rec["n_gt_objects"] == 2
    assert rec["n_solves_decreasing"] > 0
    assert len(rec["walls_s"]) == 1


def test_global_ba_phase_on_cpu(cpu):
    out = cs.phase_global_ba(cpu, sizes=TINY_GBA, iters=3, band_solve=False,
                             card="cpu test")
    assert np.isfinite(out["cost"]) and out["cost"] < out["init_cost"]
    assert out["step_rel_err"] < cs.STEP_REL_ERR


def test_global_ba_phase_fails_on_a_broken_step(cpu, monkeypatch):
    """A phase that sees a wrong step raises instead of passing."""
    from obvi_slam_tpu import synthetic

    real = synthetic.step_pose_delta
    calls = []

    def skewed(problem, device, shard_mesh=None):
        dp, mcc = real(problem, device, shard_mesh)
        calls.append(dp.dtype)
        return (dp * 1.1 if len(calls) == 1 else dp), mcc

    monkeypatch.setattr(synthetic, "step_pose_delta", skewed)
    with pytest.raises(cs.SmokeFailure, match="f32 step error"):
        cs.phase_global_ba(cpu, sizes=TINY_GBA, iters=2, band_solve=False)


def _fake_session(n_frames, shift_m, n_decreasing):
    """A session record whose trajectory is the float64 reference moved by
    ``shift_m`` along every axis."""
    ref = cs.read_reference(n_frames)

    def run(work_dir, n_frames, seed, repeat, extra_argv):
        return {
            "walls_s": [1.0], "fps": [float(n_frames)],
            "n_poses_estimated": n_frames,
            "est_transl": {i: [v + shift_m for v in p] for i, p in ref.items()},
            "n_solves": 10, "n_solves_decreasing": n_decreasing,
            "ate_rmse_transl_m": 0.018, "n_ltm_objects": 2,
            "n_gt_objects": 2, "gt_to_ltm_m": [0.005, 0.007],
        }

    return run


@pytest.mark.parametrize(
    "shift_m, n_decreasing, error",
    [
        (0.0, 10, None),
        # The trajectory the solves start from is ~17 mm off the reference.
        (0.01, 10, "from the float64 reference"),
        (0.0, 0, "no solve took an accepted step"),
    ],
)
def test_session_phase_judges_the_solve(cpu, tmp_path, monkeypatch, shift_m,
                                        n_decreasing, error):
    monkeypatch.setattr(cs, "run_object_session",
                        _fake_session(12, shift_m, n_decreasing))
    if error is None:
        cs.phase_session(cpu, n_frames=12, work_dir=tmp_path, repeat=1)
    else:
        with pytest.raises(cs.SmokeFailure, match=error):
            cs.phase_session(cpu, n_frames=12, work_dir=tmp_path, repeat=1)


def test_session_phase_needs_a_reference(cpu, tmp_path):
    with pytest.raises(cs.SmokeFailure, match="no float64 reference"):
        cs.phase_session(cpu, n_frames=7, work_dir=tmp_path, repeat=1)


def test_replica_spread_on_four_devices():
    from obvi_slam_tpu import parallel as par

    mesh = par.make_mesh(jax.devices("cpu")[:4])
    x = par.replicate(jax.numpy.arange(8.0), mesh)
    sharded = jax.device_put(
        jax.numpy.arange(8.0),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
            mesh.axis_names[0])),
    )
    assert cs.replica_spread((x, sharded)) == 0.0
    # Copies that differ on one device (as atomics can make them on a GPU).
    skewed = jax.make_array_from_single_device_arrays(
        x.shape, x.sharding,
        [jax.device_put(jax.numpy.arange(8.0) + (d == mesh.devices.flat[2]), d)
         for d in mesh.devices.flat],
    )
    assert cs.replica_spread((skewed, sharded)) == 1.0
    with pytest.raises(cs.SmokeFailure, match="no replicated array"):
        cs.replica_spread(sharded)


def test_four_phase_on_cpu(monkeypatch):
    """The --four phase on four virtual CPU devices: 512 poses make 8 band
    tiles, so the sharded solve runs the 4-domain band solve."""
    import obvi_slam_tpu.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda: None)
    sizes = dict(n_poses=512, n_points=2048, n_objects=8, obs_per_point=4,
                 obs_per_object=6)
    cs.phase_four(jax.devices("cpu")[:4], sizes=sizes, iters=3,
                  session_frames=12, card="cpu test")


@pytest.mark.parametrize(
    "n_poses, layout, band_solve",
    [(64, False, False), (192, True, False), (512, True, True)],
)
def test_band_engagement(n_poses, layout, band_solve):
    from obvi_slam_tpu.solver import schur
    from obvi_slam_tpu.synthetic import synthetic_problem

    plan = synthetic_problem(
        n_poses=n_poses, n_points=4 * n_poses, n_objects=4, obs_per_point=4,
        obs_per_object=6, dtype=np.float32,
    )[4]
    assert schur.band_engagement(plan, n_poses) == (layout, band_solve)


def test_put_problem_keeps_huber_static(cpu):
    from obvi_slam_tpu.synthetic import put_problem, synthetic_problem

    p = synthetic_problem(n_poses=8, n_points=32, n_objects=2,
                          obs_per_point=3, dtype=np.float32)
    placed = put_problem(p, cpu)
    assert placed[-1] is p[-1]
    assert placed[0].poses.devices() == {cpu}


def test_refuses_cpu():
    with pytest.raises(SystemExit, match="not a GPU"):
        cs.require_gpu("chip_smoke")


def test_card_line_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert cs.card_line().startswith("nvidia-smi unavailable")


def test_alone_exits_nonzero_without_a_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_whole_script_on_card():
    """The full smoke run, in its own process, where a card is present."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA card here; run `python chip_smoke.py` on one")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
