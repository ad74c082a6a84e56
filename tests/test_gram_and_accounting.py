"""Unit tests: FLOP accounting model, the device peak table, and the
per-LM-iteration CSV logger."""

import numpy as np
import pytest


class TestFlopAccounting:
    def test_gram_dominates_and_scales(self):
        from obvi_slam_tpu import flops
        from obvi_slam_tpu.synthetic import synthetic_problem

        sizes = dict(n_points=256, n_objects=8, obs_per_point=4, obs_per_object=6)
        _, _, _, tables, plan, _, _, _ = synthetic_problem(
            n_poses=32, dtype=np.float32, **sizes
        )
        ph = flops.lm_iteration_flops(tables, plan, 32, 256, 8)
        assert set(ph) >= {
            "residual_jacobian_eval", "schur_z_build", "schur_gram",
            "reduced_cholesky_solve", "cost_evaluation",
        }
        assert all(v > 0 for v in ph.values())
        # Doubling the poses at least doubles the gram's work.
        _, _, _, tables2, plan2, _, _, _ = synthetic_problem(
            n_poses=64, dtype=np.float32, **sizes
        )
        ph2 = flops.lm_iteration_flops(tables2, plan2, 64, 256, 8)
        assert ph2["schur_gram"] >= 2 * ph["schur_gram"]

    def test_speed_of_light_table(self):
        from obvi_slam_tpu import flops

        kind = "NVIDIA H100 80GB HBM3"
        t = flops.speed_of_light_table(
            {"a": 4e9, "b": 1e6}, kind, measured_iter_s=1e-3
        )
        assert t["phases"]["a"]["sol_us"] == pytest.approx(4e9 / 67e12 * 1e6)
        assert t["total_flops_f32"] == pytest.approx(4e9 + 1e6)
        assert 0 < t["sol_fraction"] < 1
        assert t["measured_iter_us"] == pytest.approx(1000.0)

    def test_h100_peaks_have_a_source(self):
        from obvi_slam_tpu import flops

        p = flops.device_peaks("NVIDIA H100 80GB HBM3")
        assert (p["f32_flops"], p["tf32_flops"], p["bf16_flops"]) == (
            67e12, 495e12, 989e12
        )
        assert p["hbm_bytes_per_s"] == 3.35e12 and "data sheet" in p["source"]

    @pytest.mark.parametrize(
        "kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB", "default"]
    )
    def test_unknown_device_is_an_error(self, kind):
        from obvi_slam_tpu import flops

        with pytest.raises(ValueError, match="no published peaks"):
            flops.device_peaks(kind)
        with pytest.raises(ValueError):
            flops.speed_of_light_table({"a": 1.0}, kind)


class TestIterationLogger:
    def test_csv_schema_and_flush(self, tmp_path):
        from obvi_slam_tpu import optlog
        from obvi_slam_tpu.solver.lm import IterationRecord, LMSummary

        optlog.IterationLoggerFactory.reset()
        f = optlog.IterationLoggerFactory.instance()
        assert not f.enabled
        f.log_iterations("gba_phase_1", "5", LMSummary(), 10)  # no-op disabled
        f.set_logging_directory(str(tmp_path))
        s = LMSummary()
        s.iterations = [
            IterationRecord(0, 100.0, 5.0, 0.1, 1e4, True),
            IterationRecord(1, 95.0, 0.0, 0.0, 5e3, False),
        ]
        f.log_iterations(optlog.GBA_PHASE1_TYPE, "7", s, 20)
        f.write_all()
        path = tmp_path / "ceres_iterations_gba_phase_1.csv"
        lines = path.read_text().strip().splitlines()
        assert lines[0] == (
            "optimization_id,iteration_num,cost,cost_change,step_norm,"
            "step_norm_per_param,is_successful"
        )
        assert lines[1].split(",") == [
            "7", "0", "100.0", "5.0", "0.1", "0.005", "1"
        ]
        assert lines[2].endswith(",0")
        optlog.IterationLoggerFactory.reset()
