"""Tests for the banded Schur point-gram (schur._band_layout + the banded
_slot_gram path): plan construction, fallbacks, and band-vs-dense step
equality."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from obvi_slam_tpu.solver import schur as sm
from obvi_slam_tpu.synthetic import synthetic_problem


class TestBandLayout:
    def test_synthetic_problem_engages_band(self):
        p = synthetic_problem(
            n_poses=256, n_points=512, n_objects=4, obs_per_point=6,
            obs_per_object=6, dtype=np.float64,
        )
        plan = p[4]
        assert plan.pt_band_local_pose is not None
        n_group, lg, c = plan.pt_band_local_pose.shape
        assert n_group == 4  # ceil(256 / 64)
        assert plan.pt_slot_gather.shape[0] == n_group * lg
        # Local poses within the 2-tile window.
        local = np.asarray(plan.pt_band_local_pose).reshape(-1, c)
        mask = np.asarray(plan.pt_slot_mask)
        assert local[mask].max() < 128
        assert local[mask].min() >= 0
        # Every live slot's global pose = group base + local pose.
        pose = np.asarray(plan.pt_slot_pose)
        rows = np.arange(pose.shape[0])
        base = (rows // lg) * sm._BAND_TP
        np.testing.assert_array_equal(
            pose[mask], (local + base[:, None])[mask]
        )

    def test_small_problem_no_band(self):
        plan = sm.build_schur_plan_host(
            [0, 1, 2], [0, 0, 0], 8, [], [], 4, n_pose=64
        )
        assert plan.pt_band_local_pose is None

    def test_wide_span_falls_back(self):
        """A loop-closure-style re-observation (pose 0 and pose 200) must
        disable banding."""
        plan = sm.build_schur_plan_host(
            [0, 200, 10, 11], [0, 0, 1, 1], 8, [], [], 4, n_pose=256
        )
        assert plan.pt_band_local_pose is None
        # And the same spans without the wide pair band fine.
        plan2 = sm.build_schur_plan_host(
            [0, 1, 10, 11], [0, 0, 1, 1], 8, [], [], 4, n_pose=256
        )
        assert plan2.pt_band_local_pose is not None

    def test_no_n_pose_no_band(self):
        plan = sm.build_schur_plan_host([0, 1], [0, 0], 4, [], [], 4)
        assert plan.pt_band_local_pose is None


class TestRelBandLayout:
    def test_synthetic_engages_rel_band(self):
        p = synthetic_problem(
            n_poses=256, n_points=256, n_objects=4, obs_per_point=6,
            obs_per_object=6, dtype=np.float64,
        )
        plan = p[4]
        assert plan.rel_band_local_pose is not None
        assert plan.rel_band_gather.shape[1] == 2

    def test_wide_relpose_falls_back(self):
        """PGO-style loop-closure relpose factors (pose 0 <-> 200) must
        disable the relpose band, independently of the point band."""
        plan = sm.build_schur_plan_host(
            [0, 1], [0, 0], 4, [], [], 4, n_pose=256,
            rl_before=[0, 10], rl_after=[200, 11], rl_cap=4,
        )
        assert plan.rel_band_local_pose is None
        assert plan.pt_band_local_pose is not None

    def test_rel_band_step_matches_dense(self):
        state, _, cams, tables, plan, free, weights, huber = (
            synthetic_problem(
                n_poses=256, n_points=384, n_objects=4, obs_per_point=6,
                obs_per_object=6, dtype=np.float64,
            )
        )
        assert plan.rel_band_local_pose is not None
        radius = jnp.asarray(1e4, np.float64)
        d_band, mcc_band, _ = sm.compute_step(
            state, cams, tables, plan, free, weights, radius, huber,
            dense_schur=True,
        )
        plan_dense = plan._replace(
            rel_band_gather=None, rel_band_mask=None,
            rel_band_local_pose=None,
        )
        d_ref, mcc_ref, _ = sm.compute_step(
            state, cams, tables, plan_dense, free, weights, radius, huber,
            dense_schur=True,
        )
        rel = np.linalg.norm(
            np.asarray(d_band.poses) - np.asarray(d_ref.poses)
        ) / (np.linalg.norm(np.asarray(d_ref.poses)) + 1e-30)
        assert rel < 1e-10, rel
        assert np.isclose(float(mcc_band), float(mcc_ref), rtol=1e-10)


class TestBandStepEquality:
    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_band_matches_dense(self, dtype):
        state, _, cams, tables, plan, free, weights, huber = (
            synthetic_problem(
                n_poses=256, n_points=768, n_objects=8, obs_per_point=6,
                obs_per_object=8, dtype=dtype,
            )
        )
        assert plan.pt_band_local_pose is not None
        radius = jnp.asarray(1e4, dtype)
        d_band, mcc_band, g_band = sm.compute_step(
            state, cams, tables, plan, free, weights, radius, huber,
            dense_schur=True,
        )
        plan_dense = plan._replace(pt_band_local_pose=None)
        d_ref, mcc_ref, g_ref = sm.compute_step(
            state, cams, tables, plan_dense, free, weights, radius, huber,
            dense_schur=True,
        )
        # f32: band and dense accumulate in different orders; the damped
        # normal equations amplify the roundoff difference (same mechanism
        # as the 5e-3 f32-vs-f64 budget in test_f32_precision).
        tol = 1e-10 if dtype == np.float64 else 2e-3
        for a, b in [
            (d_band.poses, d_ref.poses),
            (d_band.points, d_ref.points),
            (d_band.objects, d_ref.objects),
        ]:
            rel = np.linalg.norm(np.asarray(a) - np.asarray(b)) / (
                np.linalg.norm(np.asarray(b)) + 1e-30
            )
            assert rel < tol, rel
        assert np.isclose(float(mcc_band), float(mcc_ref), rtol=tol)
        assert np.isclose(float(g_band), float(g_ref), rtol=1e-6)


class TestBandSharded:
    """The production multi-chip configuration — global BA at >=192 poses
    with banded grams + factor-axis sharding — executed on a CPU mesh
    (sharded tests below the band threshold leave banded x sharded
    untested)."""

    def _problem(self):
        return synthetic_problem(
            n_poses=192, n_points=384, n_objects=8, obs_per_point=4,
            obs_per_object=6, dtype=np.float64,
        )

    def test_sharded_banded_step_matches_single_device(self):
        from obvi_slam_tpu import parallel as par

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        state, _, cams, tables, plan, free, weights, huber = self._problem()
        assert plan.pt_band_local_pose is not None  # band engaged
        radius = jnp.asarray(1e4, np.float64)
        d_ref, mcc_ref, g_ref = sm.compute_step(
            state, cams, tables, plan, free, weights, radius, huber,
            dense_schur=True,
        )

        mesh = par.make_mesh(jax.devices()[:8])
        tables_s = par.shard_tables(tables, mesh)
        plan_s = par.shard_plan(plan, mesh)
        weights_s = par.shard_weights(weights, mesh)
        state_s = par.replicate(state, mesh)
        cams_s = par.replicate(cams, mesh)
        free_s = par.replicate(free, mesh)
        assert plan_s.pt_band_local_pose is not None
        step = par.sharded_compute_step(mesh)
        with mesh:
            d_sh, mcc_sh, g_sh = step(
                state_s, cams_s, tables_s, plan_s, free_s, weights_s,
                radius, huber,
            )
        # Same numeric program, partitioned: differences only from psum
        # reduction-order variation in f64.
        for a, b in [
            (d_sh.poses, d_ref.poses),
            (d_sh.points, d_ref.points),
            (d_sh.objects, d_ref.objects),
        ]:
            rel = np.linalg.norm(np.asarray(a) - np.asarray(b)) / (
                np.linalg.norm(np.asarray(b)) + 1e-30
            )
            assert rel < 1e-8, rel
        assert np.isclose(float(mcc_sh), float(mcc_ref), rtol=1e-8)
        assert np.isclose(float(g_sh), float(g_ref), rtol=1e-8)

    def test_sharded_banded_fused_solve_matches_single_device(self):
        from obvi_slam_tpu import parallel as par
        from obvi_slam_tpu.solver import lm_fused
        from obvi_slam_tpu.solver.lm import LMParams

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        state, _, cams, tables, plan, free, weights, huber = self._problem()
        assert plan.pt_band_local_pose is not None
        params = LMParams(max_num_iterations=3)
        ref_state, ref_summary = lm_fused.solve_fused(
            state, cams, tables, plan, free, weights=weights, params=params,
            huber=huber,
        )

        mesh = par.make_mesh(jax.devices()[:8])
        with mesh:
            sh_state, sh_summary = lm_fused.solve_fused(
                par.replicate(state, mesh),
                par.replicate(cams, mesh),
                par.shard_tables(tables, mesh),
                par.shard_plan(plan, mesh),
                par.replicate(free, mesh),
                weights=par.shard_weights(weights, mesh),
                params=params,
                huber=huber,
            )
        assert sh_summary.num_iterations == ref_summary.num_iterations
        assert np.isclose(
            sh_summary.final_cost, ref_summary.final_cost, rtol=1e-9
        )
        rel = np.linalg.norm(
            np.asarray(sh_state.poses) - np.asarray(ref_state.poses)
        ) / (np.linalg.norm(np.asarray(ref_state.poses)) + 1e-30)
        assert rel < 1e-8, rel
