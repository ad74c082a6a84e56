"""Fused on-device LM must match the host-loop LM on the same problems."""

import jax
import numpy as np
import pytest

import obvi_slam_tpu.solver as slv
from obvi_slam_tpu.synthetic import synthetic_problem


class TestFusedMatchesHostLoop:
    def test_same_convergence(self):
        state0, state_gt, cams, tables, plan, free, weights, huber = synthetic_problem(
            n_poses=24, n_points=128, n_objects=4, seed=5
        )
        params = slv.LMParams(max_num_iterations=50)
        s_host, sum_host = slv.solve(
            state0, cams, tables, plan, free, weights=weights, params=params, huber=huber
        )
        s_fused, sum_fused = slv.solve_fused(
            state0, cams, tables, plan, free, weights=weights, params=params, huber=huber,
            with_records=True,
        )
        # Identical per-iteration decisions -> identical trajectories.
        assert abs(sum_fused.final_cost - sum_host.final_cost) <= 1e-8 * max(
            1.0, sum_host.final_cost
        ), (sum_host.final_cost, sum_fused.final_cost)
        np.testing.assert_allclose(
            np.asarray(s_fused.poses), np.asarray(s_host.poses), atol=1e-8
        )
        assert sum_fused.termination == sum_host.termination
        assert sum_fused.num_iterations == sum_host.num_iterations
        # Records align with the host-loop log.
        for rf, rh in zip(sum_fused.iterations, sum_host.iterations):
            assert rf.accepted == rh.accepted
            np.testing.assert_allclose(rf.cost, rh.cost, rtol=1e-6)

    def test_nonmonotonic_mode(self):
        state0, _, cams, tables, plan, free, weights, huber = synthetic_problem(
            n_poses=16, n_points=64, n_objects=2, seed=8
        )
        params = slv.LMParams(max_num_iterations=40, allow_non_monotonic_steps=True)
        s_host, sum_host = slv.solve(
            state0, cams, tables, plan, free, weights=weights, params=params, huber=huber
        )
        s_fused, sum_fused = slv.solve_fused(
            state0, cams, tables, plan, free, weights=weights, params=params, huber=huber
        )
        assert abs(sum_fused.final_cost - sum_host.final_cost) <= 1e-6 * max(
            1.0, sum_host.final_cost
        )

    def test_zero_iterations(self):
        state0, _, cams, tables, plan, free, weights, huber = synthetic_problem(
            n_poses=8, n_points=32, n_objects=2
        )
        s, summary = slv.solve_fused(
            state0, cams, tables, plan, free, weights=weights,
            params=slv.LMParams(max_num_iterations=0), huber=huber,
        )
        assert summary.final_cost == summary.initial_cost
        np.testing.assert_array_equal(np.asarray(s.poses), np.asarray(state0.poses))


class TestMeshAgreedLoopExit:
    """The sharded loop's exit test is one vote over the mesh, so a device
    whose replicated copy says "stop" stops every device."""

    @staticmethod
    def _per_device(values, mesh):
        from jax.sharding import NamedSharding, PartitionSpec

        # A "replicated" array whose copies differ, as last-bit differences
        # between devices can make them.
        shards = [
            jax.device_put(np.asarray(v), d)
            for v, d in zip(values, mesh.devices.flat)
        ]
        return jax.make_array_from_single_device_arrays(
            (), NamedSharding(mesh, PartitionSpec()), shards
        )

    @pytest.mark.parametrize(
        "votes", [(True,) * 4, (True, True, False, True), (False,) * 4]
    )
    def test_every_device_gets_the_and(self, votes):
        from obvi_slam_tpu import parallel as par
        from obvi_slam_tpu.solver.lm_fused import mesh_all

        mesh = par.make_mesh(jax.devices()[:4])
        pred = self._per_device(votes, mesh)
        out = jax.jit(lambda p: mesh_all(p, mesh))(pred)
        got = [bool(s.data) for s in out.addressable_shards]
        assert got == [all(votes)] * 4
