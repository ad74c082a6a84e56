"""Collective structure of the sharded global-BA step.

Compiles the factor-sharded banded step on the 8-device CPU mesh and pins
the collective pattern: the H/b accumulation AND the partial landmark grams
must combine with all-reduce — if the gram psum disappears, the factor
sharding is silently dying at the H/b boundary again and every gram runs
replicated on all devices (the r4 audit found exactly that: one 2.1 MB
tuple all-reduce and nothing else, capping multi-chip speedup at the
resjac share)."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from obvi_slam_tpu import parallel as par
from obvi_slam_tpu.parallel.audit import all_reduce_bytes, collect_collectives
from obvi_slam_tpu.synthetic import synthetic_problem


@pytest.fixture(scope="module")
def sharded_step_hlo():
    mesh = par.make_mesh()
    assert mesh.devices.size == 8
    p = synthetic_problem(
        n_poses=256, n_points=4096, n_objects=16,
        obs_per_point=6, obs_per_object=12, dtype=np.float32,
    )
    state, _, cams, tables, plan, free, weights, huber = p
    assert plan.pt_band_local_pose is not None  # banded production config
    step = par.sharded_compute_step(mesh)
    lowered = step.lower(
        par.replicate(state, mesh),
        par.replicate(cams, mesh),
        par.shard_tables(tables, mesh),
        par.shard_plan(plan, mesh),
        par.replicate(free, mesh),
        par.shard_weights(weights, mesh),
        jnp.asarray(1e4, jnp.float32),
        huber,
    )
    return lowered.compile().as_text()


class TestShardedCollectives:
    def test_gram_psum_present(self, sharded_step_hlo):
        by_op = collect_collectives(sharded_step_hlo)
        assert "all-reduce" in by_op, by_op
        shapes = by_op["all-reduce"]["shapes"]
        # Partial banded point group grams: a (G, 768, 768) operand.
        assert any(
            re.fullmatch(r"f32\[\d+,768,768\]", s) for s in shapes
        ), shapes
        # Partial object gram (c-major (6P, 6P)).
        assert any(
            re.fullmatch(r"f32\[1536,1536\]", s) for s in shapes
        ), shapes

    def test_all_reduce_op_count_pinned(self, sharded_step_hlo):
        """Exact op-count pin: a change here means the partitioning
        structure changed — update deliberately, with a PARITY note."""
        by_op = collect_collectives(sharded_step_hlo)
        counts = {k: v["count"] for k, v in by_op.items()}
        assert counts.get("all-reduce") == 4, counts

    def test_comm_volume_within_model(self, sharded_step_hlo):
        """Per-iteration all-reduce volume stays within the PARITY scaling
        model's envelope (~25 MB at the 256-pose shape; the dominant terms
        are the two gram psums at ~9.4 MB each)."""
        by_op = collect_collectives(sharded_step_hlo)
        ar = all_reduce_bytes(by_op)
        assert 4e6 < ar < 40e6, ar


class TestTrajectoryDomainDecomposition:
    """r5: the multi-host band-solve path (band_solve.dd_woodbury_band_solve
    — contiguous tile runs per device, interface Schur system + Woodbury C
    as the only cross-device combines). The replicated CR path all-gathers
    every level batch each iteration; the decomposed path must (a) match the single-device step numerically and (b) not
    reintroduce tile-batch all-gathers."""

    @pytest.fixture(scope="class")
    def band_problem(self, monkeypatch_class):
        # 512 poses -> 8 band tiles; on the 8-device mesh _dd_domains picks
        # 4 domains of 2 tiles. Band solve forced on below its 512-pose
        # auto threshold via the env-read module gate.
        from obvi_slam_tpu.solver import schur as schur_mod

        monkeypatch_class.setattr(schur_mod, "_BAND_SOLVE_MIN_POSES", 256)
        return synthetic_problem(
            n_poses=512, n_points=4096, n_objects=16,
            obs_per_point=6, obs_per_object=12, dtype=np.float32,
        )

    @pytest.fixture(scope="class")
    def monkeypatch_class(self):
        from _pytest.monkeypatch import MonkeyPatch

        mp = MonkeyPatch()
        yield mp
        mp.undo()

    @pytest.mark.slow
    def test_dd_sharded_step_matches_single_device(self, band_problem):
        from obvi_slam_tpu.solver import schur as schur_mod

        mesh = par.make_mesh()
        if mesh.devices.size < 8:
            pytest.skip("needs 8 virtual devices")
        state, _, cams, tables, plan, free, weights, huber = band_problem
        assert plan.pt_band_local_pose is not None
        assert plan.rel_band_local_pose is not None
        radius = jnp.asarray(1e4, jnp.float32)

        single = jax.jit(
            lambda s, c, t, p, f, w, r: schur_mod.compute_step(
                s, c, t, p, f, w, r, huber
            )
        )(state, cams, tables, plan, free, weights, radius)

        step = par.sharded_compute_step(mesh)
        sharded = step(
            par.replicate(state, mesh),
            par.replicate(cams, mesh),
            par.shard_tables(tables, mesh),
            par.shard_plan(plan, mesh),
            par.replicate(free, mesh),
            par.shard_weights(weights, mesh),
            radius,
            huber,
        )
        # Same numeric program up to the DD-vs-CR factorization's f32
        # summation-order differences.
        ref = np.asarray(single[0].poses, np.float64)
        got = np.asarray(sharded[0].poses, np.float64)
        rel = np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-30)
        assert rel < 5e-3, rel

    @pytest.mark.slow
    def test_dd_shard_map_collective_budget(self):
        """At the reference 1,024-pose scale (16 tiles, one 2-tile domain
        per device -> the explicit shard_map path), the step's all-gather
        volume must stay within the DD design budget: the interface Schur
        system ((h, 384, 384) x2), the interface multi-RHS ((h, 384,
        1+rz)), and small change — NOT the replicated CR path's tile-batch
        level all-gathers nor the partitioner's scatter-index gathers
        (which the deferred in-body assembly removed)."""
        from obvi_slam_tpu.parallel.audit import collect_collectives

        mesh = par.make_mesh()
        if mesh.devices.size < 8:
            pytest.skip("needs 8 virtual devices")
        p = synthetic_problem(
            n_poses=1024, n_points=8192, n_objects=64,
            obs_per_point=6, obs_per_object=12, dtype=np.float32,
        )
        state, _, cams, tables, plan, free, weights, huber = p
        assert plan.pt_band_local_pose is not None
        radius = jnp.asarray(1e4, jnp.float32)
        step = par.sharded_compute_step(mesh)
        # Lower under x64-OFF (production device semantics): the conftest's
        # x64 mode changes the partitioner's choices (verified with
        # tools/dd_hlo_probe.py both ways).
        with jax.enable_x64(False):
            hlo = step.lower(
                par.replicate(state, mesh),
                par.replicate(cams, mesh),
                par.shard_tables(tables, mesh),
                par.shard_plan(plan, mesh),
                par.replicate(free, mesh),
                par.shard_weights(weights, mesh),
                radius,
                huber,
            ).compile().as_text()
        by_op = collect_collectives(hlo)
        assert "all-gather" in by_op or "all_gather" in hlo
        ag = by_op.get("all-gather", {"shapes": []})["shapes"]
        total = 0
        big_f32 = []
        for s in ag:
            m = re.match(r"\w+\[([0-9,]*)\]", s)
            dims = [int(d) for d in m.group(1).split(",") if d] if m else []
            elems = int(np.prod(dims)) if dims else 0
            total += elems * 4
            # Nothing bigger than the (h, 384, 1+rz) interface multi-RHS.
            if s.startswith("f32") and elems * 4 > 8 * 384 * 512 * 4:
                big_f32.append(s)
        assert not big_f32, (big_f32, ag)
        assert total < 20e6, (total, ag)
