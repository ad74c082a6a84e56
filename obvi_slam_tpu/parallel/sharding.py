"""Multi-chip sharding of global bundle adjustment.

The reference is single-process (Ceres threads only, SURVEY.md §2.11); this is
the capability it lacks: global-BA scale-out across the devices of a host.

Design (the "annotate shardings, let XLA insert collectives" recipe):
  - the FACTOR axis is the data-parallel axis: every factor table, the
    factor-aligned plan rows, and the Schur cross-pair enumeration are sharded
    across devices on their leading (capacity) axis;
  - the state (poses/points/objects), landmark blocks, and the dense reduced
    camera system are replicated — XLA partitions the segment-sums and
    scatter-adds and inserts ``all-reduce`` (psum) collectives to combine each
    device's partial H_ll / H_oo / b / S contributions;
  - the dense solve of the reduced system runs replicated (pose counts are
    10^2-10^3 — its cost is small next to residual/Jacobian/outer-product
    work, which is what actually scales with trajectory length).

Because the sharding is expressed purely through ``jax.sharding`` annotations
on the existing ``solver.schur.compute_step``, the single-chip and multi-chip
paths are the same numeric program, and capacity bucketing (powers of two)
guarantees the factor axes divide any power-of-two device count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from obvi_slam_tpu.solver import schur as schur_mod

FACTOR_AXIS = "factors"


def make_mesh(devices=None, axis_name: str = FACTOR_AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def _put_global(x, sharding):
    """device_put that also works on a multi-host mesh: under jax.distributed
    each process holds the full host value (problems are built identically on
    every host), so each process materializes only its addressable shards."""
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def _shard_leading(tree, mesh, axis_name):
    """Shard every array's leading axis across the mesh (capacity axes are
    power-of-two bucketed, so they divide any power-of-two device count)."""
    n = mesh.devices.size
    sharding = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    def put(x):
        if x.ndim >= 1 and x.shape[0] % n == 0:
            return _put_global(x, sharding)
        return _put_global(x, repl)

    return jax.tree_util.tree_map(put, tree)


def replicate(tree, mesh):
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: _put_global(x, sharding), tree)


_replicate = replicate


def shard_tables(tables, mesh, axis_name=FACTOR_AXIS):
    return _shard_leading(tables, mesh, axis_name)


def shard_weights(weights, mesh, axis_name=FACTOR_AXIS):
    return _shard_leading(weights, mesh, axis_name)


def shard_plan(plan, mesh, axis_name=FACTOR_AXIS):
    """Factor-aligned and cross-pair arrays sharded; pair-level arrays
    replicated (gathered by sharded cross rows from any device)."""
    n = mesh.devices.size
    shard = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    def put(name, x):
        if x is None:  # optional plan fields (pt_band_local_pose)
            return None
        sharded_fields = {
            "rp_factor_pair",
            "bb_factor_pair",
            "pt_cross_a",
            "pt_cross_b",
            "pt_cross_mask",
            "ob_cross_a",
            "ob_cross_b",
            "ob_cross_mask",
        }
        if name in sharded_fields and x.shape[0] % n == 0:
            return _put_global(x, shard)
        return _put_global(x, repl)

    return type(plan)(**{k: put(k, v) for k, v in plan._asdict().items()})


def shard_problem(problem, mesh, axis_name=FACTOR_AXIS):
    """Reshard a built Problem for a mesh: tables/weights/plan on the factor
    axis, state/cams/free replicated. Returns a new Problem."""
    return problem.__class__(
        state=_replicate(problem.state, mesh),
        cams=_replicate(problem.cams, mesh),
        tables=shard_tables(problem.tables, mesh, axis_name),
        plan=shard_plan(problem.plan, mesh, axis_name),
        free=_replicate(problem.free, mesh),
        weights=shard_weights(problem.weights, mesh, axis_name),
        huber=problem.huber,
        aux=(
            _replicate(problem.aux, mesh)
            if problem.aux is not None
            else None
        ),
        pose_rows=problem.pose_rows,
        point_rows=problem.point_rows,
        obj_rows=problem.obj_rows,
        reproj_rows=problem.reproj_rows,
        bbox_rows=problem.bbox_rows,
        relpose_rows=problem.relpose_rows,
        shape_rows=problem.shape_rows,
        ltm_rows=problem.ltm_rows,
        scope=problem.scope,
        base_weights_np=problem.base_weights_np,
    )


def sharded_compute_step(mesh):
    """A jitted compute_step whose outputs are replicated; inputs carry their
    shardings from device_put (XLA partitions the body and inserts the
    all-reduces for the H/b/S accumulations)."""
    out_sharding = NamedSharding(mesh, P())

    @jax.jit
    def step(state, cams, tables, plan, free, weights, radius, huber):
        delta, model_change, grad_max = schur_mod.compute_step(
            state, cams, tables, plan, free, weights, radius, huber,
            shard_mesh=mesh,
        )
        constrain = lambda x: jax.lax.with_sharding_constraint(x, out_sharding)
        return (
            jax.tree_util.tree_map(constrain, delta),
            constrain(model_change),
            constrain(grad_max),
        )

    return step
