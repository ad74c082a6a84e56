"""Multi-host scale-out helpers.

The reference is single-process (SURVEY.md §2.11); this build scales the
global-BA factor set across hosts with ``jax.distributed`` + a global mesh:

  - within a host, the factor axis shards over all devices and XLA inserts
    the collectives for the H/b/S reductions (see parallel/sharding.py — the
    same annotations work unchanged on a multi-host mesh because
    jax.make_mesh returns global devices once jax.distributed is
    initialized);
  - across sessions (the 16-bag evaluation sequence), sessions are
    embarrassingly parallel: ``shard_sessions`` splits a sequence across
    processes so each host runs whole sessions locally (LTM chaining forces
    serialization only WITHIN a chain).

``initialize()`` wraps jax.distributed.initialize with env-based defaults so
the same CLI works single-process (no-op) and under a multi-host launcher
(COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID set by the scheduler).
"""

from __future__ import annotations

import os
from typing import List, Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Initialize jax.distributed from args or environment; no-op when
    single-process (no coordinator configured)."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return False
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", "0")
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(axis_name: str = "factors"):
    """Mesh over ALL devices (all hosts once distributed is initialized)."""
    from obvi_slam_tpu.parallel.sharding import make_mesh

    return make_mesh(jax.devices(), axis_name)


def shard_sessions(sessions: List[dict], process_id: Optional[int] = None,
                   num_processes: Optional[int] = None) -> List[dict]:
    """Partition an evaluation sequence's independent session chains across
    processes (round-robin by chain). Sessions that chain LTMs must share a
    'chain' key; chains stay on one host."""
    process_id = process_id if process_id is not None else jax.process_index()
    num_processes = num_processes or jax.process_count()
    chains = {}
    for i, s in enumerate(sessions):
        chains.setdefault(s.get("chain", i), []).append(s)
    mine = []
    for k, chain_key in enumerate(sorted(chains, key=str)):
        if k % num_processes == process_id:
            mine.extend(chains[chain_key])
    return mine
