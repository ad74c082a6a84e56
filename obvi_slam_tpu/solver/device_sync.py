"""Device-resident session tables via row-level diff-sync.

The reference rebuilds its Ceres problem per frame; mirroring that with a
full host->device upload of every factor table, Schur plan, and weight vector
per window makes the upload, not the solve, the per-window cost.

``DeviceSync`` keeps one device-resident copy of each named array tree for
the whole session. Each solve, the host builder (``build_problem(...,
to_device=False)``) produces numpy arrays; ``sync`` diffs them row-wise
against the last synced host copy and uploads ONLY the changed rows — and
packs every leaf's indices/values into a few flat per-dtype buffers, so one
sync is ONE jitted dispatch with a HANDFUL of host->device transfers instead
of ~2 small transfers per leaf, each paying the per-transfer latency).

Correctness is unconditional: device content always equals the host arrays
after sync, whatever changed (capacity growth, merges, weight swaps all
degrade to bigger uploads, never wrong values).

Jit-signature stability: every same-shape leaf goes through the delta path
(changed rows bucketed to a per-leaf monotone power-of-four); a leaf is
fully re-transferred only when its shape/dtype changes (capacity growth).
The applier is cached per packing layout, which changes O(log) times per
session, like the capacity pools.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import keystr, tree_flatten_with_path, tree_unflatten


@functools.lru_cache(maxsize=256)
def _applier(meta: tuple, dtype_order: tuple):
    """Jitted update applier for one packing layout.

    ``meta``: per-leaf tuples, in output order:
        ("reuse",)
        ("delta", dtype_idx, idx_off, bucket, val_off, row_elems, shape)
        ("full", dtype_idx, val_off, size, shape)
    ``dtype_order``: the value-buffer dtypes, e.g. ("float32", "int32",
    "bool"). The applier takes (delta_devs, idx_buf, val_bufs) and returns
    the new device leaves (delta leaves donated)."""

    @functools.partial(jax.jit, donate_argnums=(0,))
    def apply(delta_devs: list, idx_buf, val_bufs: list):
        out = []
        di = 0
        for m in meta:
            kind = m[0]
            if kind == "reuse":
                out.append(None)
                continue
            if kind == "delta":
                _, dt_i, idx_off, bucket, val_off, row_elems, shape = m
                idx = jax.lax.dynamic_slice(idx_buf, (idx_off,), (bucket,))
                vals = jax.lax.dynamic_slice(
                    val_bufs[dt_i], (val_off,), (bucket * row_elems,)
                ).reshape((bucket,) + shape[1:])
                d = delta_devs[di]
                di += 1
                out.append(d.at[idx].set(vals))
            else:  # full
                _, dt_i, val_off, size, shape = m
                vals = jax.lax.dynamic_slice(
                    val_bufs[dt_i], (val_off,), (size,)
                ).reshape(shape)
                out.append(vals)
        return out

    return apply


class DeviceSync:
    """Per-session device mirror of named array pytrees (one instance per
    caps pool / solve class)."""

    def __init__(self, device=None):
        self.device = device
        self._host: Dict[str, np.ndarray] = {}
        self._dev: Dict[str, jax.Array] = {}
        self._bucket: Dict[str, int] = {}
        self.total_bytes = 0
        self.last_bytes = 0
        self.n_syncs = 0
        # Per-sync detail of the most recent call: leaf -> (mode, bytes).
        self.last_detail: Dict[str, Tuple[str, int]] = {}

    # ------------------------------------------------------------------
    def _bucket_for(self, key: str, n: int) -> int:
        # Coarse (x16) monotone buckets: the applier layout includes every
        # leaf's bucket, so each growth step is a retrace + compile-cache
        # load — 16*16^k keeps that to <=4 steps per leaf and ~3-4 layouts per session
        # (x4 growth produced 9 layouts on a 16-frame TUM run). The padding
        # upload this buys is bounded by the clamp at the leaf's row count
        # in sync().
        b = self._bucket.get(key, 16)
        while b < n:
            b *= 16
        self._bucket[key] = b
        return b

    @staticmethod
    def _changed_rows(new: np.ndarray, old: np.ndarray) -> np.ndarray:
        cmp = new != old
        if cmp.ndim > 1:
            cmp = cmp.any(axis=tuple(range(1, cmp.ndim)))
        return np.flatnonzero(cmp)

    # ------------------------------------------------------------------
    def sync(self, name: str, tree):
        """Return ``tree`` with every array leaf replaced by its
        device-resident copy, after uploading only changed rows, packed
        into one idx buffer + one value buffer per dtype (one dispatch, a
        handful of transfers).

        Donation/invalidation contract: the applier DONATES the previous
        device leaves (``donate_argnums=(0,)``), so device arrays returned
        by an earlier ``sync`` of the same ``name`` are deleted by this
        call. Callers (hooks, loggers, debuggers) must not retain arrays
        from a prior synced Problem across windows — read them back with
        ``jax.device_get`` before the next sync if a host copy is needed."""
        leaves, treedef = tree_flatten_with_path(tree)
        self.last_detail = {}

        # Value buffers keyed by canonical dtype name.
        val_chunks: Dict[str, List[np.ndarray]] = {}
        val_sizes: Dict[str, int] = {}
        idx_chunks: List[np.ndarray] = []
        idx_size = 0
        meta: List[tuple] = []
        delta_devs: List[jax.Array] = []
        keys_out: List[str] = []
        hosts_out: List[np.ndarray] = []

        def dt_name(h):
            return str(h.dtype)

        for path, leaf in leaves:
            key = name + keystr(path)
            h = np.asarray(leaf)
            keys_out.append(key)
            hosts_out.append(h)
            cached = self._host.get(key)
            dev = self._dev.get(key)
            mode = "full"
            rows = None
            if (
                cached is not None
                and dev is not None
                and cached.shape == h.shape
                and cached.dtype == h.dtype
                and h.ndim >= 1
                and h.shape[0] > 0
            ):
                # ALWAYS the delta path for same-shape leaves — zero
                # changed rows included (bucket of idempotent row-0
                # writes). The applier's layout is static metadata; if the
                # per-leaf mode tracked the actual change pattern, nearly
                # every sync produced a fresh layout and therefore a fresh
                # compile.
                # With modes canonicalized, the layout is a function of the
                # monotone per-leaf buckets only and stabilizes after
                # warmup; the cost is a few no-op rows per quiet leaf.
                rows = self._changed_rows(h, cached)
                mode = "delta"

            dn = dt_name(h)
            if mode == "reuse":
                meta.append(("reuse",))
                self.last_detail[key] = ("reuse", 0)
            elif mode == "delta":
                # Clamp at the leaf's row count: a 4^k bucket above it would
                # upload more than the whole array (sliding-window pools
                # change every row). Still a stable function of the
                # monotone bucket + leaf shape.
                cap = min(self._bucket_for(key, len(rows)), h.shape[0])
                idx = np.zeros(cap, dtype=np.int32)
                idx[: len(rows)] = rows
                row_elems = int(np.prod(h.shape[1:], dtype=np.int64))
                v = np.empty((cap, row_elems), dtype=h.dtype)
                v[: len(rows)] = h[rows].reshape(len(rows), row_elems)
                v[len(rows) :] = h[0].reshape(row_elems)  # idempotent pad
                dti = val_chunks.setdefault(dn, [])
                off = val_sizes.get(dn, 0)
                dti.append(v.reshape(-1))
                val_sizes[dn] = off + v.size
                meta.append(
                    ("delta", dn, idx_size, cap, off, row_elems, h.shape)
                )
                idx_chunks.append(idx)
                idx_size += cap
                delta_devs.append(dev)
                nb = idx.nbytes + v.nbytes
                self.last_detail[key] = ("delta", nb)
            else:
                flat = np.ascontiguousarray(h).reshape(-1)
                dti = val_chunks.setdefault(dn, [])
                off = val_sizes.get(dn, 0)
                dti.append(flat)
                val_sizes[dn] = off + flat.size
                meta.append(("full", dn, off, int(flat.size), h.shape))
                self.last_detail[key] = ("full", h.nbytes)

        dtype_order = tuple(sorted(val_chunks))
        dt_index = {d: i for i, d in enumerate(dtype_order)}
        # Resolve dtype names to buffer indices in the static meta.
        meta_resolved = []
        for m in meta:
            if m[0] == "reuse":
                meta_resolved.append(("reuse",))
            elif m[0] == "delta":
                _, dn, idx_off, cap, off, row_elems, shape = m
                meta_resolved.append(
                    ("delta", dt_index[dn], idx_off, cap, off, row_elems,
                     tuple(shape))
                )
            else:
                _, dn, off, size, shape = m
                meta_resolved.append(
                    ("full", dt_index[dn], off, size, tuple(shape))
                )
        meta_resolved = tuple(meta_resolved)

        bytes_up = sum(b for _, b in self.last_detail.values())
        if idx_chunks or val_chunks:
            idx_buf = (
                np.concatenate(idx_chunks)
                if idx_chunks
                else np.zeros(1, np.int32)
            )
            val_bufs = [
                np.concatenate(val_chunks[d]) for d in dtype_order
            ]
            apply = _applier(meta_resolved, dtype_order)
            new_leaves = apply(delta_devs, idx_buf, val_bufs)
        else:
            new_leaves = [None] * len(meta_resolved)

        out_leaves = []
        for key, h, m, nl in zip(keys_out, hosts_out, meta_resolved, new_leaves):
            if m[0] == "reuse":
                out_leaves.append(self._dev[key])
            else:
                self._dev[key] = nl
                out_leaves.append(nl)
            self._host[key] = h

        self.last_bytes = bytes_up
        self.total_bytes += bytes_up
        self.n_syncs += 1
        return tree_unflatten(treedef, out_leaves)

    # ------------------------------------------------------------------
    def adopt(self, name: str, dev_tree, host_tree):
        """Update the cache for a subtree whose values are ALREADY on device
        (e.g. the solved state after write_back): the next sync's diff then
        sees only externally changed rows instead of every row the solver
        moved. ``name`` must include the subtree's position in the synced
        tree's key space (e.g. ``"global[0]"`` for element 0 of a synced
        tuple)."""
        dev_leaves, _ = tree_flatten_with_path(dev_tree)
        host_leaves, _ = tree_flatten_with_path(host_tree)
        for (path, d), (_, h) in zip(dev_leaves, host_leaves):
            key = name + keystr(path)
            self._host[key] = np.asarray(h)
            self._dev[key] = d
