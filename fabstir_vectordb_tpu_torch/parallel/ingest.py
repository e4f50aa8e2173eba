"""Mesh-parallel ingest: the multi-shard index BUILD (the JAX package's
``parallel/ingest.py``).

The exact-candidate scan of HNSW linking runs row-sharded over a mesh: each
shard scans only its rows for each link batch (K1), the partial top-ef
pools meet in the shard merge (the same collective shape as sharded
serving), and the host links from the merged pool with the SAME linker as
the single-device path. IVF ingest shards the same way: training is
``sharded_kmeans_train`` and bulk cluster assignment runs K6's assignment
on each shard's rows.

Per-shard selection is exact, so the merged pool, and with it the built
graph, does not depend on the mesh size (provided ef <= rows per shard):
1, 2 or 8 shards build the same adjacency. ``select="approx"`` swaps each
shard's top-ef for K9's pool and K2's exact re-score.
"""
from __future__ import annotations

import numpy as np
import torch

from ..index.hnsw import set_member_rows, set_member_rows_plain
from ..ops.kmeans import assign_clusters
from ..utils.padding import bucket, round_up
from ..utils.transfer import to_device, to_host
from .sharded import _on, sharded_flat_search

__all__ = ["ShardedBuilder", "sharded_assign_clusters"]


# the sharded build's member mask takes the pipelined build's scatter,
# counted apart as K15's set-rows
_set_rows_true_plain = set_member_rows_plain


def _set_rows_true(mask, rows):
    """mask[rows] = True in place, on the (sharded) member mask [N] bool;
    rows [n] int32 outside [0, N) are ignored. Returns mask."""
    return set_member_rows(mask, rows, counter="set_rows")


def sharded_assign_clusters(mesh, axis: str = "data"):
    """Builds a data-parallel nearest-centroid assignment.

    Returns fn(x [N, D], centroids [C, D]) -> assignments [N] int32 on the
    mesh's device: each shard assigns only its own rows (K6's assignment),
    no collective but the gather of the result. A host (numpy) x whose N
    does not divide by the axis size is padded; a device tensor must
    divide."""
    s = mesh.shape[axis]

    def f(x, centroids):
        x = _on(mesh, x, torch.float32)
        cents = _on(mesh, centroids, torch.float32)
        sl = mesh.shard_slices(x.shape[0], axis)
        parts = [assign_clusters(x[sl[i]], cents)[0]
                 for i in mesh.shards(axis)]
        return mesh.all_gather(parts, axis).reshape(-1)

    def run(x, centroids):
        n = int(x.shape[0])
        pad = round_up(n, s) - n
        if pad == 0:
            return f(x, centroids)
        if not isinstance(x, np.ndarray):
            raise ValueError(
                f"row count {n} must divide by the {s}-shard mesh for "
                "device tensors; pass a host array to get padded "
                "automatically")
        xp = np.concatenate(
            [x, np.zeros((pad, x.shape[1]), x.dtype)], axis=0)
        return f(xp, centroids)[:n]

    return run


class ShardedBuilder:
    """Drives a mesh-parallel HNSW build into an existing ``HNSWIndex``.

    The index's host state (adjacency, levels, entry point) stays the
    single source of truth; only the candidate search runs on the mesh. The
    corpus goes to the mesh's device once per store version and capacity,
    and the member mask is updated a batch at a time by the set-rows
    kernel, never uploaded again.

    Usage::

        builder = ShardedBuilder(hnsw, mesh)
        builder.insert_rows(rows)          # same contract as hnsw.insert_rows
    """

    def __init__(self, hnsw, mesh, axis: str = "data",
                 select: str = "exact"):
        self.hnsw = hnsw
        self.mesh = mesh
        self.axis = axis
        ef = hnsw.config.ef_construction
        self._search = sharded_flat_search(
            mesh, axis, select=select, oversample=2 * ef)
        self._n_dev = mesh.shape[axis]
        self._x = None
        self._x_sq = None
        self._mask = None
        self._n_pad = 0
        self._corpus_key = None  # (store version, capacity) of the upload

    # ------------------------------------------------------------- corpus
    def _host_mask(self) -> np.ndarray:
        mask = np.zeros(self._n_pad, bool)
        m = self.hnsw._search_mask()
        mask[: len(m)] = m
        return mask

    def _upload_corpus(self) -> None:
        """The store's rows on the mesh's device (again whenever the
        store's version changes: rows added between builds must not be
        scanned as the zeros their slots held at the last upload)."""
        store = self.hnsw.store
        n_pad = round_up(store.capacity, self._n_dev)
        x = store.data
        if n_pad > x.shape[0]:
            x = np.concatenate(
                [x, np.zeros((n_pad - x.shape[0], x.shape[1]), x.dtype)])
        self._x = self._x_sq = self._mask = None  # free the old upload
        dev = self.mesh.device
        self._x = to_device(np.asarray(x, np.float32), dev)
        self._x_sq = to_device(
            np.einsum("nd,nd->n", x, x).astype(np.float32), dev)
        self._n_pad = n_pad
        self._mask = to_device(self._host_mask(), dev)
        self._corpus_key = (store._version, store.capacity)

    # -------------------------------------------------------------- build
    def insert_rows(self, rows: np.ndarray, sub_batch: int = 1024) -> None:
        """Insert store rows into the graph, candidate search on the mesh.

        Bootstrap (graph smaller than ``bootstrap_threshold``) delegates to
        the index's own ``insert_rows``, as the single-device builder, then
        post-bootstrap batches run the sharded candidate search."""
        hnsw = self.hnsw
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        hnsw._ensure_capacity()
        cfg = hnsw.config

        boot = max(0, cfg.bootstrap_threshold + 1 - hnsw.num_nodes)
        if boot > 0:
            head, rows = rows[:boot], rows[boot:]
            hnsw.insert_rows(head)
            if rows.size == 0:
                return

        store = hnsw.store
        if (self._x is None
                or self._corpus_key != (store._version, store.capacity)):
            # a version change covers rows added or overwritten since the
            # last build: scanning their slots as the stale upload's zeros
            # would link by distance to the origin
            self._upload_corpus()
        else:
            # same corpus bytes: reconcile the device mask with the host
            # membership (rows linked by the bootstrap path above)
            self._mask = to_device(self._host_mask(), self.mesh.device)

        ef = cfg.ef_construction
        dev = self.mesh.device
        for lo in range(0, rows.size, sub_batch):
            batch = rows[lo: lo + sub_batch]
            levels_new = np.array(
                [hnsw._sample_level() for _ in batch], np.int32)
            n_real = batch.size
            b_pad = bucket(n_real, minimum=1)
            padded = batch
            if b_pad > n_real:
                padded = np.concatenate(
                    [batch, np.repeat(batch[:1], b_pad - n_real)])
            q = to_device(hnsw.store.data[padded], dev)
            vals, ids = self._search(self._x, self._x_sq, self._mask, q, ef)
            vals, ids = to_host(vals, ids)
            vals = vals[:n_real]
            ids = ids[:n_real].astype(np.int64)
            kept = hnsw._kept_host(ids, vals, cfg.m0)
            hnsw._link_batch(
                batch, levels_new,
                {"mode": "exact", "ids": ids, "dists": vals, "kept": kept},
            )
            hnsw._version += 1
            idx = np.empty(b_pad, np.int32)
            idx[:n_real] = batch
            idx[n_real:] = batch[0]  # idempotent pad
            self._mask = _set_rows_true(self._mask, to_device(idx, dev))
