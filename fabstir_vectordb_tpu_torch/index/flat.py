"""Exact brute-force index over a VectorStore: one fused masked top-k
(K1) by metric.

The JAX package's ``index/flat.py``: the small-dataset fast path, and
(streamed over host tiles) the recall oracle for the approximate engines.
Metrics as in ``ops.distance``: squared euclidean inside, returned as the
true distance; cosine (1 - cos) and negative dot returned as they are.
Soft deletes and filter masks are fused into selection. On a bf16 mirror
the query is rounded to bf16 in the product (the reference's bf16
compute), with the f32 norms of the f32 host rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.distance import check_metric, finalize_distance
from ..ops.topk import l2_topk
from ..utils import limits
from ..utils.padding import bucket, fit_mask
from ..utils.transfer import to_device, to_host
from .store import VectorStore


class FlatIndex:
    """Brute-force exact index over a VectorStore."""

    def __init__(self, store: VectorStore, metric: str = "euclidean"):
        self.store = store
        self.metric = check_metric(metric)

    def search_rows(self, queries: np.ndarray, k: int,
                    extra_mask: np.ndarray | None = None,
                    dtype: str | None = None):
        """Returns (distances [B, k], rows [B, k]); rows are -1 beyond the
        matches. Euclidean distances are true (not squared) distances.
        ``dtype`` pins the mirror's dtype for this call (default:
        FVDB_SERVING_DTYPE); the store holds one mirror, so pinning another
        dtype replaces the serving one."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        mirror = self.store.device(dtype or limits.serving_dtype())
        n = int(mirror.x.shape[0])
        mask = self.store.active_mask(n)
        if extra_mask is not None:
            mask = mask & fit_mask(extra_mask, n)
        k_eff = min(bucket(k), n)
        dev = self.store.torch_device
        d, rows = l2_topk(mirror.x, mirror.x_sq, to_device(mask, dev),
                          to_device(queries, dev), k_eff,
                          round_query=mirror.x.dtype == torch.bfloat16,
                          metric=self.metric)
        d, rows = to_host(d, rows)
        d = finalize_distance(d[:, :k], self.metric)
        rows = rows[:, :k]
        if d.shape[1] < k:  # pad to requested k
            pad = k - d.shape[1]
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
            rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
        return d, rows

    def search(self, query: np.ndarray, k: int, extra_mask=None):
        """Single-query search -> list of (id, distance)."""
        d, rows = self.search_rows(np.asarray(query)[None, :], k, extra_mask)
        out = []
        for dist, row in zip(d[0], rows[0]):
            if row < 0:
                break
            vid = self.store.id_of(int(row))
            if vid is not None:
                out.append((vid, float(dist)))
        return out


def recall_at_k(oracle: FlatIndex, approx_rows: np.ndarray,
                queries: np.ndarray, k: int) -> float:
    """Fraction of the exact top-k rows that an approximate search found.

    The exact f32 answer streams over host tiles (``TieredFlatSearcher``)
    instead of uploading an f32 mirror: the store holds one mirror, so an
    oracle upload would evict the serving state, hold a second copy of the
    corpus on the device beside it (25.8 GB at a 10M store's capacity), and
    break the reduced-rank regime's promise of no full-dim f32 mirror."""
    from .tiered import TieredFlatSearcher

    store = oracle.store
    count = store.count
    members = store.active_mask(count)
    _, exact = TieredFlatSearcher(store.data[:count], members,
                                  device=store.torch_device).search(
        np.atleast_2d(np.asarray(queries, np.float32)), k)
    hits = 0
    total = 0
    for b in range(exact.shape[0]):
        truth = set(int(r) for r in exact[b] if r >= 0)
        got = set(int(r) for r in approx_rows[b] if r >= 0)
        hits += len(truth & got)
        total += len(truth)
    return hits / total if total else 1.0
