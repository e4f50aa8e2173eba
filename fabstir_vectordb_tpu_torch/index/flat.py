"""Exact brute-force index over a VectorStore: one fused L2 top-k (K1).

The JAX package's ``index/flat.py`` for the euclidean metric: the recall
oracle for the approximate engines and the small-dataset fast path. Soft
deletes and filter masks are fused into selection.
"""
from __future__ import annotations

import numpy as np

from ..ops.topk import l2_topk
from ..utils.padding import bucket, fit_mask
from ..utils.transfer import to_device, to_host
from .store import VectorStore, serving_mirror


class FlatIndex:
    """Brute-force exact index over a VectorStore (euclidean)."""

    def __init__(self, store: VectorStore):
        self.store = store

    def search_rows(self, queries: np.ndarray, k: int,
                    extra_mask: np.ndarray | None = None):
        """Returns (true euclidean distances [B, k], rows [B, k]); rows are
        -1 beyond the matches."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        mirror = serving_mirror(self.store)
        n = int(mirror.x.shape[0])
        mask = self.store.active_mask(n)
        if extra_mask is not None:
            mask = mask & fit_mask(extra_mask, n)
        k_eff = min(bucket(k), n)
        dev = self.store.device
        d, rows = l2_topk(mirror.x, mirror.x_sq, to_device(mask, dev),
                          to_device(queries, dev), k_eff)
        d, rows = to_host(d, rows)
        d, rows = d[:, :k], rows[:, :k]
        d = np.sqrt(np.maximum(d, 0.0))
        if d.shape[1] < k:  # pad to requested k
            pad = k - d.shape[1]
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
            rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
        return d, rows


def recall_at_k(oracle: FlatIndex, approx_rows: np.ndarray,
                queries: np.ndarray, k: int) -> float:
    """Fraction of the exact top-k rows that an approximate search found."""
    _, exact = oracle.search_rows(np.atleast_2d(queries), k)
    hits = 0
    total = 0
    for b in range(exact.shape[0]):
        truth = set(int(r) for r in exact[b] if r >= 0)
        got = set(int(r) for r in approx_rows[b] if r >= 0)
        hits += len(truth & got)
        total += len(truth)
    return hits / total if total else 1.0

