"""Hybrid index: HNSW for recent vectors + IVF for historical, time-routed.

The JAX package's ``index/hybrid.py`` for the flat serving regime: one
shared VectorStore with per-engine membership; inserts route by age (all to
HNSW until IVF is trained); searches with the default per-engine k run the
fused flat kernel; migration moves aged-out rows from HNSW to IVF; soft
deletes, vacuum and stats as there. Per-engine ``recent_k`` /
``historical_k`` need HNSW and IVF search, which are not ported yet, and
raise ``NotImplementedError``; so does lazy loading (persistence).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.metadata_filter import MetadataFilter
from ..utils.padding import bucket, fit_mask
from ..utils.transfer import to_host
from .flat import FlatIndex
from .hnsw import HNSWConfig, HNSWIndex
from .ivf import IVFConfig, IVFIndex
from .store import UnknownIdError, VectorStore

SECONDS_PER_DAY = 86_400.0


def _default_hybrid_ivf() -> IVFConfig:
    # the reference's hybrid IVF: 3 clusters / n_probe 2, so tiny data trains
    return IVFConfig(n_clusters=3, n_probe=2)


@dataclass
class HybridConfig:
    recent_threshold_secs: float = 7 * SECONDS_PER_DAY
    migration_batch_size: int = 100
    auto_migrate: bool = True
    min_ivf_training_size: int = 10
    hnsw: HNSWConfig = field(default_factory=HNSWConfig)
    ivf: IVFConfig = field(default_factory=_default_hybrid_ivf)


@dataclass
class SearchConfig:
    recent_k: int | None = None  # defaults to k
    historical_k: int | None = None  # defaults to k
    hnsw_ef: int = 50
    ivf_n_probe: int | None = None  # defaults to ivf config
    auto_migrate: bool | None = None  # defaults to hybrid config


@dataclass
class HybridStats:
    total_vectors: int
    recent_vectors: int
    historical_vectors: int
    deleted_recent: int
    deleted_historical: int
    ivf_trained: bool
    age_distribution: dict


class HybridIndex:
    """Recency-routed dual-engine index over one shared VectorStore.
    ``device=None`` means the card (see ``utils.device``)."""

    def __init__(self, dim: int, config: HybridConfig | None = None,
                 store: VectorStore | None = None, device=None):
        self.config = config or HybridConfig()
        self.store = store or VectorStore(dim, device=device)
        self.hnsw = HNSWIndex(self.store, self.config.hnsw)
        self.ivf = IVFIndex(self.store, self.config.ivf)
        self.flat = FlatIndex(self.store)
        from .fused import FusedSearcher

        self.fused = FusedSearcher(self)
        # serializes mutations (insert/delete/vacuum/migrate); readers
        # snapshot versioned device state
        self._write_lock = threading.RLock()
        # earliest `now` at which any HNSW member could age out; None =
        # unknown (scan on the next call)
        self._migration_due: float | None = None

    def initialize(self, training_data: np.ndarray | None = None) -> None:
        """Train IVF if enough data, else HNSW-only mode."""
        if training_data is not None:
            training_data = np.asarray(training_data, np.float32)
        n = 0 if training_data is None else training_data.shape[0]
        if n >= max(self.config.min_ivf_training_size,
                    self.config.ivf.n_clusters):
            self.ivf.train(training_data)

    # -------------------------------------------------------------- inserts
    def insert_batch(self, ids: list, vectors: np.ndarray, timestamps=None,
                     now: float | None = None) -> np.ndarray:
        """Insert vectors, routing each by age. Returns store rows."""
        with self._write_lock:
            now = time.time() if now is None else now
            vectors = np.asarray(vectors, np.float32)
            if timestamps is None:
                ts = np.full(vectors.shape[0], now, np.float64)
            else:
                ts = np.asarray(timestamps, np.float64)
                if ts.ndim == 0:
                    ts = np.full(vectors.shape[0], float(ts), np.float64)
                # validate before mutating the store
                if ts.shape != (vectors.shape[0],):
                    raise ValueError(
                        f"timestamps shape {ts.shape} != ({vectors.shape[0]},)")
            rows = self.store.add_batch(ids, vectors, ts)
            age = now - ts
            recent = age < self.config.recent_threshold_secs
            if not self.ivf.trained:
                recent[:] = True  # HNSW-only mode
            if recent.any():
                self.hnsw.insert_rows(rows[recent])
                due_new = float(ts[recent].min()) \
                    + self.config.recent_threshold_secs
                cur = self._migration_due
                if cur is not None and due_new < cur:
                    self._migration_due = due_new
            if (~recent).any():
                self.ivf.insert_rows(rows[~recent])
            return rows

    # --------------------------------------------------------------- search
    def search(self, query: np.ndarray, k: int, config: SearchConfig | None = None,
               now: float | None = None):
        """Single query -> list[(id, distance)] ascending."""
        d, rows = self.search_rows(np.atleast_2d(query), k, config, now=now)
        return self._rows_to_results(d[0], rows[0])

    @staticmethod
    def _per_engine_k(cfg: SearchConfig, k: int) -> None:
        recent_k = k if cfg.recent_k is None else cfg.recent_k
        historical_k = k if cfg.historical_k is None else cfg.historical_k
        if recent_k != k or historical_k != k:
            raise NotImplementedError(
                "per-engine recent_k / historical_k need HNSW and IVF "
                "search, which are not ported yet")

    def search_rows(self, queries: np.ndarray, k: int,
                    config: SearchConfig | None = None,
                    extra_mask: np.ndarray | None = None,
                    now: float | None = None):
        """Batched search. Returns (dists [B, k], rows [B, k])."""
        return self.search_rows_dispatch(queries, k, config, extra_mask,
                                         now=now)()

    @staticmethod
    def _finalize_fast(vals, rows, k: int):
        """Post-process one fused result: sqrt, trim/pad to k."""
        vals, rows = np.asarray(vals)[:, :k], np.asarray(rows)[:, :k]
        vals = np.sqrt(np.maximum(vals, 0.0))
        vals = np.where(rows >= 0, vals, np.inf)
        if vals.shape[1] < k:
            pad = k - vals.shape[1]
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=np.inf)
            rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
        return vals, rows

    def search_rows_dispatch(self, queries: np.ndarray, k: int,
                             config: SearchConfig | None = None,
                             extra_mask: np.ndarray | None = None,
                             now: float | None = None):
        """Launch the fused search and return a zero-arg
        ``finalize() -> (dists, rows)``; several batches can be launched
        before the first is read back."""
        cfg = config or SearchConfig()
        self._per_engine_k(cfg, k)
        auto = (self.config.auto_migrate if cfg.auto_migrate is None
                else cfg.auto_migrate)
        if auto:
            self.migrate_old_vectors(now=now)
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        k_eff = min(bucket(k), self.store.capacity)
        vals_d, rows_d, _ = self.fused.search_dispatch(
            queries, k_eff, bucket(max(cfg.hnsw_ef, k)),
            cfg.ivf_n_probe or self.config.ivf.n_probe, extra_mask)

        def finalize():
            return self._finalize_fast(*to_host(vals_d, rows_d), k)

        return finalize

    def search_with_filter(self, query: np.ndarray, k: int,
                           filter: MetadataFilter | dict | None,
                           oversample: int = 3, now: float | None = None,
                           row_mask: np.ndarray | None = None):
        """Filtered search: the filter's row bitmask (``row_mask``, from the
        session's columnar metadata) is fused into selection, k is
        oversampled x3 and the mask is enforced again on the result rows."""
        if filter is None:
            d, rows = self.search_rows(np.atleast_2d(query), k, now=now)
            return self._rows_to_results(d[0], rows[0])
        if row_mask is None:
            raise ValueError("a filtered search needs the filter's row_mask")
        mask = fit_mask(np.asarray(row_mask, bool), self.store.capacity)
        d, rows = self.search_rows(
            np.atleast_2d(query), k * oversample, extra_mask=mask, now=now)
        keep = (rows[0] >= 0) & mask[np.maximum(rows[0], 0)]
        d0 = np.where(keep, d[0], np.inf)
        r0 = np.where(keep, rows[0], -1)
        return self._rows_to_results(d0, r0)[:k]

    def search_oversampled_post_filter(self, query: np.ndarray, k: int,
                                       predicate, oversample: int = 3,
                                       now: float | None = None):
        """Search k*oversample unfiltered, keep rows passing
        ``predicate(id)``, truncate to k (non-lowerable filters)."""
        d, rows = self.search_rows(np.atleast_2d(query), k * oversample,
                                   now=now)
        results = self._rows_to_results(d[0], rows[0])
        return [(vid, dist) for vid, dist in results if predicate(vid)][:k]

    def _rows_to_results(self, dists: np.ndarray, rows: np.ndarray):
        out = []
        for dist, row in zip(dists, rows):
            if row < 0 or not np.isfinite(dist):
                continue
            vid = self.store.id_of(int(row))
            if vid is not None:
                out.append((vid, float(dist)))
        return out

    # ------------------------------------------------------------ migration
    def migrate_old_vectors(self, batch_size: int | None = None,
                            now: float | None = None) -> int:
        """Move aged-out HNSW rows to IVF. Returns number migrated."""
        if not self.ivf.trained:
            return 0
        now_eff = time.time() if now is None else now
        due = self._migration_due
        if due is not None and now_eff < due:
            return 0  # nothing can be old yet: skip the scan and the lock
        with self._write_lock:
            if batch_size is None:
                batch_size = self.config.migration_batch_size
            n = self.store.count
            m = self.hnsw.member_mask()[:n]
            act = ~self.store.deleted[:n]
            age = now_eff - self.store.timestamps[:n]
            old = np.nonzero(
                m & act & (age >= self.config.recent_threshold_secs))[0]
            if old.size == 0:
                member_ts = self.store.timestamps[:n][m & act]
                self._migration_due = (
                    float(member_ts.min()) + self.config.recent_threshold_secs
                    if member_ts.size else float("inf"))
                return 0
            batch = old[:batch_size]
            self.ivf.insert_rows(batch)
            self.hnsw.remove_rows(batch)
            self._migration_due = None  # more may remain: re-scan next call
            return int(batch.size)

    # ----------------------------------------------------------------- CRUD
    def delete(self, vid: str) -> bool:
        """Soft-delete by id (either engine)."""
        with self._write_lock:
            return self.store.mark_deleted(vid)

    def batch_delete(self, ids: list) -> int:
        with self._write_lock:
            n = 0
            for vid in ids:
                try:
                    if self.store.mark_deleted(vid):
                        n += 1
                except UnknownIdError:
                    pass
            return n

    def vacuum(self) -> dict:
        """Physically remove soft-deleted vectors from both engines."""
        with self._write_lock:
            hnsw_removed = self.hnsw.vacuum()
            ivf_removed = self.ivf.vacuum()
            self.store.vacuum()
            return {
                "hnsw_removed": hnsw_removed,
                "ivf_removed": ivf_removed,
                "total_removed": hnsw_removed + ivf_removed,
            }

    def get_deleted_vectors(self) -> list:
        out = []
        for row in np.nonzero(self.store.deleted[: self.store.count])[0]:
            vid = self.store.id_of(int(row))
            if vid is not None:
                out.append(vid)
        return out

    def contains(self, vid: str) -> bool:
        return self.store.contains(vid)

    def get_vector(self, vid: str) -> np.ndarray:
        return self.store.get_vector(vid)

    # ---------------------------------------------------------------- stats
    def stats(self, now: float | None = None) -> HybridStats:
        now = time.time() if now is None else now
        n = self.store.count
        act = ~self.store.deleted[:n]
        age_days = np.maximum(
            now - self.store.timestamps[:n], 0.0) / SECONDS_PER_DAY
        buckets = {"0-1d": (0, 1), "1-7d": (1, 7), "7-30d": (7, 30),
                   "30d+": (30, np.inf)}
        dist = {
            name: int(((age_days >= lo) & (age_days < hi) & act).sum())
            for name, (lo, hi) in buckets.items()
        }
        return HybridStats(
            total_vectors=self.store.active_count,
            recent_vectors=self.hnsw.active_count,
            historical_vectors=self.ivf.active_count,
            deleted_recent=self.hnsw.deleted_count,
            deleted_historical=self.ivf.deleted_count,
            ivf_trained=self.ivf.trained,
            age_distribution=dist,
        )

    def memory_usage_bytes(self) -> int:
        return (self.store.memory_usage_bytes()
                + self.hnsw.memory_usage_bytes()
                + self.ivf.memory_usage_bytes())
