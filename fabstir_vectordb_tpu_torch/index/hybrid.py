"""Hybrid index: HNSW for recent vectors + IVF for historical, time-routed.

The JAX package's ``index/hybrid.py``: one shared VectorStore with
per-engine membership; inserts route by age (all to HNSW until IVF is
trained); searches with the default per-engine k run the fused search
(flat, reduced-rank or pruned regime); per-engine ``recent_k`` /
``historical_k`` search each engine on its own and merge on the host;
migration moves aged-out rows from HNSW to IVF; soft deletes, vacuum and
stats as there. A lazily loaded index (``storage/persistence.py``) answers
searches from on-demand chunk fetches (``index/cold.py``) until its rows
are resident, and every other data-plane call waits for them
(:meth:`HybridIndex.wait_ready`).
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
        self.initialized = False
        self._materialize_event = None  # set during lazy loads
        self._load_error: Exception | None = None
        self._cold = None  # ColdServing during lazy loads
        # serializes mutations (insert/delete/vacuum/migrate); readers
        # snapshot versioned device state
        self._write_lock = threading.RLock()
        # earliest `now` at which any HNSW member could age out; None =
        # unknown (scan on the next call)
        self._migration_due: float | None = None

    # ------------------------------------------------------------ lifecycle
    def begin_materialize(self, event) -> None:
        """Mark the index as lazily loading: data-plane calls wait in
        wait_ready() until the background materializer sets ``event``."""
        self._materialize_event = event

    def attach_cold(self, cold) -> None:
        """Install a ColdServing context: searches during the lazy load are
        answered from on-demand chunk fetches instead of waiting."""
        self._cold = cold

    def _cold_active(self, cfg) -> bool:
        from ..utils import limits

        return (not self.ready and self._cold is not None
                and limits.cold_serve()
                and cfg.recent_k is None and cfg.historical_k is None)

    def wait_ready(self, timeout: float | None = None) -> None:
        """Block until lazily loaded rows are resident (a no-op after an
        eager load); raises the materializer's error if the load failed."""
        ev = self._materialize_event
        if ev is None:
            return
        if not ev.wait(timeout):
            raise TimeoutError("lazy load still materializing")
        if self._load_error is not None:
            raise self._load_error
        self._materialize_event = None
        self._cold = None  # fully resident: cold serving retires

    @property
    def ready(self) -> bool:
        ev = self._materialize_event
        return ev is None or ev.is_set()

    @property
    def ivf_trained(self) -> bool:
        return self.ivf.trained

    def initialize(self, training_data: np.ndarray | None = None) -> None:
        """Train IVF if enough data, else HNSW-only mode."""
        if training_data is not None:
            training_data = np.asarray(training_data, np.float32)
        n = 0 if training_data is None else training_data.shape[0]
        if n >= max(self.config.min_ivf_training_size,
                    self.config.ivf.n_clusters):
            self.ivf.train(training_data)
        self.initialized = True

    # -------------------------------------------------------------- inserts
    def insert_batch(self, ids: list, vectors: np.ndarray, timestamps=None,
                     now: float | None = None) -> np.ndarray:
        """Insert vectors, routing each by age. Returns store rows."""
        self.wait_ready()
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

    def search_rows(self, queries: np.ndarray, k: int,
                    config: SearchConfig | None = None,
                    extra_mask: np.ndarray | None = None,
                    now: float | None = None):
        """Batched dual-engine search. Returns (dists [B, k], rows [B, k])."""
        cfg = config or SearchConfig()
        if self._cold_active(cfg):
            cold = self._cold
            if cold is not None:  # the materializer may retire it meanwhile
                return cold.search_rows(
                    queries, k,
                    n_probe=(self.config.ivf.n_probe
                             if cfg.ivf_n_probe is None else cfg.ivf_n_probe),
                    extra_mask=extra_mask)
        self.wait_ready()
        # `x if x is not None else default`: 0 is a valid value (skip that
        # engine)
        recent_k = k if cfg.recent_k is None else cfg.recent_k
        historical_k = k if cfg.historical_k is None else cfg.historical_k
        if recent_k == k and historical_k == k:
            return self.search_rows_dispatch(queries, k, config, extra_mask,
                                             now=now)()
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        b = queries.shape[0]
        auto = (self.config.auto_migrate if cfg.auto_migrate is None
                else cfg.auto_migrate)
        if auto:
            self.migrate_old_vectors(now=now)
        parts_d, parts_r = [], []
        if recent_k > 0 and self.hnsw.num_nodes > 0:
            d1, r1 = self.hnsw.search_rows(
                queries, recent_k, ef=max(cfg.hnsw_ef, recent_k),
                extra_mask=extra_mask)
            parts_d.append(d1)
            parts_r.append(r1)
        if (historical_k > 0 and self.ivf.trained
                and self.ivf.member_mask().any()):
            d2, r2 = self.ivf.search_rows(
                queries, historical_k, n_probe=cfg.ivf_n_probe,
                extra_mask=extra_mask)
            parts_d.append(d2)
            parts_r.append(r2)
        if not parts_d:
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int32))
        d = np.concatenate(parts_d, axis=1)
        r = np.concatenate(parts_r, axis=1)
        d = np.where(r >= 0, d, np.inf)
        # a row a migration batch left in both engines keeps its best copy,
        # never two result slots
        order_all = np.argsort(d, axis=1, kind="stable")
        d_sorted = np.take_along_axis(d, order_all, axis=1)
        r_sorted = np.take_along_axis(r, order_all, axis=1)
        for i in range(r_sorted.shape[0]):
            _, first = np.unique(r_sorted[i], return_index=True)
            dup = np.ones(r_sorted.shape[1], bool)
            dup[first] = False
            dup &= r_sorted[i] >= 0
            d_sorted[i, dup] = np.inf
            r_sorted[i, dup] = -1
        order = np.argsort(d_sorted, axis=1, kind="stable")[:, :k]
        out_d = np.take_along_axis(d_sorted, order, axis=1)
        out_r = np.take_along_axis(r_sorted, order, axis=1)
        out_r = np.where(np.isfinite(out_d), out_r, -1)
        if out_d.shape[1] < k:
            pad = k - out_d.shape[1]
            out_d = np.pad(out_d, ((0, 0), (0, pad)), constant_values=np.inf)
            out_r = np.pad(out_r, ((0, 0), (0, pad)), constant_values=-1)
        return out_d, out_r

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
        before the first is read back. Per-engine k (recent_k /
        historical_k) searches eagerly instead, as the reference does."""
        cfg = config or SearchConfig()
        recent_k = cfg.recent_k or k
        historical_k = cfg.historical_k or k
        if recent_k != k or historical_k != k or self._cold_active(cfg):
            d, r = self.search_rows(queries, k, config, extra_mask, now=now)
            return lambda: (d, r)
        self.wait_ready()
        auto = (self.config.auto_migrate if cfg.auto_migrate is None
                else cfg.auto_migrate)
        if auto:
            self.migrate_old_vectors(now=now)
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        k_eff = min(bucket(k), self.store.capacity)
        vals_d, rows_d, post = self.fused.search_dispatch(
            queries, k_eff, bucket(max(cfg.hnsw_ef, k)),
            cfg.ivf_n_probe or self.config.ivf.n_probe, extra_mask)

        def finalize():
            vals, rows = to_host(vals_d, rows_d)
            if post is not None:  # the reduced-rank regime's host re-score
                vals, rows = post(vals, rows)
            return self._finalize_fast(vals, rows, k)

        return finalize

    def search_rows_pipelined(self, query_batches, k: int,
                              config: SearchConfig | None = None,
                              extra_mask: np.ndarray | None = None,
                              now: float | None = None,
                              depth: int = 4) -> list:
        """Batched searches with up to ``depth`` launched before the first
        is read back, so a batch's launches overlap the previous batches'
        readbacks and host re-scores. Takes [B_i, D] query batches; returns
        their (dists [B_i, k], rows [B_i, k]) in order, equal to
        :meth:`search_rows` per batch."""
        fins: list = []
        out: list = []
        for qb in query_batches:
            fins.append(self.search_rows_dispatch(qb, k, config, extra_mask,
                                                  now=now))
            if len(fins) >= depth:
                out.append(fins.pop(0)())
        while fins:
            out.append(fins.pop(0)())
        return out

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
        self.wait_ready()
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
        self.wait_ready()
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
        self.wait_ready()
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

    # ----------------------------------------------------------- persistence
    @classmethod
    def from_parts(cls, dim: int, config: HybridConfig, ids: list,
                   vectors: np.ndarray, timestamps: np.ndarray,
                   hnsw_member: np.ndarray, centroids: np.ndarray | None,
                   deleted_ids: list | None = None,
                   device=None) -> "HybridIndex":
        """Rebuild from persisted state (reference: hybrid/core.rs:857-901):
        ``hnsw_member`` per input row; the other rows go to IVF, which needs
        centroids. The graph is built again through insert_rows."""
        idx = cls(dim, config, device=device)
        rows = idx.store.add_batch(ids, vectors, timestamps)
        if centroids is not None and len(centroids):
            idx.ivf.set_trained(centroids)
        hnsw_member = np.asarray(hnsw_member, bool)
        if (~hnsw_member).any() and not idx.ivf.trained:
            raise ValueError("historical rows present but no centroids")
        if hnsw_member.any():
            idx.hnsw.insert_rows(rows[hnsw_member])
        if (~hnsw_member).any():
            idx.ivf.insert_rows(rows[~hnsw_member])
        for vid in deleted_ids or []:
            if idx.store.contains(vid):
                idx.store.mark_deleted(vid)
        idx.initialized = True
        return idx
