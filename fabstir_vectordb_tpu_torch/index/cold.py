"""On-demand cold serving: answer queries during a lazy load.

A copy of the JAX package's ``index/cold.py``: it scores on the host and
runs no device code in either package.

A lazily-loaded index has its sidecars (id map, timestamps, IVF centroids +
assignments, full HNSW graph) resident after a few small fetches, but the
vector chunks are still streaming in the background. Instead of blocking the
first search on full materialization, this module serves it by fetching ONLY
the chunks the query plan touches:

  - all HNSW-member rows (the "recent" set — a small contiguous span, because
    ``save_index_chunked`` groups HNSW members first), and
  - the rows of the ``n_probe`` IVF clusters nearest each query (contiguous
    spans too — the save order groups IVF rows by cluster).

Candidates are scored exactly on the host (one BLAS matmul over the gathered
rows). The candidate set is a superset of what the pruned device path scans
(ALL HNSW members brute-forced vs. a beam; identical IVF probe lists), so
cold results are at least as accurate as warm pruned results.

This is the TPU-era shape of the reference's lazy chunk-on-demand design
(reference: src/storage/chunk_loader.rs — cache/dedup/retry fetches;
src/hybrid/persistence.rs:497-570 — lazy load returning before chunk data;
README.md:24-26 — searchable immediately, first search pays chunk fetches):
there the graph traversal faulted chunks in one at a time; here the probe
list is known up front, so the fetch set is batched through the loader's
thread pool and the scan is one matmul.
"""
from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np


class ColdServing:
    """Query serving over a partially-materialized store.

    Shared between the background materializer (which marks chunks filled
    as they stream in) and search callers (which fetch + fill any missing
    chunks their plan needs). Both write identical data into disjoint-or-
    identical row ranges, so the benign double-fill race is harmless.
    """

    def __init__(self, hybrid, loader, keys: list, chunk_size: int,
                 hnsw_span, cluster_spans: dict, total: int,
                 data_offsets: list | None = None, dim: int = 0):
        self.hybrid = hybrid
        self.loader = loader
        self.keys = keys
        self.chunk_size = max(int(chunk_size), 1)
        self.hnsw_span = (int(hnsw_span[0]), int(hnsw_span[1]))
        self.cluster_spans = {
            int(c): (int(lo), int(hi))
            for c, (lo, hi) in (cluster_spans or {}).items()
        }
        self.total = int(total)
        self.filled = np.zeros(len(keys), bool)
        # row-granularity residency: partial (ranged) fills mark only their
        # rows; whole-chunk fills mark the chunk AND its rows
        self.row_filled = np.zeros(self.total, bool)
        # byte offset of each chunk's raw f32 row block inside its stored
        # blob (save-time verified; -1 = tail unverified -> whole-chunk
        # fallback for that chunk). With these + a range-capable store,
        # on-demand serving reads ONLY the probed row spans.
        self.data_offsets = (
            [int(o) for o in data_offsets]
            if data_offsets is not None and len(data_offsets) == len(keys)
            else None
        )
        self.dim = int(dim)
        self._lock = threading.Lock()
        self.on_demand_fetches = 0
        self.on_demand_rows = 0
        self.on_demand_bytes = 0
        self._pending = 0  # live on-demand fetch loops (materializer yields)

    # ------------------------------------------------------------- tracking
    def mark_filled(self, chunk_idx: int) -> None:
        """Materializer callback: chunk ``chunk_idx``'s rows are resident."""
        with self._lock:
            self._mark_chunk_locked(chunk_idx)

    def _mark_chunk_locked(self, chunk_idx: int) -> None:
        self.filled[chunk_idx] = True
        lo = chunk_idx * self.chunk_size
        self.row_filled[lo: lo + self.chunk_size] = True

    def is_filled(self, chunk_idx: int) -> bool:
        with self._lock:
            return bool(self.filled[chunk_idx])

    def hold_materializer(self) -> None:
        """Park the background materializer at its next between-chunks
        yield point, where it holds NO locks (unlike mid-fetch, where it
        holds the loader's in-flight dedup lock for the chunk). Pairs
        with :meth:`release_materializer`. Lets admin/throttling code —
        and deterministic tests — stop background IO without stalling
        on-demand serving."""
        with self._lock:
            self._pending += 1

    def release_materializer(self) -> None:
        with self._lock:
            self._pending -= 1

    def yield_to_searches(self) -> None:
        """Materializer callback between chunks: on a few-core host the
        background fill and an on-demand fetch contend for the same CPU
        (reads, CBOR decode, memcpy), roughly doubling time-to-first-
        search; sleeping while a search's fetch loop is live hands it the
        core. Measured at 1M/100 chunks: first search 53 s -> seconds."""
        while True:
            with self._lock:
                if self._pending == 0:
                    return
            time.sleep(0.01)

    def stats(self) -> dict:
        with self._lock:
            done = int(self.filled.sum())
            rows = int(self.row_filled.sum())
        return {
            "chunks_total": len(self.keys),
            "chunks_resident": done,
            "rows_resident": rows,
            "chunks_fetched_on_demand": self.on_demand_fetches,
            "rows_fetched_on_demand": self.on_demand_rows,
            "bytes_fetched_on_demand": self.on_demand_bytes,
        }

    # -------------------------------------------------------------- serving
    def _merged_spans(self, spans) -> list:
        """Clamp to [0, total), sort, and merge overlapping/adjacent spans."""
        clean = sorted(
            (max(int(lo), 0), min(int(hi), self.total))
            for lo, hi in spans
        )
        out: list = []
        for lo, hi in clean:
            if hi <= lo:
                continue
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return out

    def _can_range_read(self) -> bool:
        return (
            self.data_offsets is not None
            and self.dim > 0
            and bool(getattr(self.loader.store, "supports_range", False))
        )

    def _missing_runs(self, spans) -> list:
        """Maximal runs of non-resident rows inside the merged spans, as
        (row_lo, row_hi) pairs. Caller holds no lock."""
        runs: list = []
        with self._lock:
            for lo, hi in spans:
                gap = np.flatnonzero(~self.row_filled[lo:hi])
                if gap.size == 0:
                    continue
                breaks = np.flatnonzero(np.diff(gap) > 1)
                starts = np.concatenate(([0], breaks + 1))
                ends = np.concatenate((breaks, [gap.size - 1]))
                for s, e in zip(starts, ends):
                    runs.append((lo + int(gap[s]), lo + int(gap[e]) + 1))
        return runs

    def _ensure_spans(self, spans, merged: bool = False) -> None:
        """Make every row in the given position spans resident.

        Two strategies:
          - RANGED (store supports byte ranges + save recorded verified
            data offsets): fetch exactly the missing row runs as byte
            ranges of the chunk blobs — the fix for whole-chunk cold
            fetches (r4: one query pulled 58 of 100 15 MB chunks, ~870 MB,
            for an ~80 MB candidate set).
          - WHOLE-CHUNK fallback: fetch + decode every chunk overlapping
            the spans (any store, any save format).

        Fetches do NOT go through the loader's shared thread pool: the
        background materializer keeps that pool's queue full for the whole
        load, so a pooled on-demand fetch would wait for the entire backlog
        (the exact head-of-line blocking this path exists to avoid).
        Whole-chunk calls hit ``load_chunk`` directly — its in-flight dedup
        still coalesces a fetch the materializer already has running; range
        reads never collide with it (double-fills write identical bytes).
        Work runs from this thread on serial (local) stores, or a small
        private pool when the store declares ``parallel_fetch`` (network
        stores release the GIL in ``get``)."""
        if not merged:
            spans = self._merged_spans(spans)
        if not spans:
            return
        with self._lock:
            self._pending += 1  # materializer yields until we finish
        try:
            if self._can_range_read():
                self._ensure_spans_ranged(spans)
            else:
                self._ensure_spans_chunks(spans)
        finally:
            with self._lock:
                self._pending -= 1

    def _ensure_spans_ranged(self, spans) -> None:
        cs = self.chunk_size
        store = self.hybrid.store
        row_bytes = self.dim * 4
        # split missing runs at chunk boundaries (one object per chunk);
        # chunks whose data offset failed save-time verification fall back
        # to a whole-chunk fetch
        tasks: list = []  # (chunk_idx, row_lo, row_hi) or (chunk_idx, None, None)
        fallback: set = set()
        for r0, r1 in self._missing_runs(spans):
            ci = r0 // cs
            while r0 < r1:
                edge = min(r1, (ci + 1) * cs)
                if self.data_offsets[ci] < 0:
                    fallback.add(ci)
                else:
                    tasks.append((ci, r0, edge))
                r0 = edge
                ci += 1

        def _fetch_run(task) -> None:
            ci, r0, r1 = task
            base = ci * cs
            off = self.data_offsets[ci] + (r0 - base) * row_bytes
            want = (r1 - r0) * row_bytes
            raw = self.loader.fetch_range(self.keys[ci], off, want)
            if len(raw) != want:
                # a truncated blob or a Range-clamping proxy must never
                # leave zero rows that the scan then silently scores;
                # demote the chunk to the whole-chunk path (its CBOR
                # decode self-verifies, same contract as the eager twin
                # _chunk_block)
                with self._lock:
                    fallback.add(ci)
                return
            rows = np.frombuffer(raw, np.float32).reshape(-1, self.dim)
            with self._lock:
                store.fill_rows(r0, rows)
                self.row_filled[r0: r0 + rows.shape[0]] = True
                self.on_demand_fetches += 1
                self.on_demand_rows += int(rows.shape[0])
                self.on_demand_bytes += len(raw)

        self._run_fills(_fetch_run, tasks)
        if fallback:
            self._fill_whole_chunks(sorted(fallback))

    def _ensure_spans_chunks(self, spans) -> None:
        cs = self.chunk_size
        need: set = set()
        for lo, hi in spans:
            need.update(range(lo // cs, (hi - 1) // cs + 1))
        with self._lock:
            missing = [i for i in sorted(need) if not self.filled[i]]
        self._fill_whole_chunks(missing)

    def _fill_whole_chunks(self, missing: list) -> None:
        if not missing:
            return
        store = self.hybrid.store

        def _fill(i: int) -> None:
            if self.is_filled(i):  # materializer got there first
                return
            chunk = self.loader.load_chunk(self.keys[i])
            with self._lock:
                if self.filled[i]:
                    return
                if chunk.data.shape[0]:
                    store.fill_rows(chunk.start_idx, chunk.data)
                self._mark_chunk_locked(i)
                self.on_demand_fetches += 1
                self.on_demand_rows += int(chunk.data.shape[0])
                self.on_demand_bytes += int(chunk.data.nbytes)

        self._run_fills(_fill, missing)

    def _run_fills(self, fn, work: list) -> None:
        if not work:
            return
        if getattr(self.loader.store, "parallel_fetch", False) \
                and len(work) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, len(work))) as ex:
                list(ex.map(fn, work))
        else:
            for w in work:
                fn(w)

    def _probe_spans(self, queries: np.ndarray, n_probe: int) -> list:
        """Position spans for the batch's candidate set: the HNSW span plus
        the union of each query's ``n_probe`` nearest clusters' spans."""
        spans = []
        if self.hnsw_span[1] > self.hnsw_span[0]:
            spans.append(self.hnsw_span)
        ivf = self.hybrid.ivf
        if ivf.trained and self.cluster_spans:
            c = ivf.centroids  # [C, D] f32, host
            # norm-expansion distances: one [B, C] matmul, C is small
            d = (
                np.einsum("cd,cd->c", c, c)[None, :]
                - 2.0 * queries @ c.T
            )
            n_probe = min(max(n_probe, 1), c.shape[0])
            probe = np.argpartition(d, n_probe - 1, axis=1)[:, :n_probe]
            for cid in np.unique(probe):
                span = self.cluster_spans.get(int(cid))
                if span is not None:
                    spans.append(span)
        return spans

    def search_rows(
        self,
        queries: np.ndarray,
        k: int,
        n_probe: int,
        extra_mask: np.ndarray | None = None,
    ):
        """Exact host scan over the plan's candidate rows.

        Returns (dists [B, k] euclidean, rows [B, k]) — the same contract as
        ``HybridIndex.search_rows``.
        """
        timing = os.environ.get("FVDB_TIMING", "0") == "1"
        t0 = time.perf_counter()
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        spans = self._merged_spans(self._probe_spans(queries, n_probe))
        t1 = time.perf_counter()
        # hold the materializer for the WHOLE search, not just the fetch:
        # its chunk decode loop is CPU-bound and on a few-core host it
        # starves the scan below too (measured at 1M: the same 355K-row
        # scan took 7.0 s with the materializer running vs 0.95 s without)
        with self._lock:
            self._pending += 1
        try:
            self._ensure_spans(spans, merged=True)
            t2 = time.perf_counter()
            if timing:
                print(f"[fvdb-timing] cold probe-plan {t1-t0:.3f}s "
                      f"ensure-spans {t2-t1:.3f}s "
                      f"(rows={sum(hi-lo for lo, hi in spans)}, "
                      f"fetched={self.on_demand_rows})", file=sys.stderr)
            out = self._scan_spans(queries, k, spans, extra_mask)
        finally:
            with self._lock:
                self._pending -= 1
        if timing:
            print(f"[fvdb-timing] cold scan {time.perf_counter()-t2:.3f}s "
                  f"(spans={len(spans)})", file=sys.stderr)
        return out

    def _scan_spans(self, queries: np.ndarray, k: int, spans,
                    extra_mask: np.ndarray | None):
        """Exact scan over the spans' rows, SPAN-WISE from the store's
        contiguous slices: no [M, D] gather copy and no [M] norm temporary
        over the full candidate set (at 1M a 45%-coverage plan made those
        ~700 MB of pure memcpy on the serving path). Each span contributes
        its top-k via norm-expansion BLAS on the contiguous block; winners
        are merged and exactly re-scored in difference form (the same
        exactness recipe as the warm host rerank paths)."""
        store = self.hybrid.store
        b = queries.shape[0]
        q_t = np.ascontiguousarray(queries.T)  # [D, B]
        em = None
        if extra_mask is not None and extra_mask.shape[0] > 0:
            em = np.asarray(extra_mask, bool)

        cand_rows: list = []  # per-span [k_s, B] winner rows
        cand_d: list = []
        for lo, hi in spans:
            hi = min(hi, store.count)
            if hi <= lo:
                continue
            x = store.data[lo:hi]  # contiguous view, no copy
            keep = ~store.deleted[lo:hi]
            if em is not None:
                e = em[lo:min(hi, em.shape[0])]
                if e.shape[0] < hi - lo:
                    e = np.concatenate(
                        [e, np.zeros(hi - lo - e.shape[0], bool)])
                keep = keep & e
            if not keep.any():
                continue
            d = (np.einsum("md,md->m", x, x, dtype=np.float32)[:, None]
                 - 2.0 * (x @ q_t))  # [m, B]; +q_sq is rank-irrelevant
            d[~keep] = np.inf
            k_s = min(k, d.shape[0])
            sel = np.argpartition(d, k_s - 1, axis=0)[:k_s]  # [k_s, B]
            cand_rows.append(sel + lo)
            cand_d.append(np.take_along_axis(d, sel, axis=0))
        if not cand_rows:
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int32))

        all_rows = np.concatenate(cand_rows, axis=0)  # [S*k, B]
        all_d = np.concatenate(cand_d, axis=0)
        k_eff = min(k, all_rows.shape[0])
        sel = np.argpartition(all_d, k_eff - 1, axis=0)[:k_eff]
        out_d = np.full((b, k), np.inf, np.float32)
        out_r = np.full((b, k), -1, np.int32)
        for i in range(b):
            picked = sel[:, i]
            finite = np.isfinite(all_d[picked, i])  # drop masked/deleted
            cand = np.unique(all_rows[picked, i][finite])
            if cand.size == 0:
                continue
            diff = store.data[cand] - queries[i][None, :]
            dd = np.einsum("kd,kd->k", diff, diff)
            order = np.argsort(dd, kind="stable")[:k_eff]
            out_d[i, :order.size] = np.sqrt(np.maximum(dd[order], 0.0))
            out_r[i, :order.size] = cand[order]
        return out_d, out_r
