"""Lazy chunk loading: cache check -> in-flight dedup -> retry -> decode.

A copy of the JAX package's ``storage/chunk_loader.py``.

Parity with the reference ChunkLoader (reference: src/storage/chunk_loader.rs):
  - ChunkCache check then fetch (:45-92);
  - in-flight request deduplication via per-path locks with double-checked
    cache (:51-66);
  - retry with exponential backoff 100/200/400 ms (:127-172);
  - parallel multi-chunk loads (:94-121) — here a thread pool feeding
    device transfers.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

from ..core.chunk import VectorChunk
from ..core.chunk_cache import ChunkCache
from ..core.object_store import ObjectStore, StorageError


class ChunkLoadError(StorageError):
    pass


class ChunkLoader:
    def __init__(
        self,
        store: ObjectStore,
        cache: ChunkCache | None = None,
        max_retries: int = 3,
        base_delay: float = 0.1,
        max_workers: int = 8,
        sleep=time.sleep,
    ):
        self.store = store
        self.cache = cache if cache is not None else ChunkCache(max_chunks=15)
        self.max_retries = max_retries
        self.base_delay = base_delay
        self._sleep = sleep
        self._inflight: dict[str, threading.Lock] = {}
        self._inflight_guard = threading.Lock()
        if not getattr(store, "parallel_fetch", False):
            # local stores: get() is GIL-bound byte shuffling, and thread
            # fan-out past the core count only adds convoy overhead
            # (measured 10.4 s pooled vs 1.0 s serial loading 100 x 15 MB
            # chunks on a 1-core host). Network stores (parallel_fetch)
            # keep the full fan-out: their get() blocks in the socket
            # with the GIL released.
            max_workers = max(1, min(max_workers, os.cpu_count() or 1))
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self.fetch_count = 0

    def load_chunk(self, key: str) -> VectorChunk:
        """Fetch one chunk by storage key, via cache + dedup + retry."""
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        with self._inflight_guard:
            lock = self._inflight.setdefault(key, threading.Lock())
        with lock:
            # double-checked: another thread may have fetched while we waited
            cached = self.cache.get(key)
            if cached is not None:
                return cached
            raw = self._fetch_with_retry(key)
            chunk = VectorChunk.from_cbor(raw)
            self.cache.put(chunk if chunk.chunk_id == key else
                           _rekey(chunk, key))
            self.fetch_count += 1
        with self._inflight_guard:
            self._inflight.pop(key, None)
        return self.cache.get(key) or chunk

    def _retry(self, fn, describe: str) -> bytes:
        """The loader's ONE retry policy (exponential backoff, reference:
        src/storage/chunk_loader.rs:127-172) — both the full-chunk and
        byte-range paths go through here so the ladder cannot diverge."""
        last: Exception | None = None
        for attempt in range(self.max_retries):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001
                last = e
                if attempt < self.max_retries - 1:
                    self._sleep(self.base_delay * (2 ** attempt))
        raise ChunkLoadError(f"failed to load {describe}") from last

    def _fetch_with_retry(self, key: str) -> bytes:
        return self._retry(lambda: self.store.get(key), f"chunk {key}")

    def fetch_range(self, key: str, offset: int, length: int) -> bytes:
        """Byte range of a stored chunk blob, with the same retry ladder as
        full fetches. Does NOT populate the chunk cache (a partial blob is
        not a decodable chunk); sub-chunk cold serving tracks residency at
        row granularity instead (index/cold.py)."""
        get_range = getattr(self.store, "get_range", None)

        def _once() -> bytes:
            if get_range is not None:
                return get_range(key, offset, length)
            return self.store.get(key)[offset: offset + length]

        return self._retry(
            _once, f"range [{offset}, {offset + length}) of {key}")

    def load_chunks_parallel(self, keys: list) -> list:
        """Fetch many chunks concurrently; order matches input keys."""
        return list(self._pool.map(self.load_chunk, keys))

    def load_chunks_iter(self, keys: list):
        """Yield ``(index, chunk)`` pairs AS EACH FETCH COMPLETES
        (completion order, not input order). Lets callers overlap
        per-chunk work — device uploads, store writes — with the
        remaining fetches instead of waiting for the full set."""
        futures = {
            self._pool.submit(self.load_chunk, key): i
            for i, key in enumerate(keys)
        }
        for fut in as_completed(futures):
            yield futures[fut], fut.result()

    def close(self) -> None:
        self._pool.shutdown(wait=False)


def _rekey(chunk: VectorChunk, key: str) -> VectorChunk:
    # Cache is keyed by storage key; chunk_id inside the payload may be a
    # short id ("chunk-3") while the key is a full path.
    return VectorChunk(key, chunk.start_idx, chunk.end_idx, chunk.ids, chunk.data)
