"""Thread-safe LRU cache of VectorChunks with hit/miss/eviction metrics.

A copy of the JAX package's ``core/chunk_cache.py``.

Parity with the reference's ChunkCache (reference: src/core/chunk_cache.rs:
48-172, CacheMetrics :12-45): capacity in number of chunks or bytes, LRU
eviction, shared across clones. In the TPU build this is the host-DRAM tier
of the chunk hierarchy (object store -> host cache -> HBM arrays).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

from .chunk import VectorChunk


@dataclass
class CacheMetrics:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def to_json(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }


class ChunkCache:
    """LRU chunk cache bounded by chunk count and/or total bytes."""

    def __init__(self, max_chunks: int = 15, max_bytes: int | None = None):
        if max_chunks <= 0:
            raise ValueError("max_chunks must be positive")
        self.max_chunks = max_chunks
        self.max_bytes = max_bytes
        self._entries: OrderedDict[str, VectorChunk] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.metrics = CacheMetrics()

    @staticmethod
    def _size_of(chunk: VectorChunk) -> int:
        return int(chunk.data.nbytes) + 64 * len(chunk.ids)

    def get(self, chunk_id: str) -> VectorChunk | None:
        with self._lock:
            chunk = self._entries.get(chunk_id)
            if chunk is None:
                self.metrics.misses += 1
                return None
            self._entries.move_to_end(chunk_id)
            self.metrics.hits += 1
            return chunk

    def put(self, chunk: VectorChunk) -> None:
        with self._lock:
            if chunk.chunk_id in self._entries:
                self._bytes -= self._size_of(self._entries.pop(chunk.chunk_id))
            self._entries[chunk.chunk_id] = chunk
            self._bytes += self._size_of(chunk)
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._entries) > self.max_chunks or (
            self.max_bytes is not None
            and self._bytes > self.max_bytes
            and len(self._entries) > 1
        ):
            _, evicted = self._entries.popitem(last=False)
            self._bytes -= self._size_of(evicted)
            self.metrics.evictions += 1

    def contains(self, chunk_id: str) -> bool:
        with self._lock:
            return chunk_id in self._entries

    def remove(self, chunk_id: str) -> bool:
        with self._lock:
            chunk = self._entries.pop(chunk_id, None)
            if chunk is None:
                return False
            self._bytes -= self._size_of(chunk)
            return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes
