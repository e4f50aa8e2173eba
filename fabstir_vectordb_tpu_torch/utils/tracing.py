"""Search performance monitoring (copied from the JAX package's
``utils/tracing.py``): the reference's ``SearchPerformanceMonitor``
(src/hybrid/search_integration.rs:491-552) as a latency-percentile recorder.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class SearchRecord:
    latency_ms: float
    num_results: int
    indices_used: tuple


@dataclass
class PerfMonitor:
    """Records per-search latency and computes total/avg/p50/p99 stats.

    The record buffer is a BOUNDED window (default 10K searches): a
    long-running server at serving QPS would otherwise retain one record
    per query forever (an unbounded leak, plus an O(n log n) sort on
    every /statistics scrape). ``total`` stays a monotonic lifetime
    counter — the /metrics counter contract — while quantiles describe
    the recent window.
    """

    window: int = 10_000
    records: "deque" = None  # set in __post_init__ (needs self.window)
    total: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def __post_init__(self) -> None:
        from collections import deque

        if self.records is None:
            self.records = deque(maxlen=self.window)

    def record(self, latency_ms: float, num_results: int = 0, indices_used=()) -> None:
        with self._lock:
            self.records.append(SearchRecord(latency_ms, num_results, tuple(indices_used)))
            self.total += 1

    def time(self):
        """Context manager measuring a search."""
        monitor = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                monitor.record((time.perf_counter() - self.t0) * 1000.0)
                return False

        return _Timer()

    def stats(self) -> dict:
        with self._lock:
            lats = sorted(r.latency_ms for r in self.records)
        if not lats:
            return {"total_searches": 0, "avg_ms": 0.0, "p50_ms": 0.0, "p99_ms": 0.0}

        def pct(p):
            idx = min(len(lats) - 1, int(round(p / 100.0 * (len(lats) - 1))))
            return lats[idx]

        return {
            "total_searches": self.total,
            "avg_ms": sum(lats) / len(lats),
            "p50_ms": pct(50),
            "p99_ms": pct(99),
        }

    def reset(self) -> None:
        with self._lock:
            self.records.clear()
            self.total = 0
