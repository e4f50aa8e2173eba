"""Lazy loads and cold serving of the port against the JAX package's, on the
CPU at a small size.

A save made by the JAX package is loaded lazily by both packages through a
gated store. The gate holds every chunk read of the background
materializer (thread ``fvdb-materialize``), through ``get()`` and
``get_range()`` alike, until the test has called ``hold_materializer()``:
the materializer then fills at most the one chunk it was reading and parks
at its next yield point, so at most one chunk is resident when the search
runs. Nothing here sleeps, and no wait is bounded tighter than 120 s.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.core.object_store import \
    MemoryObjectStore as MemoryJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridConfig as HybridConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridIndex as HybridJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import SearchConfig as SearchJ  # noqa: E402
from fabstir_vectordb_tpu.index.ivf import IVFConfig as IVFConfigJ  # noqa: E402
from fabstir_vectordb_tpu.storage.persistence import \
    HybridPersister as PersisterJ  # noqa: E402
from fabstir_vectordb_tpu_torch.index import hnsw as hnsw_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index.flat import FlatIndex  # noqa: E402
from fabstir_vectordb_tpu_torch.index.hybrid import SearchConfig  # noqa: E402
from fabstir_vectordb_tpu_torch.storage.persistence import \
    HybridPersister  # noqa: E402

NOW = 1_700_000_000.0
DAY = 86_400.0
D = 32
WAIT_S = 120


class GatedStore:
    """Passes every read through to ``store``, but holds the materializer
    thread's chunk reads, by get() and get_range() alike, until ``gate`` is
    set. ``ranges=False`` hides the range reads, so both packages fetch
    whole chunks."""

    def __init__(self, store, ranges: bool = True):
        self._s = store
        self.gate = threading.Event()
        self.supports_range = ranges and store.supports_range

    def _hold(self, key: str) -> None:
        if ("/chunks/" in key
                and threading.current_thread().name == "fvdb-materialize"):
            assert self.gate.wait(WAIT_S), "the gate never opened"

    def get(self, key):
        self._hold(key)
        return self._s.get(key)

    def get_range(self, key, offset, length):
        self._hold(key)
        return self._s.get_range(key, offset, length)

    def __getattr__(self, name):
        return getattr(self._s, name)


def _reference_save(n=2000, recent=300, n_clusters=16, n_probe=2,
                    chunk=100, deletes=0, seed=0):
    """A JAX-built hybrid index (recent rows in HNSW, the rest in IVF) saved
    chunked to a MemoryObjectStore under "cold"; returns (store, vecs)."""
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    idx = HybridJ(D, HybridConfigJ(
        ivf=IVFConfigJ(n_clusters=n_clusters, n_probe=n_probe, seed=0),
        auto_migrate=False))
    idx.initialize(vecs[:400])
    ts = np.full(n, NOW - 30 * DAY)
    ts[:recent] = NOW - DAY
    idx.insert_batch([f"v{i}" for i in range(n)], vecs, ts, now=NOW)
    for i in range(0, n, deletes or n + 1):
        idx.delete(f"v{i}")
    store = MemoryJ()
    PersisterJ(store).save_index_chunked(idx, "cold", chunk_size=chunk)
    return store, vecs


def _lazy_held(persister, store, ranges=True):
    """A lazy load whose materializer is parked before the search: at most
    one chunk resident. Returns (index, gated store)."""
    gs = GatedStore(store, ranges)
    loaded, _ = persister(gs).load_index_chunked("cold", lazy=True)
    assert not loaded.ready
    assert any(t.name == "fvdb-materialize" and t.daemon
               for t in threading.enumerate())
    loaded._cold.hold_materializer()
    gs.gate.set()
    return loaded


def _port(store):
    return HybridPersister(store, device="cpu")


def _queries(vecs, ids, seed=1):
    rng = np.random.default_rng(seed)
    q = vecs[ids].copy()
    q[1::2] += 0.05 * rng.standard_normal((q[1::2].shape)).astype(np.float32)
    return q


@pytest.mark.parametrize("ranges", [True, False])
def test_cold_answers_equal_the_reference_during_a_lazy_load(ranges):
    """Searches answered before the rows are resident: the same rows as
    the JAX package's cold serving over the same save, distances within
    1e-5, fetching only the probed spans (at most the materializer's one
    chunk resident); the warm index then agrees at rank 1."""
    store, vecs = _reference_save()
    picks = [5, 150, 450, 900, 1300, 1777, 1999, 60]
    q = _queries(vecs, picks)
    pt = _lazy_held(_port, store, ranges)
    pj = _lazy_held(PersisterJ, store, ranges)
    try:
        dt, rt = pt.search_rows(q, 10, config=SearchConfig(auto_migrate=False),
                                now=NOW)
        dj, rj = pj.search_rows(q, 10, config=SearchJ(auto_migrate=False),
                                now=NOW)
        assert not pt.ready and not pj.ready
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
        for st in (pt._cold.stats(), pj._cold.stats()):
            # whole-chunk fetches mark their chunks resident too; beyond
            # them, only the chunk the materializer was reading
            own = 0 if ranges else st["chunks_fetched_on_demand"]
            assert st["chunks_resident"] - own <= 1
            assert 0 < st["rows_fetched_on_demand"] < 2000
        for j in range(0, len(picks), 2):  # a stored row finds itself
            assert rt[j, 0] == pt.store.row_of(f"v{picks[j]}")
    finally:
        pt._cold.release_materializer()
        pj._cold.release_materializer()
    pt.wait_ready(timeout=WAIT_S)
    pj.wait_ready(timeout=WAIT_S)
    assert pt.ready and pt._cold is None
    dw, rw = pt.search_rows(q, 10, config=SearchConfig(auto_migrate=False),
                            now=NOW)
    np.testing.assert_array_equal(rw[::2, 0], rt[::2, 0])


def test_cold_scan_never_returns_deleted_or_masked_rows():
    """Every list probed: the cold answers equal the flat oracle over the
    live rows inside the extra mask, and the JAX package's."""
    store, vecs = _reference_save(n=1200, recent=100, n_clusters=8,
                                  n_probe=8, chunk=64, deletes=7)
    pt = _lazy_held(_port, store)
    pj = _lazy_held(PersisterJ, store)
    q = _queries(vecs, [100, 400, 555, 1111], seed=2)
    try:
        em = np.zeros(pt.store.capacity, bool)
        em[: pt.store.count] = True
        em[np.arange(0, pt.store.count, 3)] = False
        dt, rt = pt.search_rows(q, 8, config=SearchConfig(auto_migrate=False),
                                extra_mask=em, now=NOW)
        dj, rj = pj.search_rows(q, 8, config=SearchJ(auto_migrate=False),
                                extra_mask=em, now=NOW)
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    finally:
        pt._cold.release_materializer()
        pj._cold.release_materializer()
    pt.wait_ready(timeout=WAIT_S)
    live = pt.store.active_mask(pt.store.capacity) & em
    n = pt.store.count
    for j in range(q.shape[0]):
        dd = ((pt.store.data[:n].astype(np.float64) - q[j]) ** 2).sum(1)
        dd[~live[:n]] = np.inf
        want = np.argsort(dd, kind="stable")[:8]
        np.testing.assert_array_equal(rt[j], want)
        np.testing.assert_allclose(dt[j], np.sqrt(dd[want]), rtol=1e-5,
                                   atol=1e-5)
    pj.wait_ready(timeout=WAIT_S)


def test_cold_serving_off_waits_for_the_rows(monkeypatch):
    """FVDB_COLD_SERVE=0: the search waits for the materializer and then
    answers from the resident index, with nothing fetched on demand."""
    monkeypatch.setenv("FVDB_COLD_SERVE", "0")
    store, vecs = _reference_save(n=1000, recent=200, chunk=100)
    gs = GatedStore(store)
    loaded, _ = _port(gs).load_index_chunked("cold", lazy=True)
    assert not loaded.ready
    assert not loaded._cold_active(SearchConfig())
    cold = loaded._cold
    gs.gate.set()
    q = _queries(vecs, [10, 500], seed=3)
    d, rows = loaded.search_rows(q, 5, config=SearchConfig(auto_migrate=False),
                                 now=NOW)
    assert loaded.ready and loaded._cold is None
    assert cold.stats()["chunks_fetched_on_demand"] == 0
    dw, want = FlatIndex(loaded.store).search_rows(q, 5)
    np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_materializer_installs_the_staged_mirror(dtype, monkeypatch):
    """Once resident, the store holds the mirror the stager assembled: the
    version of the store, bit-identical to a fresh upload (bf16 rows with
    the f32 norms of the f32 host rows)."""
    monkeypatch.setenv("FVDB_SERVING_DTYPE", dtype)
    store, _ = _reference_save(n=900, recent=100, chunk=64)
    loaded, _ = _port(store).load_index_chunked("cold", lazy=True)
    loaded.wait_ready(timeout=WAIT_S)
    s = loaded.store
    m = s._mirror
    assert m is not None and m.version == s._version and m.dtype == dtype
    staged_x, staged_sq = m.x.clone(), m.x_sq.clone()
    s.release_mirror()
    fresh = s.device(dtype)
    assert torch.equal(staged_x, fresh.x)
    assert torch.equal(staged_sq, fresh.x_sq)
    # an eager load stages and installs the same
    eager, _ = _port(store).load_index_chunked("cold")
    assert torch.equal(eager.store._mirror.x, fresh.x)


def test_inserts_after_a_lazy_load_link_through_the_member_scatter(
        monkeypatch):
    """After a lazy load, ingest goes on through the pipelined build (the
    member scatter of every post-bootstrap batch, B1) and each new row is
    found at rank 1."""
    calls = []
    real = hnsw_t.set_member_rows

    def counting(mask, rows):
        calls.append(int(rows.shape[0]))
        return real(mask, rows)

    monkeypatch.setattr(hnsw_t, "set_member_rows", counting)
    store, vecs = _reference_save(n=1600, recent=1200, chunk=200)
    loaded, _ = _port(store).load_index_chunked("cold", lazy=True)
    rng = np.random.default_rng(4)
    new = rng.standard_normal((1100, D)).astype(np.float32)
    ids = [f"n{i}" for i in range(1100)]
    loaded.insert_batch(ids, new, np.full(1100, NOW), now=NOW)  # waits
    assert loaded.ready and sum(calls) >= 1024
    _, rows = loaded.search_rows(new, 1, config=SearchConfig(
        auto_migrate=False), now=NOW)
    want = np.array([loaded.store.row_of(i) for i in ids])
    assert (rows[:, 0] == want).mean() >= 0.99
