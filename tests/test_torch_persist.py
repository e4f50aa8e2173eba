"""The port's persistence against the JAX package's, on the CPU at a small
size: chunked hybrid saves byte for byte, loads across the two packages
(eager and lazy), incremental saves, integrity, backups, the per-engine
persisters, the composite format, IVF migration and the session's
save_to_s5 / load_user_vectors."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.api.session import VectorDBSession as SessionJ  # noqa: E402
from fabstir_vectordb_tpu.core.object_store import \
    MemoryObjectStore as MemoryJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridConfig as HybridConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridIndex as HybridJ  # noqa: E402
from fabstir_vectordb_tpu.index.ivf import IVFConfig as IVFConfigJ  # noqa: E402
from fabstir_vectordb_tpu.storage import persistence as persist_j  # noqa: E402
from fabstir_vectordb_tpu_torch.api.session import (  # noqa: E402
    INVALID_CONFIG, VectorDBError, VectorDBSession)
from fabstir_vectordb_tpu_torch.core.object_store import \
    MemoryObjectStore  # noqa: E402
from fabstir_vectordb_tpu_torch.index.hybrid import (  # noqa: E402
    HybridConfig, HybridIndex, SearchConfig)
from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig  # noqa: E402
from fabstir_vectordb_tpu_torch.storage import persistence as persist_t  # noqa: E402

NOW = 1_700_000_000.0
DAY = 86_400.0
D = 32
CPU = "cpu"


def _data(n=2000, seed=0, centers=None):
    rng = np.random.default_rng(seed)
    if centers is None:
        return rng.standard_normal((n, D)).astype(np.float32)
    c = rng.standard_normal((centers, D)).astype(np.float32) * 4
    return (c[rng.integers(0, centers, n)]
            + 0.3 * rng.standard_normal((n, D))).astype(np.float32)


def _fill(idx, x, recent=300, deletes=97):
    """The same calls into either package's index: centroids from the
    first rows, ``recent`` rows to HNSW (host-linked below the bootstrap
    threshold, so both graphs are the same), the rest to IVF, deletes."""
    n = x.shape[0]
    idx.ivf.set_trained(x[:8].copy())
    ts = np.full(n, NOW - 30 * DAY)
    ts[:recent] = NOW - DAY
    idx.insert_batch([f"v{i}" for i in range(n)], x, ts, now=NOW)
    for i in range(0, n, deletes):
        idx.delete(f"v{i}")
    return idx


def _near(x, rows):
    """Queries near stored rows, off them: at distance 0 the norm
    expansion leaves ~1e-6 of f32 cancellation, which the square root
    turns into ~1e-3 (ROADMAP C, f32 precision)."""
    noise = np.random.default_rng(len(rows)).standard_normal((len(rows), D))
    return (x[rows] + 0.3 * noise).astype(np.float32)


def _pair(x, **kw):
    cfg = dict(auto_migrate=False)
    j = _fill(HybridJ(D, HybridConfigJ(**cfg)), x, **kw)
    t = _fill(HybridIndex(D, HybridConfig(**cfg), device=CPU), x, **kw)
    return j, t


def _keys(store, prefix):
    return sorted(store.list_keys(prefix))


def _assert_same_bytes(a, b, prefix):
    ka, kb = _keys(a, prefix), _keys(b, prefix)
    assert ka == kb and ka
    for key in ka:
        assert a.get(key) == b.get(key), key


def _search(idx, q, k=10):
    return idx.search_rows(q, k, config=SearchConfig(auto_migrate=False),
                           now=NOW)


def test_chunked_saves_are_byte_equal_across_packages():
    """One index state saved by each package: every manifest, state, graph
    and chunk blob equal. Then each save loaded by both packages and saved
    again: the port's save of a load equals the JAX package's save of the
    same load (a load keeps the save's grouped row order, so neither
    package reproduces the first save's deleted-id order)."""
    x = _data()
    j, t = _pair(x)
    sj, st = MemoryJ(), MemoryObjectStore()
    persist_j.HybridPersister(sj).save_index_chunked(j, "s", chunk_size=256)
    persist_t.HybridPersister(st, device=CPU).save_index_chunked(
        t, "s", chunk_size=256)
    _assert_same_bytes(sj, st, "s/")
    for src in (sj, st):
        lt, _ = persist_t.HybridPersister(src, device=CPU) \
            .load_index_chunked("s")
        lj, _ = persist_j.HybridPersister(src).load_index_chunked("s")
        out_t, out_j = MemoryObjectStore(), MemoryJ()
        persist_t.HybridPersister(out_t, device=CPU).save_index_chunked(
            lt, "s", chunk_size=256)
        persist_j.HybridPersister(out_j).save_index_chunked(
            lj, "s", chunk_size=256)
        _assert_same_bytes(out_j, out_t, "s/")


@pytest.mark.parametrize("lazy", [False, True])
def test_loads_across_packages_answer_as_the_reference(lazy):
    """A JAX save loaded by the port (eagerly, or lazily and then
    resident) answers as the JAX package's own load: rows equal, distances
    within 1e-5; deleted rows stay deleted."""
    x = _data(seed=1)
    j, _ = _pair(x)
    store = MemoryJ()
    persist_j.HybridPersister(store).save_index_chunked(j, "s", chunk_size=300)
    lj, _ = persist_j.HybridPersister(store).load_index_chunked("s")
    lt, manifest = persist_t.HybridPersister(store, device=CPU) \
        .load_index_chunked("s", lazy=lazy)
    lt.wait_ready(timeout=120)
    assert manifest.total_vectors == 2000 and lt.store.count == 2000
    q = _near(x, [3, 400, 1001, 1999])
    dj, rj = _search(lj, q)
    dt, rt = _search(lt, q)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    assert sorted(lt.get_deleted_vectors()) == sorted(j.get_deleted_vectors())
    np.testing.assert_array_equal(lt.hnsw.nbrs0, lj.hnsw.nbrs0)
    np.testing.assert_array_equal(lt.ivf.assignments[:2000],
                                  lj.ivf.assignments[:2000])


def test_incremental_save_integrity_and_backup_as_the_reference():
    """Incremental saves skip the same unchanged chunks; a missing chunk is
    reported; a compressed backup restores the save byte for byte."""
    x = _data(seed=2)
    j, t = _pair(x)
    sj, st = MemoryJ(), MemoryObjectStore()
    pj = persist_j.HybridPersister(sj)
    pt = persist_t.HybridPersister(st, device=CPU)
    pj.save_index_chunked(j, "s", chunk_size=256)
    pt.save_index_chunked(t, "s", chunk_size=256)
    extra = _data(40, seed=3)
    for idx in (j, t):
        idx.insert_batch([f"w{i}" for i in range(40)], extra,
                         np.full(40, NOW - 30 * DAY), now=NOW)
    mj = pj.save_incremental(j, "s", chunk_size=256)
    mt = pt.save_incremental(t, "s", chunk_size=256)
    assert mt.extra["chunks_skipped_incremental"] \
        == mj.extra["chunks_skipped_incremental"] > 0
    _assert_same_bytes(sj, st, "s/")
    pt.backup("s", compress=True)
    before = {k: st.get(k) for k in _keys(st, "s/")}
    st.delete("s/chunks/chunk-3.cbor")
    info = pt.check_integrity("s")
    assert not info.ok and info.missing_chunks == ["chunk-3"]
    pt.restore_from_backup("s")
    assert pt.check_integrity("s").ok
    assert {k: st.get(k) for k in _keys(st, "s/")} == before


def test_engine_persisters_and_the_composite_format_across_packages():
    """HNSWPersister and IVFPersister (zstd lists) and the composite
    save_index: equal bytes from both packages, and each loads the other's
    save into the same graph, lists and answers."""
    x = _data(seed=4)
    j, t = _pair(x)
    sj, st = MemoryJ(), MemoryObjectStore()
    persist_j.HNSWPersister(sj).save_index(j.hnsw, "h")
    persist_t.HNSWPersister(st, CPU).save_index(t.hnsw, "h")
    persist_j.IVFPersister(sj, compress=True).save_index(j.ivf, "i")
    persist_t.IVFPersister(st, compress=True, device=CPU).save_index(t.ivf,
                                                                     "i")
    persist_j.HybridPersister(sj).save_index(j, "c")
    persist_t.HybridPersister(st, device=CPU).save_index(t, "c")
    for prefix in ("h/", "i/", "c/"):
        _assert_same_bytes(sj, st, prefix)
    hs, hi = persist_t.HNSWPersister(sj, CPU).load_index("h")
    np.testing.assert_array_equal(hi.nbrs0[:hs.count],
                                  t.hnsw.nbrs0[t.hnsw.member_rows()])
    _, ii = persist_t.IVFPersister(sj, device=CPU).load_index("i")
    np.testing.assert_array_equal(ii.centroids, t.ivf.centroids)
    assert ii.member_rows().size == t.ivf.member_rows().size
    lt, _ = persist_t.HybridPersister(sj, device=CPU).load_index("c")
    lj, _ = persist_j.HybridPersister(sj).load_index("c")
    q = _near(x, [10, 700, 1500])
    (dt, rt), (dj, rj) = _search(lt, q), _search(lj, q)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)


def _retrain_error(ivf, x_members):
    c = ivf.centroids.astype(np.float64)
    d = ((x_members[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    return float(d.min(1).mean())


def test_migrate_index_converges_as_the_reference():
    """IVFPersister.migrate_index retrains a saved IVF index at a new list
    count: the port's k-means draws from another RNG, so it is judged by
    its converged error (<= 1.5x the JAX package's), every active member
    assigned again, and the save reloads."""
    x = _data(3000, seed=5, centers=12)
    j, t = _pair(x, recent=0, deletes=50)
    sj, st = MemoryJ(), MemoryObjectStore()
    persist_j.IVFPersister(sj).save_index(j.ivf, "i")
    persist_t.IVFPersister(st, device=CPU).save_index(t.ivf, "i")
    new_j = IVFConfigJ(n_clusters=12, n_probe=4, seed=0)
    new_t = IVFConfig(n_clusters=12, n_probe=4, seed=0)
    persist_j.IVFPersister(sj).migrate_index("i", new_j, "m")
    persist_t.IVFPersister(st, device=CPU).migrate_index("i", new_t, "m")
    _, ij = persist_j.IVFPersister(sj).load_index("m")
    storet, it = persist_t.IVFPersister(st, device=CPU).load_index("m")
    assert it.centroids.shape == (12, D) and it.config.n_clusters == 12
    live = storet.active_mask()[: storet.count]
    assert it.member_rows().size == storet.count
    xm = storet.data[: storet.count][live]
    ej, et = _retrain_error(ij, xm), _retrain_error(it, xm)
    assert et <= 1.5 * ej + 1e-3, (et, ej)
    # retrain in place converges as well, and keeps the members
    stats = t.ivf.retrain(new_t)
    assert stats.final_error <= 1.5 * _retrain_error(ij, xm) + 1e-3
    assert t.ivf.member_rows().size == t.store.active_count  # the live ones


def _records(x, lo, hi):
    return [{"id": f"doc-{i}", "vector": x[i].tolist(),
             "metadata": {"cat": ["a", "b", "c"][i % 3], "n": i}}
            for i in range(lo, hi)]


@pytest.mark.parametrize("lazy", [False, True])
def test_session_save_and_load_round_trip_across_packages(lazy):
    """save_to_s5 -> load_user_vectors with metadata, a schema and
    filters: the port's load of its own save and of the JAX package's
    answer as the saving session did (ids and metadata, scores within
    1e-5), and the JAX package loads the port's save."""
    x = _data(1200, seed=6)
    cfg = {"sessionId": "sess", "storageMode": "mock", "chunkSize": 200}
    st = VectorDBSession.create(cfg, store=MemoryObjectStore(), device=CPU)
    sj = SessionJ.create(cfg, store=MemoryJ())
    schema = {"fields": {"cat": {"type": "string"}, "n": {"type": "number"}}}
    for s in (st, sj):
        s.set_schema(schema)
        for lo in range(0, 1200, 400):
            s.add_vectors(_records(x, lo, lo + 400))
        s.delete_vector("doc-7")
    assert st.save_to_s5() == sj.save_to_s5() == "sess"
    opts = {"lazyLoad": lazy}
    q = (x[11] + 0.1).tolist()
    want = st.search(q, 5, {"filter": {"cat": "c"}})
    assert all(r["metadata"]["cat"] == "c" for r in want)
    for src in (st.object_store, sj.object_store):
        back = VectorDBSession.create(cfg, store=src, device=CPU)
        back.load_user_vectors("sess", opts)
        back.index.wait_ready(timeout=120)
        got = back.search(q, 5, {"filter": {"cat": "c"}})
        assert [r["id"] for r in got] == [r["id"] for r in want]
        assert [r["metadata"] for r in got] == [r["metadata"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got],
                                   [r["score"] for r in want], rtol=1e-5,
                                   atol=1e-5)
        assert back.get_stats().vector_count == 1199
        assert back.schema is not None
    other = SessionJ.create(cfg, store=st.object_store)
    other.load_user_vectors("sess", {"lazyLoad": False})
    got = other.search(q, 5, {"filter": {"cat": "c"}})
    assert [r["id"] for r in got] == [r["id"] for r in want]


def test_session_create_checks_the_storage_mode_as_the_reference():
    cfg = {"sessionId": "x", "storageMode": "real", "s5Portal": "p"}
    with pytest.raises(VectorDBError) as e:
        VectorDBSession.create(cfg, device=CPU)
    assert e.value.code == INVALID_CONFIG
    with pytest.raises(Exception) as ej:
        SessionJ.create(cfg)
    assert ej.value.code == INVALID_CONFIG
    s = VectorDBSession.create({"sessionId": "x", "storageMode": "mock"},
                               device=CPU)
    assert isinstance(s.object_store, MemoryObjectStore)
    with pytest.raises(VectorDBError):
        s.save_to_s5()  # nothing to save yet
