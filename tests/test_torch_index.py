"""The port's index modules against the JAX package's, on the CPU.

The same rows, made with numpy from a seed, go into a JAX engine and its
port on ``device="cpu"``; graphs, assignments and search results are
compared. Tie order is taken out by sorting results by (distance, row).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.index import hnsw as hnsw_j  # noqa: E402
from fabstir_vectordb_tpu.index.flat import FlatIndex as FlatJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridConfig as HybridConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridIndex as HybridJ  # noqa: E402
from fabstir_vectordb_tpu.index.ivf import IVFIndex as IVFJ  # noqa: E402
from fabstir_vectordb_tpu.index.store import VectorStore as StoreJ  # noqa: E402
from fabstir_vectordb_tpu_torch import convert  # noqa: E402
from fabstir_vectordb_tpu_torch.index import hnsw as hnsw_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index.flat import FlatIndex, recall_at_k  # noqa: E402
from fabstir_vectordb_tpu_torch.index.hybrid import (  # noqa: E402
    HybridConfig, HybridIndex, SearchConfig)
from fabstir_vectordb_tpu_torch.index.ivf import IVFIndex  # noqa: E402
from fabstir_vectordb_tpu_torch.index.store import VectorStore  # noqa: E402
from fabstir_vectordb_tpu_torch.utils import limits  # noqa: E402

D = 32
CPU = "cpu"


def _data(seed, n, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _ids(n, prefix="v"):
    return [f"{prefix}{i}" for i in range(n)]


def _assert_same_results(dj, rj, dt, rt, rtol=1e-5):
    """Same rows and distances after ordering by (distance, row)."""
    def srt(d, r):
        d = np.asarray(d, np.float64)
        r = np.asarray(r, np.int64)
        o = np.lexsort((r, d), axis=1)
        return np.take_along_axis(d, o, 1), np.take_along_axis(r, o, 1)
    dj, rj = srt(dj, rj)
    dt, rt = srt(dt, rt)
    np.testing.assert_array_equal(rt, rj)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=rtol, atol=1e-5)


def test_store_and_flat_search_match_reference():
    x = _data(0, 3000)
    sj, st = StoreJ(D), VectorStore(D, device=CPU)
    rows_j = sj.add_batch(_ids(3000), x, 5.0)
    rows_t = st.add_batch(_ids(3000), x, 5.0)
    np.testing.assert_array_equal(rows_t, rows_j)
    for vid in ("v3", "v99", "v2500"):
        assert sj.mark_deleted(vid) and st.mark_deleted(vid)
    assert st.capacity == sj.capacity and st.count == sj.count
    np.testing.assert_array_equal(st.active_mask(), sj.active_mask())
    q = _data(1, 9)
    extra = np.random.default_rng(2).random(3000) < 0.6
    for mask in (None, extra):
        dj, rj = FlatJ(sj).search_rows(q, 10, extra_mask=mask)
        dt, rt = FlatIndex(st).search_rows(q, 10, extra_mask=mask)
        _assert_same_results(dj, rj, dt, rt)
    _, r_all = FlatIndex(st).search_rows(q, 10)
    assert recall_at_k(FlatIndex(st), r_all, q, 10) == 1.0
    assert recall_at_k(FlatIndex(st), rt, q, 10) < 1.0  # the filtered rows
    m = st.device_mirror()
    np.testing.assert_allclose(m.x_sq.numpy(), (x ** 2).sum(1)
                               .tolist() + [0.0] * (st.capacity - 3000),
                               rtol=1e-5)
    # re-upload only when the host copy changes
    assert st.device_mirror() is m
    st.mark_deleted("v4")
    assert st.device_mirror() is not m


def test_store_vacuum_and_reinsert_match_reference():
    x = _data(3, 50)
    sj, st = StoreJ(D), VectorStore(D, device=CPU)
    for s in (sj, st):
        s.add_batch(_ids(50), x)
        s.mark_deleted("v7")
        assert s.vacuum() == ["v7"]
        s.add_batch(["v7"], x[:1])
    assert st.row_to_id == sj.row_to_id
    np.testing.assert_array_equal(st.data, sj.data)


def test_ivf_assignments_match_reference():
    x = _data(4, 900)
    cents = _data(5, 6)
    out = []
    for store_cls, ivf_cls, kw in ((StoreJ, IVFJ, {}),
                                   (VectorStore, IVFIndex, {"device": CPU})):
        s = store_cls(D, **kw)
        rows = s.add_batch(_ids(900), x)
        ivf = ivf_cls(s)
        ivf.set_trained(cents)
        ivf.insert_rows(rows[::2])
        ivf.remove_rows(rows[:10])
        s.mark_deleted("v20")
        out.append((ivf.assignments.copy(), ivf.active_count,
                    ivf.deleted_count, ivf.vacuum()))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1:] == out[0][1:]


def test_ivf_train_converges_on_separated_clusters():
    rng = np.random.default_rng(6)
    centers = rng.standard_normal((3, D)).astype(np.float32) * 5
    x = (centers[np.arange(10) % 3]
         + 0.01 * rng.standard_normal((10, D))).astype(np.float32)
    s = VectorStore(D, device=CPU)
    ivf = IVFIndex(s, HybridConfig().ivf)
    stats = ivf.train(x)
    assert ivf.trained and ivf.centroids.shape == (3, D)
    assert stats.final_error < 0.01


def _build_pair(n, cfg_kw, monkeypatch, seed=7):
    """The same rows into a JAX and a port HNSW, with the device reverse
    prune forced on (small _PAIR_DEVICE_MIN / _KEPT_DEVICE_MIN in both)."""
    for mod in (hnsw_j, hnsw_t):
        monkeypatch.setattr(mod, "_PAIR_DEVICE_MIN", 2048)
        monkeypatch.setattr(mod, "_KEPT_DEVICE_MIN", 64)
    calls = {"pair": 0, "kept": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(hnsw_t, "pair_sq_l2", spy("pair", hnsw_t.pair_sq_l2))
    monkeypatch.setattr(hnsw_t, "heuristic_kept",
                        spy("kept", hnsw_t.heuristic_kept))
    x = _data(seed, n)
    sj, st = StoreJ(D), VectorStore(D, device=CPU)
    rows = sj.add_batch(_ids(n), x)
    st.add_batch(_ids(n), x)
    gj = hnsw_j.HNSWIndex(sj, hnsw_j.HNSWConfig(**cfg_kw))
    gt = hnsw_t.HNSWIndex(st, hnsw_t.HNSWConfig(**cfg_kw))
    gj.insert_rows(rows)
    gt.insert_rows(rows)
    return gj, gt, calls


def test_hnsw_build_matches_reference(monkeypatch):
    """1,500 rows with bootstrap_threshold=128: the host-exact bootstrap,
    then the pipelined device-candidate batches and the device reverse
    prune run in both packages. Levels are equal; at least 99% of nodes
    have identical layer-0 lists."""
    gj, gt, calls = _build_pair(1500, {"bootstrap_threshold": 128},
                                monkeypatch)
    assert calls["pair"] > 0 and calls["kept"] > 0
    np.testing.assert_array_equal(gt.levels, gj.levels)
    assert (gt.entry_point, gt.max_level) == (gj.entry_point, gj.max_level)
    members = np.nonzero(gj.levels >= 0)[0]
    assert members.size == 1500
    same = (gt.nbrs0[members] == gj.nbrs0[members]).all(axis=1).mean()
    assert same >= 0.99, same
    sj, st = gj.graph_stats(), gt.graph_stats()
    assert (st.num_nodes, st.max_layer) == (sj.num_nodes, sj.max_layer)
    assert abs(st.num_edges - sj.num_edges) <= 0.01 * sj.num_edges


def test_hnsw_remove_rows_and_entry_repair_match_reference(monkeypatch):
    """Removal scrubs the same links and repairs the entry point the same
    way, starting from the reference's own graph."""
    gj, gt, _ = _build_pair(400, {"bootstrap_threshold": 64}, monkeypatch,
                            seed=8)
    for name in ("levels", "nbrs0", "nbrs_up", "up_offset"):
        setattr(gt, name, getattr(gj, name).copy())
    gt.entry_point, gt.max_level = gj.entry_point, gj.max_level
    dead = np.array([gj.entry_point, 5, 17, 300])
    assert gt.remove_rows(dead) == gj.remove_rows(dead) == 4
    np.testing.assert_array_equal(gt.nbrs0, gj.nbrs0)
    np.testing.assert_array_equal(gt.nbrs_up, gj.nbrs_up)
    np.testing.assert_array_equal(gt.levels, gj.levels)
    assert gt.entry_point == gj.entry_point
    assert vars(gt.graph_stats()) == vars(gj.graph_stats())


def _hybrid_pair(n=600, seed=9, now=1e9):
    x = _data(seed, n)
    cfg_kw = dict(migration_batch_size=200)
    hj = HybridJ(D, HybridConfigJ(**cfg_kw))
    ht = HybridIndex(D, HybridConfig(**cfg_kw), device=CPU)
    hj.initialize(x[:10])
    ht.initialize(x[:10])
    # the two seedings draw from different RNGs: the same quantizer into
    # both, so row assignments can be compared
    ht.ivf.set_trained(hj.ivf.centroids)
    for h in (hj, ht):
        # two thirds recent, one third 30 days old
        ts = np.where(np.arange(n) % 3 == 0, now - 30 * 86400.0, now - 10.0)
        h.insert_batch(_ids(n), x, timestamps=ts, now=now)
    return hj, ht, x


def test_hybrid_search_matches_reference():
    hj, ht, x = _hybrid_pair()
    # the historical third went to IVF through the port's assignment
    assert ht.ivf.active_count == hj.ivf.active_count == 200
    q = _data(10, 16)
    now = 1e9
    cfg = SearchConfig(auto_migrate=False)
    from fabstir_vectordb_tpu.index.hybrid import SearchConfig as SCJ

    dj, rj = hj.search_rows(q, 10, SCJ(auto_migrate=False), now=now)
    dt, rt = ht.search_rows(q, 10, cfg, now=now)
    _assert_same_results(dj, rj, dt, rt)
    mask = np.arange(ht.store.capacity) % 2 == 0
    got = ht.search_with_filter(q[0], 5, {"a": 1}, row_mask=mask, now=now)
    want = hj.search_with_filter(q[0], 5, {"a": 1}, row_mask=mask, now=now)
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want],
                               rtol=1e-5)
    for h in (hj, ht):
        h.batch_delete(["v1", "v2", "v3", "nope"])
    dj, rj = hj.search_rows(q, 10, SCJ(auto_migrate=False), now=now)
    dt, rt = ht.search_rows(q, 10, cfg, now=now)
    _assert_same_results(dj, rj, dt, rt)
    assert (ht.hnsw.deleted_count, ht.ivf.deleted_count) == \
        (hj.hnsw.deleted_count, hj.ivf.deleted_count)
    assert vars(ht.stats(now=now)) == vars(hj.stats(now=now))


def test_hybrid_migration_and_vacuum_match_reference():
    hj, ht, _ = _hybrid_pair(n=600, seed=11)
    later = 1e9 + 8 * 86400.0  # everything is old now
    assert ht.migrate_old_vectors(now=later) == \
        hj.migrate_old_vectors(now=later) == 200
    for h in (hj, ht):
        h.delete("v1")
        h.delete("v2")
    assert ht.vacuum() == hj.vacuum()
    np.testing.assert_array_equal(ht.ivf.assignments, hj.ivf.assignments)
    np.testing.assert_array_equal(ht.hnsw.levels, hj.hnsw.levels)
    assert ht.get_deleted_vectors() == hj.get_deleted_vectors()


def test_convert_carries_a_jax_index_across():
    hj, _, _ = _hybrid_pair(n=600, seed=12)
    hj.delete("v5")
    state = {
        "store": {"data": hj.store.data, "ids": hj.store.row_to_id,
                  "timestamps": hj.store.timestamps,
                  "deleted": hj.store.deleted},
        "hnsw": {"levels": hj.hnsw.levels, "nbrs0": hj.hnsw.nbrs0,
                 "nbrs_up": hj.hnsw.nbrs_up, "up_offset": hj.hnsw.up_offset,
                 "entry_point": hj.hnsw.entry_point,
                 "max_level": hj.hnsw.max_level},
        "ivf": {"centroids": hj.ivf.centroids,
                "assignments": hj.ivf.assignments},
    }
    ht = convert.hybrid_from_numpy(state, device=CPU)
    assert ht.hnsw.up_count == hj.hnsw.up_count
    q = _data(13, 12)
    from fabstir_vectordb_tpu.index.hybrid import SearchConfig as SCJ

    dj, rj = hj.search_rows(q, 10, SCJ(auto_migrate=False))
    dt, rt = ht.search_rows(q, 10, SearchConfig(auto_migrate=False))
    _assert_same_results(dj, rj, dt, rt)
    assert vars(ht.stats(now=1e9)) == vars(hj.stats(now=1e9))
    assert vars(ht.hnsw.graph_stats()) == vars(hj.hnsw.graph_stats())


def test_unported_serving_branches_raise(monkeypatch):
    """bf16 mirrors, approximate flat selection, stores above the flat
    threshold and per-engine k raise instead of serving some other way."""
    _, ht, _ = _hybrid_pair(n=300, seed=14)
    q = _data(15, 2)
    cfg = SearchConfig(auto_migrate=False)
    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")
    with pytest.raises(NotImplementedError):
        ht.search_rows(q, 5, cfg)
    monkeypatch.delenv("FVDB_SERVING_DTYPE")
    monkeypatch.setenv("FVDB_FLAT_SELECT", "approx")
    with pytest.raises(NotImplementedError):
        ht.search_rows(q, 5, cfg)
    monkeypatch.delenv("FVDB_FLAT_SELECT")
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "256")
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 256)
    with pytest.raises(NotImplementedError):
        ht.search_rows(q, 5, cfg)
    monkeypatch.delenv("FVDB_FLAT_THRESHOLD")
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 4_194_304)
    with pytest.raises(NotImplementedError):
        ht.search_rows(q, 5, SearchConfig(recent_k=3, auto_migrate=False))
    assert ht.search_rows(q, 5, cfg)[1].shape == (2, 5)


def test_link_candidates_above_flat_threshold_raise(monkeypatch):
    """A member prefix above the flat threshold needs the graph-beam
    candidate plan, which is not ported: insert raises."""
    st = VectorStore(D, device=CPU)
    rows = st.add_batch(_ids(60), _data(16, 60))
    g = hnsw_t.HNSWIndex(st, hnsw_t.HNSWConfig(bootstrap_threshold=8))
    g.insert_rows(rows[:40])  # host-exact while the graph is small
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "16")
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 16)
    with pytest.raises(NotImplementedError):
        g.insert_rows(rows[40:])


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorStore(D)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HybridIndex(D)
    assert VectorStore(D, device=CPU).device.type == "cpu"
