"""bf16 serving and approximate ("turbo") flat selection, the port against
the JAX package on the CPU; the host row norms and id registration.

The same rows, made with numpy from a seed, go into a JAX index and its
port on ``device="cpu"`` (the kernels' plain versions). The flat regime is
served under FVDB_SERVING_DTYPE=bfloat16 in its three modes (host refine,
device re-score only, raw) and under FVDB_FLAT_SELECT=approx. JAX's CPU
``approx_min_k`` returns the exact top-k, so the port's binned pool (K9's
plain version) equals it where its bin count reaches the row count, and is
held to its expected recall where it does not.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.index import hnsw as hnsw_j  # noqa: E402
from fabstir_vectordb_tpu.index.flat import FlatIndex as FlatJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridConfig as HybridConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridIndex as HybridJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import SearchConfig as SearchConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.store import VectorStore as StoreJ  # noqa: E402
from fabstir_vectordb_tpu.utils import limits as limits_j  # noqa: E402
from fabstir_vectordb_tpu_torch.index import hnsw as hnsw_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index import store as store_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index.flat import FlatIndex  # noqa: E402
from fabstir_vectordb_tpu_torch.index.hybrid import (  # noqa: E402
    HybridConfig, HybridIndex, SearchConfig)
from fabstir_vectordb_tpu_torch.index.store import (  # noqa: E402
    DuplicateIdError, VectorStore)
from fabstir_vectordb_tpu_torch.ops import topk as topk_t  # noqa: E402
from fabstir_vectordb_tpu_torch.utils import limits  # noqa: E402

D = 32
CPU = "cpu"
NOW = 1_700_000_000.0
DAY = 86_400.0
KNOBS = ("FVDB_SERVING_DTYPE", "FVDB_FLAT_SELECT", "FVDB_BF16_RERANK",
         "FVDB_BF16_REFINE", "FVDB_BF16_OVERSAMPLE", "FVDB_FLAT_OVERSAMPLE",
         "FVDB_FLAT_THRESHOLD", "FVDB_PCA_SERVE")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for key in KNOBS:
        monkeypatch.delenv(key, raising=False)


def _data(seed, n, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _ids(n, prefix="v"):
    return [f"{prefix}{i}" for i in range(n)]


def _cloud(seed, n, d=D):
    """A near-duplicate cloud: every row 0.3-scaled noise around one base
    point, so many rows sit at nearly the same distance from a query near
    the base, and bf16 rounding reorders them."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(d).astype(np.float32) * 2
    x = base[None, :] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32), base


def _pair(x):
    """The same rows into a JAX and a port hybrid index, all 30 days old
    (IVF members; the flat regime serves them all), on one quantizer."""
    n = x.shape[0]
    hj = HybridJ(D, HybridConfigJ(auto_migrate=False))
    ht = HybridIndex(D, HybridConfig(auto_migrate=False), device=CPU)
    hj.initialize(x[:100])
    ht.initialize(x[:100])
    ht.ivf.set_trained(hj.ivf.centroids)
    ts = np.full(n, NOW - 30 * DAY)
    for h in (hj, ht):
        h.insert_batch(_ids(n), x, ts, now=NOW)
    return hj, ht


def _search(hj, ht, q, k, **kw):
    dj, rj = hj.search_rows(q, k, config=SearchConfigJ(auto_migrate=False),
                            now=NOW, **kw)
    dt, rt = ht.search_rows(q, k, config=SearchConfig(auto_migrate=False),
                            now=NOW, **kw)
    return np.asarray(dj), np.asarray(rj), dt, rt


def _exact(x, q, k):
    """Exact squared distances of q to every row of x in float64, and the
    k nearest rows of each query by (distance, row)."""
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64))
         ** 2).sum(-1)
    return d, np.argsort(d, axis=1, kind="stable")[:, :k]


def _hits(rows, want):
    return np.mean([len(set(r.tolist()) & set(w.tolist())) / len(w)
                    for r, w in zip(rows, want)])


@pytest.fixture(scope="module")
def cloud_pair():
    x, base = _cloud(3, 2048)
    hj, ht = _pair(x)
    rng = np.random.default_rng(5)
    q = (base[None, :] + 0.01 * rng.standard_normal((8, D))).astype(
        np.float32)
    return hj, ht, x, q


def test_bf16_refine_is_exact_and_matches_reference(cloud_pair,
                                                    monkeypatch):
    """The default bf16 mode: K1 on the bf16 mirror (query rounded) to a
    pool of 128, K2's f32 re-score to 64, then the host re-score from the
    f32 rows. Rows equal the exact f32 oracle's and JAX's; the returned
    distances are the exact f32 distances (test_regime_ladder.py's
    test_bf16_host_refine_exact_vs_canonical_f32)."""
    hj, ht, x, q = cloud_pair
    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")
    d64, want = _exact(x, q, 10)
    dj, rj, dt, rt = _search(hj, ht, q, 10)
    assert ht.store._mirror.x.dtype == torch.bfloat16
    np.testing.assert_array_equal(rt, want)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_allclose(dt, np.sqrt(np.take_along_axis(d64, want, 1)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=1e-6)


def test_bf16_rerank_only_is_exact_for_the_stored_rows(cloud_pair,
                                                       monkeypatch):
    """FVDB_BF16_REFINE=0: the device re-score alone ranks exactly with
    respect to the bf16-stored rows (rounded with ml_dtypes)."""
    hj, ht, x, q = cloud_pair
    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")
    monkeypatch.setenv("FVDB_BF16_REFINE", "0")
    stored = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    d64, want = _exact(stored, q, 10)
    dj, rj, dt, rt = _search(hj, ht, q, 10)
    np.testing.assert_array_equal(rt, want)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_allclose(dt, np.sqrt(np.take_along_axis(d64, want, 1)),
                               rtol=1e-5)


def test_bf16_raw_scan_misses_near_ties_as_the_reference_does(cloud_pair,
                                                              monkeypatch):
    """FVDB_BF16_RERANK=0: the raw mixed-precision scan (bf16 query in the
    product, f32 norms of the f32 rows) misranks the near-duplicate cloud
    in both packages, against the exact answer for the bf16-stored rows."""
    hj, ht, x, q = cloud_pair
    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")
    monkeypatch.setenv("FVDB_BF16_RERANK", "0")
    stored = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    _, want = _exact(stored, q, 10)
    dj, rj, dt, rt = _search(hj, ht, q, 10)
    assert _hits(rj, want) < 1.0 and _hits(rt, want) < 1.0
    # the same precision mix: the raw distances agree with the reference's
    np.testing.assert_allclose(np.sort(dt, 1), np.sort(dj, 1), rtol=1e-4)


@pytest.mark.parametrize("mode", ["refine", "rerank", "raw", "approx"])
def test_bf16_top1_on_separated_data_matches_reference(mode, monkeypatch):
    x = _data(11, 1500) * 3
    hj, ht = _pair(x)
    q = x[:40] + 0.01 * _data(12, 40)
    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")
    if mode == "rerank":
        monkeypatch.setenv("FVDB_BF16_REFINE", "0")
    elif mode == "raw":
        monkeypatch.setenv("FVDB_BF16_RERANK", "0")
    elif mode == "approx":
        monkeypatch.setenv("FVDB_FLAT_SELECT", "approx")
    dj, rj, dt, rt = _search(hj, ht, q, 5)
    np.testing.assert_array_equal(rt[:, 0], rj[:, 0])
    np.testing.assert_array_equal(rt[:, 0], np.arange(40))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_approx_flat_matches_reference_where_the_pool_is_exact(dtype,
                                                               monkeypatch):
    """2,000 rows, capacity 2,048, a pool of 128: 2,477 bins cover every
    row, so K9's pool is exact, as JAX's CPU approx_min_k is; K2's re-score
    to k then equals JAX's and the exact kernel's answer."""
    x = _data(13, 2000)
    hj, ht = _pair(x)
    assert ht.store.capacity == 2048
    assert topk_t.approx_bins(2048, 128) == 2048
    q = _data(14, 16)
    monkeypatch.setenv("FVDB_SERVING_DTYPE", dtype)
    _, _, d_exact, r_exact = _search(hj, ht, q, 10)
    monkeypatch.setenv("FVDB_FLAT_SELECT", "approx")
    dj, rj, dt, rt = _search(hj, ht, q, 10)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    if dtype == "float32":
        np.testing.assert_array_equal(rt, r_exact)
        np.testing.assert_allclose(dt, d_exact, rtol=1e-5, atol=1e-5)


def test_approx_bins_and_binned_pool_recall():
    """The bin count follows the expected-recall rule; at N = 4,096 with a
    pool of 16 (293 bins) the binned pool keeps >= 0.90 of the exact pool;
    with as many bins as rows it is the exact pool; ties in a bin go to
    the lower row."""
    assert topk_t.approx_bins(1_048_576, 128) == 2477
    assert topk_t.approx_bins(4096, 16) == 293
    assert topk_t.approx_bins(100, 1) == 100
    assert topk_t.approx_bins(10, 16) == 10
    g = torch.Generator().manual_seed(0)
    d = torch.rand(64, 4096, generator=g)
    vp, rp = topk_t.masked_approx_topk(d, None, 16)
    ve, re = topk_t.masked_topk(d, None, 16)
    assert _hits(rp.numpy(), re.numpy()) >= 0.90
    # every pooled row is its bin's minimum: no other row of the bin beats it
    m = 293
    for b in range(4):
        for v, r in zip(vp[b].tolist(), rp[b].tolist()):
            assert d[b, r % m::m].min().item() == v
    small = d[:, :2000]
    vs, rs = topk_t.masked_approx_topk(small, None, 128)
    ve, re = topk_t.masked_topk(small, None, 128)
    assert torch.equal(rs, re) and torch.equal(vs, ve)
    ties = torch.zeros(1, 600)
    vt, rt = topk_t.masked_approx_topk(ties, None, 16)  # 293 bins
    assert rt[0].tolist() == list(range(16))


def test_approx_masks_and_deletes_never_reenter(monkeypatch):
    """At 4,096 rows (binned: 2,477 bins) a filtered search and deleted
    rows: no filtered-out or deleted row is returned, and every filtered
    answer is a member of the filter."""
    x = _data(15, 4000)
    _, ht = _pair(x)
    ht.batch_delete([f"v{i}" for i in range(0, 4000, 7)])
    monkeypatch.setenv("FVDB_FLAT_SELECT", "approx")
    q = x[:32] + 0.01 * _data(16, 32)
    cfg = SearchConfig(auto_migrate=False)
    _, rows = ht.search_rows(q, 10, cfg, now=NOW)
    assert (rows >= 0).all() and not (rows % 7 == 0).any()
    fmask = np.arange(ht.store.capacity) % 3 == 1
    _, rows = ht.search_rows(q, 10, cfg, extra_mask=fmask, now=NOW)
    ok = rows >= 0
    assert ok.any() and fmask[rows[ok]].all() and not (rows[ok] % 7 == 0).any()
    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")
    _, rows = ht.search_rows(q, 10, cfg, extra_mask=fmask, now=NOW)
    ok = rows >= 0
    assert ok.any() and fmask[rows[ok]].all() and not (rows[ok] % 7 == 0).any()


def test_serving_info_and_knobs_match_reference(monkeypatch):
    hj, ht = _pair(_data(17, 300))
    for env in ({}, {"FVDB_FLAT_SELECT": "approx"},
                {"FVDB_FLAT_SELECT": "approx", "FVDB_FLAT_OVERSAMPLE": "64"},
                {"FVDB_FLAT_SELECT": "approx", "FVDB_FLAT_OVERSAMPLE": "2"},
                {"FVDB_SERVING_DTYPE": "bfloat16"},
                {"FVDB_BF16_OVERSAMPLE": "8", "FVDB_BF16_RERANK": "0",
                 "FVDB_BF16_REFINE": "0"}):
        for key in KNOBS:
            monkeypatch.delenv(key, raising=False)
        for key, v in env.items():
            monkeypatch.setenv(key, v)
        assert ht.fused.serving_info() == hj.fused.serving_info(), env
        for fn in ("bf16_rerank", "bf16_host_refine", "bf16_oversample",
                   "flat_select", "flat_oversample", "serving_dtype",
                   "effective_flat_threshold"):
            assert getattr(limits, fn)() == getattr(limits_j, fn)(), (fn, env)
    monkeypatch.setenv("FVDB_FLAT_SELECT", "fast")
    for lim in (limits, limits_j):
        with pytest.raises(ValueError):
            lim.flat_select()


def test_ingest_under_bf16_matches_reference(monkeypatch):
    """Inserts under a bf16 mirror: HNSW link candidates from K1 on bf16
    rows (f32 query), K4 and K5 on bf16 rows in the reverse prune (forced
    on), and IVF assignment of upcast mirror rows. The graphs keep >= 99%
    identical layer-0 rows against JAX's; IVF assignments are equal."""
    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")
    for mod in (hnsw_j, hnsw_t):
        monkeypatch.setattr(mod, "_PAIR_DEVICE_MIN", 2048)
        monkeypatch.setattr(mod, "_KEPT_DEVICE_MIN", 64)
    calls = {"pair": 0, "kept": 0, "topk": 0}
    real = {"pair": hnsw_t.pair_sq_l2, "kept": hnsw_t.heuristic_kept,
            "topk": hnsw_t.l2_topk}

    def spy(name):
        def wrapped(x, *a, **k):
            if x.dtype == torch.bfloat16:
                calls[name] += 1
            return real[name](x, *a, **k)
        return wrapped

    monkeypatch.setattr(hnsw_t, "pair_sq_l2", spy("pair"))
    monkeypatch.setattr(hnsw_t, "heuristic_kept", spy("kept"))
    monkeypatch.setattr(hnsw_t, "l2_topk", spy("topk"))
    x = _data(18, 1500)
    sj, st = StoreJ(D), VectorStore(D, device=CPU)
    rows = sj.add_batch(_ids(1500), x)
    st.add_batch(_ids(1500), x)
    gj = hnsw_j.HNSWIndex(sj, hnsw_j.HNSWConfig(bootstrap_threshold=128))
    gt = hnsw_t.HNSWIndex(st, hnsw_t.HNSWConfig(bootstrap_threshold=128))
    gj.insert_rows(rows)
    gt.insert_rows(rows)
    assert min(calls.values()) > 0, calls
    assert st._mirror.x.dtype == torch.bfloat16
    np.testing.assert_array_equal(gt.levels, gj.levels)
    same = (gt.nbrs0[:1500] == gj.nbrs0[:1500]).all(axis=1).mean()
    assert same >= 0.99, same
    hj, ht = _pair(_data(19, 600))
    np.testing.assert_array_equal(ht.ivf.assignments[:600],
                                  hj.ivf.assignments[:600])
    more = _data(20, 300) * 1.5
    for h in (hj, ht):
        h.insert_batch(_ids(300, "w"), more, np.full(300, NOW - 30 * DAY),
                       now=NOW)
    assert ht.store._mirror.x.dtype == torch.bfloat16
    np.testing.assert_array_equal(ht.ivf.assignments[:900],
                                  hj.ivf.assignments[:900])


@pytest.mark.parametrize("env", [{}, {"FVDB_SERVING_DTYPE": "bfloat16"},
                                 {"FVDB_FLAT_SELECT": "approx"}])
def test_search_rows_pipelined_equals_per_batch(env, monkeypatch):
    hj, ht = _pair(_data(21, 900))
    for key, v in env.items():
        monkeypatch.setenv(key, v)
    batches = [_data(22 + i, b) for i, b in enumerate((7, 16, 1, 9, 16))]
    cfg = SearchConfig(auto_migrate=False)
    got = ht.search_rows_pipelined(batches, 10, cfg, now=NOW, depth=3)
    ref = hj.search_rows_pipelined(batches, 10, SearchConfigJ(
        auto_migrate=False), now=NOW, depth=3)
    assert len(got) == len(batches)
    for (d, r), qb, (dj, rj) in zip(got, batches, ref):
        d1, r1 = ht.search_rows(qb, 10, cfg, now=NOW)
        np.testing.assert_array_equal(r, r1)
        np.testing.assert_array_equal(d, d1)
        np.testing.assert_array_equal(r[:, 0], np.asarray(rj)[:, 0])


def test_flat_index_dtype_pins_the_mirror():
    x = _data(30, 1000) * 2
    sj, st = StoreJ(D), VectorStore(D, device=CPU)
    sj.add_batch(_ids(1000), x)
    st.add_batch(_ids(1000), x)
    q = x[:20] + 0.01 * _data(31, 20)
    for dtype in ("bfloat16", "float32", None):
        dj, rj = FlatJ(sj).search_rows(q, 5, dtype=dtype)
        dt, rt = FlatIndex(st).search_rows(q, 5, dtype=dtype)
        want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        assert st._mirror.x.dtype == want
        np.testing.assert_array_equal(rt[:, 0], np.asarray(rj)[:, 0])
        # squared distances: the norm expansion cancels near a stored row,
        # so the two sum orders agree to f32 precision of the norms' scale
        scale = float((x ** 2).sum(1).max() + (q ** 2).sum(1).max())
        np.testing.assert_allclose(dt ** 2, np.asarray(dj) ** 2, rtol=1e-5,
                                   atol=2e-5 * scale)


def test_pruned_regime_on_bf16_raises(monkeypatch):
    """The pruned regime, HNSW search and IVF search serve a bf16 mirror
    (K10-K13 on bf16 rows, upcast, with the f32 query and the host rows'
    norms) once that regime is chosen, with the rows the JAX package
    returns; the flat and reduced-rank regimes serve as before. What still
    raises is a metric that does not exist."""
    x = _data(32, 500)
    hj, ht = _pair(x)
    for h in (hj, ht):
        h.insert_batch(_ids(200, "r"), _data(33, 200), np.full(200, NOW),
                       now=NOW)
    q = _data(34, 3)
    cfg = SearchConfig(auto_migrate=False)
    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")
    assert ht.search_rows(q, 5, cfg, now=NOW)[1].shape == (3, 5)
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "256")
    for lim in (limits, limits_j):
        monkeypatch.setattr(lim, "FLAT_THRESHOLD", 256)
    assert ht.fused.serving_info()["regime"] == "reduced-rank"
    assert (ht.search_rows(q, 5, cfg, now=NOW)[1] >= 0).all()
    monkeypatch.setenv("FVDB_PCA_SERVE", "0")
    assert ht.fused.serving_info()["regime"] == "pruned"
    dj, rj, dt, rt = _search(hj, ht, q, 5)
    assert ht.store._mirror.x.dtype == torch.bfloat16
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=2e-4)
    for engine in ("hnsw", "ivf"):
        dj, rj = getattr(hj, engine).search_rows(q, 5)
        dt, rt = getattr(ht, engine).search_rows(q, 5)
        assert (rt >= 0).all()
        np.testing.assert_array_equal(rt, np.asarray(rj))
        np.testing.assert_allclose(dt, np.asarray(dj), rtol=1e-5, atol=2e-4)
    with pytest.raises(ValueError, match="metric"):
        ht.ivf.search_rows(q, 5, metric="hamming")


def test_host_norms_cover_count_and_survive_deletes(monkeypatch):
    """host_sq: the f32 norms of the count allocated rows (0 past it),
    within 1e-6 of the reference's; a soft delete keeps the cached array,
    a row-data change recomputes it; the bf16 mirror carries them."""
    x = _data(40, 1000)
    sj, st = StoreJ(D), VectorStore(D, device=CPU)
    sj.add_batch(_ids(1000), x)
    st.add_batch(_ids(1000), x)
    calls = []
    real = store_t.row_sq_norms
    monkeypatch.setattr(store_t, "row_sq_norms",
                        lambda d, out: calls.append(d.shape[0]) or real(d, out))
    sq = st.host_sq()
    assert calls == [1000] and sq.shape == (st.capacity,)
    np.testing.assert_allclose(sq, sj.host_sq(), rtol=1e-6)
    assert (sq[1000:] == 0).all()
    st.mark_deleted("v3")
    assert st.host_sq() is sq and calls == [1000]
    assert st.device("bfloat16").x_sq.numpy() is not None
    np.testing.assert_array_equal(st._mirror.x_sq.numpy(), sq)
    assert calls == [1000]
    st.fill_rows(0, x[:2] * 2)
    sq2 = st.host_sq()
    assert calls == [1000, 1000]
    np.testing.assert_allclose(sq2[:2], (4 * x[:2] ** 2).sum(1), rtol=1e-6)
    st.add_batch(["extra"], x[:1])
    assert st.host_sq().shape == (st.capacity,) and calls[-1] == 1001
    big = _data(41, 200_000)
    np.testing.assert_array_equal(
        store_t.row_sq_norms(big, np.empty(200_000, np.float32)),
        np.einsum("nd,nd->n", big, big, dtype=np.float32))


def test_check_new_ids_cases():
    """Duplicates within a batch raise; a live duplicate raises and
    releases nothing; a soft-deleted id is released and mapped to its new
    row; ids into an empty store or not yet mapped pass."""
    st = VectorStore(D, device=CPU)
    with pytest.raises(DuplicateIdError, match="within batch"):
        st.add_batch(["a", "b", "a"], _data(42, 3))
    assert st.count == 0
    st.register_rows(_ids(5))  # an empty map: nothing to look up
    st.add_batch(["x", "y"], _data(43, 2))
    st.mark_deleted("v1")
    with pytest.raises(DuplicateIdError, match="duplicate vector id: v2"):
        st.add_batch(["v1", "v2"], _data(44, 2))
    assert st.row_of("v1") == 1 and st.row_to_id[1] == "v1"
    rows = st.add_batch(["v1", "z"], _data(45, 2))
    assert st.row_of("v1") == rows[0] and st.row_to_id[1] is None
    assert st.is_deleted("v1") is False and bool(st.deleted[1])
    sj = StoreJ(D)
    sj.register_rows(_ids(5))
    sj.add_batch(["x", "y"], _data(43, 2))
    sj.mark_deleted("v1")
    sj.add_batch(["v1", "z"], _data(45, 2))
    assert sj.id_to_row == st.id_to_row and sj.row_to_id == st.row_to_id
