"""The graph and list engines at every row type and metric, the port
against the JAX package on the CPU.

One JAX hybrid index (800 recent rows in an HNSW graph, 1,600 old rows in
a 16-list IVF), built from seeded numpy data, is carried into the port with
``convert.hybrid_from_numpy``; the same arrays then go through both
packages: the pruned regime, standalone HNSW and IVF search and the link
plans on a bf16 mirror (FVDB_SERVING_DTYPE=bfloat16: bf16 rows upcast with
the f32 query and the f32 host rows' norms), the per-layer link plan, the
flat and IVF engines by metric (cosine, dot), the distance helpers and
``chunked_topk``. Rows are equal; squared distances agree within rtol 1e-5
and atol 2e-4 (the two packages sum dot products in another order; see
``test_torch_pruned.py``), cosine distances within 1e-5 and dot distances
within 1e-5 of |q||x|.
"""
import copy
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.index import fused as fused_j  # noqa: E402
from fabstir_vectordb_tpu.index import hnsw as hnsw_j  # noqa: E402
from fabstir_vectordb_tpu.index import ivf as ivf_j  # noqa: E402
from fabstir_vectordb_tpu.index.flat import FlatIndex as FlatJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridConfig as HybridConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridIndex as HybridJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import SearchConfig as SearchConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.ivf import IVFConfig as IVFConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.ivf import IVFIndex as IVFJ  # noqa: E402
from fabstir_vectordb_tpu.index.store import VectorStore as StoreJ  # noqa: E402
from fabstir_vectordb_tpu.ops import distance as dist_j  # noqa: E402
from fabstir_vectordb_tpu.ops import topk as topk_j  # noqa: E402
from fabstir_vectordb_tpu.utils import limits as limits_j  # noqa: E402
from fabstir_vectordb_tpu_torch import convert  # noqa: E402
from fabstir_vectordb_tpu_torch.index import fused as fused_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index import hnsw as hnsw_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index import ivf as ivf_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index.flat import FlatIndex  # noqa: E402
from fabstir_vectordb_tpu_torch.index.hybrid import (  # noqa: E402
    HybridConfig, SearchConfig)
from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig, IVFIndex  # noqa: E402
from fabstir_vectordb_tpu_torch.index.store import VectorStore  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import distance as dist_t  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import topk as topk_t  # noqa: E402
from fabstir_vectordb_tpu_torch.utils import limits as limits_t  # noqa: E402

D = 32
CPU = "cpu"
NOW = 1e9
N_RECENT, N_OLD = 800, 1600


def _mixture(seed, n, c=16, spread=0.6):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, D)).astype(np.float32) * 2
    x = centers[rng.integers(0, c, n)] + spread * rng.standard_normal((n, D))
    return x.astype(np.float32)


def _queries(x, seed, n, noise=0.3):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, x.shape[0], n)
    return (x[rows] + noise * rng.standard_normal((n, D))).astype(np.float32)


def _state(h):
    return {
        "store": {"data": h.store.data, "ids": h.store.row_to_id,
                  "timestamps": h.store.timestamps, "deleted": h.store.deleted},
        "hnsw": {"levels": h.hnsw.levels, "nbrs0": h.hnsw.nbrs0,
                 "nbrs_up": h.hnsw.nbrs_up, "up_offset": h.hnsw.up_offset,
                 "entry_point": h.hnsw.entry_point,
                 "max_level": h.hnsw.max_level, "up_count": h.hnsw.up_count},
        "ivf": {"centroids": h.ivf.centroids,
                "assignments": h.ivf.assignments},
    }


@pytest.fixture(scope="module")
def pair():
    """A JAX hybrid index and its port, carried across by convert."""
    n = N_RECENT + N_OLD
    x = _mixture(0, n)
    hj = HybridJ(D, HybridConfigJ(ivf=IVFConfigJ(n_clusters=16, n_probe=4),
                                  auto_migrate=False))
    rng = np.random.default_rng(1)
    hj.ivf.set_trained(x[rng.choice(n, 16, replace=False)])
    ts = np.full(n, NOW - 30 * 86400.0)
    ts[:N_RECENT] = NOW - 10.0
    hj.insert_batch([f"v{i}" for i in range(n)], x, ts, now=NOW)
    cfg = HybridConfig(ivf=IVFConfig(n_clusters=16, n_probe=4),
                       auto_migrate=False)
    ht = convert.hybrid_from_numpy(_state(hj), device=CPU, config=cfg)
    return hj, ht, x


@pytest.fixture
def bf16(monkeypatch):
    """Both packages serve a bf16 mirror."""
    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")


@pytest.fixture
def pruned(monkeypatch):
    """Both packages in the pruned regime, as bench.py forces it."""
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "0")
    monkeypatch.setenv("FVDB_PCA_SERVE", "0")
    for lim in (limits_j, limits_t):
        monkeypatch.setattr(lim, "FLAT_THRESHOLD", 0)


def _assert_same(dj, rj, dt, rt, atol=2e-4):
    """Rows equal in order; distances within rtol 1e-5 / atol; +inf where
    a row is -1."""
    dj, rj, dt, rt = (np.asarray(a) for a in (dj, rj, dt, rt))
    np.testing.assert_array_equal(rt, rj)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=1e-5, atol=atol)


def _bf16_arrays(h):
    """The pruned engines' state as both packages read it from a bf16
    mirror: the rows in bf16 (numpy, ml_dtypes), the f32 host norms."""
    n = h.store.capacity
    act = h.store.active_mask(n)
    hm = act & h.hnsw.member_mask(n)
    x = h.store.data
    return {"xb": x.astype(ml_dtypes.bfloat16), "x_sq": (x * x).sum(1),
            "hnsw_mask": hm, "ivf_mask": act & h.ivf.member_mask(n) & ~hm,
            "nbrs0": h.hnsw.nbrs0, "nbrs_up": h.hnsw.nbrs_up,
            "up_offset": h.hnsw.up_offset, "entry": h.hnsw.entry_point,
            "level": h.hnsw.max_level}


def _tb(a):
    """numpy -> torch, bf16 kept as bf16."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ kernels on bf16 rows
def test_greedy_descent_on_bf16_rows_matches_reference(pair):
    hj, _, x = pair
    a = _bf16_arrays(hj)
    q = _queries(x, 2, 24)
    stop = np.random.default_rng(3).integers(0, 3, 24).astype(np.int32)
    args = (a["xb"], a["x_sq"], a["hnsw_mask"], a["nbrs_up"],
            a["up_offset"], q)
    cj, dj = hnsw_j.greedy_descent_kernel(
        *(jnp.asarray(v) for v in args), a["entry"], a["level"],
        jnp.asarray(stop))
    ct, dt = hnsw_t.greedy_descent(*(_tb(v) for v in args), a["entry"],
                                   a["level"], torch.from_numpy(stop))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=2e-4)


@pytest.mark.parametrize("expand,filtered,layer", [
    (4, False, 0), (4, True, 0), (1, False, 1)])
def test_beam_search_on_bf16_rows_matches_reference(pair, expand, filtered,
                                                    layer):
    hj, _, x = pair
    a = _bf16_arrays(hj)
    b = 16
    q = _queries(x, 4, b)
    rng = np.random.default_rng(5)
    members = np.nonzero(a["hnsw_mask"] & (hj.hnsw.levels[
        :a["hnsw_mask"].shape[0]] >= layer))[0]
    start = rng.choice(members, (b, 2)).astype(np.int32)
    active = np.arange(b) % 5 != 2  # inactive queries pass through
    res = (np.arange(a["xb"].shape[0]) % 3 != 0) if filtered else None
    args = (a["xb"], a["x_sq"], a["hnsw_mask"], a["nbrs0"], a["nbrs_up"],
            a["up_offset"], q, start, active)
    dj, rj = hnsw_j.beam_search_kernel(
        *(jnp.asarray(v) for v in args), layer=layer, ef=32, max_iters=64,
        result_mask=None if res is None else jnp.asarray(res),
        has_result_mask=filtered, expand=expand)
    dt, rt = hnsw_t.beam_search(
        *(_tb(v) for v in args), layer=layer, ef=32, max_iters=64,
        result_mask=None if res is None else torch.from_numpy(res),
        expand=expand)
    _assert_same(dj, rj, dt, rt)
    assert (rt.numpy()[:, 0] >= 0).all()


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_ivf_search_on_bf16_rows_by_metric_matches_reference(pair, metric):
    """K12 over bf16 rows: the reference's einsum of the f32 query with the
    gathered bf16 rows, by metric, probes ranked by the same metric."""
    hj, _, x = pair
    a = _bf16_arrays(hj)
    tiles = hj.ivf._build_tiles()
    cents = hj.ivf.centroids
    q = _queries(x, 6, 12)
    vj, rj, pj = ivf_j.ivf_search_kernel(
        *(jnp.asarray(v) for v in (a["xb"], a["x_sq"], a["ivf_mask"], cents,
                                   tiles, q)), 16, 4, metric)
    lists = ivf_t.IVFLists.upload(cents, tiles, torch.device(CPU))
    vt, rt, pt = ivf_t.ivf_search(
        _tb(a["xb"]), _tb(a["x_sq"]), _tb(a["ivf_mask"]), lists, _tb(q), 16,
        4, metric=metric)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    atol = {"euclidean": 2e-4, "cosine": 1e-5, "dot": 2e-4}[metric]
    _assert_same(vj, rj, vt, rt, atol)


def test_hybrid_search_on_bf16_rows_matches_reference(pair):
    """K13 on bf16 rows, filtered and not."""
    hj, _, x = pair
    a = _bf16_arrays(hj)
    tiles = hj.ivf._build_tiles()
    cents = hj.ivf.centroids
    q = _queries(x, 7, 12)
    lists = ivf_t.IVFLists.upload(cents, tiles, torch.device(CPU))
    extra = np.arange(a["xb"].shape[0]) % 4 != 2
    for filtered in (False, True):
        ex = extra if filtered else np.ones_like(extra)
        arrs = (a["xb"], a["x_sq"], a["hnsw_mask"], a["ivf_mask"], ex,
                a["nbrs0"], a["nbrs_up"], a["up_offset"])
        vj, rj = fused_j.hybrid_search_kernel(
            *(jnp.asarray(v) for v in arrs), a["entry"], a["level"],
            jnp.asarray(cents), jnp.asarray(tiles), jnp.asarray(q), 16, 64,
            4, True, True, has_filter=filtered, beam_expand=4)
        vt, rt = fused_t.hybrid_search(
            *(_tb(v) for v in arrs), a["entry"], a["level"], lists, _tb(q),
            16, 64, 4, True, has_filter=filtered, beam_expand=4)
        _assert_same(vj, rj, vt, rt)


# ------------------------------------------ the engines' entry points on bf16
def test_pruned_regime_on_bf16_mirror_matches_reference(pair, bf16, pruned):
    hj, ht, x = pair
    assert ht.fused.serving_info()["regime"] == "pruned"
    q = _queries(x, 8, 16)
    cj, ct = SearchConfigJ(auto_migrate=False), SearchConfig(auto_migrate=False)
    mask = np.arange(ht.store.capacity) % 3 == 1
    for k in (10, 40):
        dj, rj = hj.search_rows(q, k, cj, now=NOW)
        dt, rt = ht.search_rows(q, k, ct, now=NOW)
        _assert_same(dj, rj, dt, rt)
        dj, rj = hj.search_rows(q, k, cj, extra_mask=mask, now=NOW)
        dt, rt = ht.search_rows(q, k, ct, extra_mask=mask, now=NOW)
        _assert_same(dj, rj, dt, rt)
        assert mask[rt[rt >= 0]].all()
    assert ht.store._mirror.x.dtype == torch.bfloat16
    assert ht.fused._dev["x"].dtype == torch.bfloat16


def test_per_engine_k_on_bf16_mirror_matches_reference(pair, bf16, pruned):
    hj, ht, x = pair
    q = _queries(x, 9, 8)
    mask = np.arange(ht.store.capacity) % 2 == 0
    for kw, em in (({"recent_k": 5, "historical_k": 10}, None),
                   ({"recent_k": 0, "historical_k": 7}, mask),
                   ({"recent_k": 12, "historical_k": 0}, None)):
        dj, rj = hj.search_rows(q, 10, SearchConfigJ(auto_migrate=False, **kw),
                                extra_mask=em, now=NOW)
        dt, rt = ht.search_rows(q, 10, SearchConfig(auto_migrate=False, **kw),
                                extra_mask=em, now=NOW)
        _assert_same(dj, rj, dt, rt)


def test_standalone_engines_on_bf16_mirror_match_reference(pair, bf16):
    hj, ht, x = pair
    q = _queries(x, 10, 12)
    mask = np.arange(ht.store.capacity) % 4 != 0
    for em in (None, mask):
        dj, rj = hj.hnsw.search_rows(q, 8, extra_mask=em)
        dt, rt = ht.hnsw.search_rows(q, 8, extra_mask=em)
        _assert_same(dj, rj, dt, rt)
        dj, rj = hj.ivf.search_rows(q, 8, n_probe=3, extra_mask=em)
        dt, rt = ht.ivf.search_rows(q, 8, n_probe=3, extra_mask=em)
        _assert_same(dj, rj, dt, rt)
    assert ht.store._mirror.x.dtype == torch.bfloat16


# ----------------------------------------------------------- the link plans
def _graph_pair(x, link_mode, ef=48):
    """Two stores of the same rows and a JAX graph of the first 300 built
    on the host, copied into the port's graph with its level generator."""
    sj, st = StoreJ(D), VectorStore(D, device=CPU)
    ids = [f"r{i}" for i in range(x.shape[0])]
    rows = sj.add_batch(ids, x)
    st.add_batch(ids, x)
    cfg = dict(bootstrap_threshold=128, ef_construction=ef,
               link_mode=link_mode)
    gj = hnsw_j.HNSWIndex(sj, hnsw_j.HNSWConfig(**cfg))
    gt = hnsw_t.HNSWIndex(st, hnsw_t.HNSWConfig(**cfg))
    gj.insert_rows(rows[:300])  # host-exact while the graph is small
    for name in ("levels", "nbrs0", "nbrs_up", "up_offset", "up_count",
                 "up_cap", "entry_point", "max_level"):
        v = getattr(gj, name)
        setattr(gt, name, v.copy() if isinstance(v, np.ndarray) else v)
    gt._rng = copy.deepcopy(gj._rng)
    gt._invalidate_device()
    gt._version += 1
    return gj, gt, rows


def _assert_graphs_close(gj, gt):
    """Equal levels and entry, >= 99% identical adjacency rows (the
    reverse-link prune meets near-ties that the two packages' sums may
    break differently)."""
    np.testing.assert_array_equal(gt.levels, gj.levels)
    assert (gt.entry_point, gt.max_level) == (gj.entry_point, gj.max_level)
    members = np.nonzero(gj.levels >= 0)[0]
    same0 = (gt.nbrs0[members] == gj.nbrs0[members]).all(1).mean()
    same_up = (gt.nbrs_up[:gj.up_count] == gj.nbrs_up[:gj.up_count]).all(
        1).mean()
    assert same0 >= 0.99 and same_up >= 0.99, (same0, same_up)
    dev = gt._device_arrays()  # the device adjacency followed the links
    np.testing.assert_array_equal(dev["nbrs0"].numpy(), gt.nbrs0)
    np.testing.assert_array_equal(dev["nbrs_up"].numpy(), gt.nbrs_up)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer0_link_plan_matches_reference(monkeypatch, dtype):
    monkeypatch.setenv("FVDB_SERVING_DTYPE", dtype)
    x = _mixture(21, 700)
    gj, gt, rows = _graph_pair(x, "layer0")
    batch = rows[300:]
    cj = gj._device_candidates(batch, np.zeros(batch.size, np.int32))
    ct = gt._device_candidates(batch, np.zeros(batch.size, np.int32))
    np.testing.assert_array_equal(ct["ids"], np.asarray(cj["ids"])[:batch.size])
    np.testing.assert_array_equal(ct["kept"],
                                  np.asarray(cj["kept"])[:batch.size])
    gj.insert_rows(batch)
    gt.insert_rows(batch)
    assert gt.store._mirror.x.dtype == getattr(torch, dtype)
    _assert_graphs_close(gj, gt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_layer_link_plan_matches_reference(monkeypatch, dtype):
    """A descent to each row's level, then a beam a layer down to 0
    (queries below a layer keep their entries), K4 at m0 or m: every
    layer's candidates equal the reference's; the rows then link one at a
    time as the reference's _link_batch does."""
    monkeypatch.setenv("FVDB_SERVING_DTYPE", dtype)
    x = _mixture(22, 450)  # the rows link one at a time in both packages
    gj, gt, rows = _graph_pair(x, "per_layer")
    batch = rows[300:]
    levels = np.random.default_rng(6).integers(0, 3, batch.size).astype(
        np.int32)
    cj = gj._device_candidates(batch, levels)
    ct = gt._device_candidates(batch, levels)
    assert cj["mode"] == ct["mode"] == "beam"
    assert sorted(ct["per_layer"]) == sorted(cj["per_layer"])
    assert max(ct["per_layer"]) >= 1
    for layer, (ids, d, kept) in ct["per_layer"].items():
        ids_j, d_j, kept_j = (np.asarray(v)[:batch.size]
                              for v in cj["per_layer"][layer])
        fin = np.isfinite(d_j)
        np.testing.assert_array_equal(np.isfinite(d), fin)
        np.testing.assert_allclose(d[fin], d_j[fin], rtol=1e-5, atol=2e-4)
        # equal, but for neighbours whose distances tie within f32 sums in
        # another order (they may trade places, which moves the flags)
        same = (ids == ids_j).all(1)
        assert same.mean() >= 0.99
        for b, c in np.argwhere(ids != ids_j):
            assert abs(d[b, c] - d_j[b, c]) <= 1e-5 * abs(d_j[b, c]), (b, c)
        np.testing.assert_array_equal(kept[same], kept_j[same])
    gj.insert_rows(batch)
    gt.insert_rows(batch)
    _assert_graphs_close(gj, gt)
    d, r = gt.search_rows(x[300:], 1)
    assert (r[:, 0] == np.arange(300, 450)).mean() >= 0.95


# --------------------------------------------------------------- metrics
def _flat_pair(dtype):
    x = _mixture(30, 1500)
    x[7] = 0.0  # a zero-norm row: cosine distance 1
    sj, st = StoreJ(D), VectorStore(D, device=CPU)
    sj.add_batch([f"f{i}" for i in range(1500)], x)
    st.add_batch([f"f{i}" for i in range(1500)], x)
    return sj, st, x


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_index_by_metric_matches_reference(metric, dtype):
    sj, st, x = _flat_pair(dtype)
    q = _queries(x, 31, 12)
    q[0] = 0.0  # a zero query: every cosine distance 1
    mask = np.arange(1500) % 5 != 3
    fj, ft = FlatJ(sj, metric=metric), FlatIndex(st, metric=metric)
    for em in (None, mask):
        dj, rj = fj.search_rows(q, 20, extra_mask=em, dtype=dtype)
        dt, rt = ft.search_rows(q, 20, extra_mask=em, dtype=dtype)
        scale = 1.0 if metric == "cosine" else float(
            np.linalg.norm(q, axis=1).max() * np.linalg.norm(x, axis=1).max())
        _assert_same(dj, rj, dt, rt, atol=1e-5 * scale)
    assert st._mirror.x.dtype == getattr(torch, dtype)
    if metric == "cosine":
        np.testing.assert_array_equal(dt[0], 1.0)  # the zero query
        full_t = ft.search_rows(x[8:9], 1500, dtype=dtype)
        assert full_t[0][0][list(full_t[1][0]).index(7)] == 1.0
    else:  # the zero query's distances are all -0
        assert (dt[1:, 0] < 0).all()
    assert [v for v, _ in ft.search(q[1], 3)] == \
        [v for v, _ in fj.search(q[1], 3)]


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_ivf_index_by_metric_matches_reference(metric):
    """IVFIndex.search_rows(metric=) with the same centroids installed in
    both packages: probes ranked by the metric, lists scanned by it."""
    x = _mixture(40, 2000)
    sj, st = StoreJ(D), VectorStore(D, device=CPU)
    rows = sj.add_batch([f"i{i}" for i in range(2000)], x)
    st.add_batch([f"i{i}" for i in range(2000)], x)
    cents = x[np.random.default_rng(41).choice(2000, 16, replace=False)]
    ij, it = IVFJ(sj), IVFIndex(st)
    for ix in (ij, it):
        ix.set_trained(cents)
        ix.insert_rows(rows)
    np.testing.assert_array_equal(it.assignments[:2000], ij.assignments[:2000])
    q = _queries(x, 42, 10)
    scale = 1.0 if metric == "cosine" else float(
        np.linalg.norm(q, axis=1).max() * np.linalg.norm(x, axis=1).max())
    for n_probe in (3, 16):
        dj, rj = ij.search_rows(q, 12, n_probe=n_probe, metric=metric)
        dt, rt = it.search_rows(q, 12, n_probe=n_probe, metric=metric)
        _assert_same(dj, rj, dt, rt, atol=1e-5 * scale)
    if metric == "dot":
        assert (dt[:, 0] < 0).all()
    # every list probed: the flat index over the same rows by the metric
    # (the two sum each dot product in another order)
    df, rf = FlatIndex(st, metric=metric).search_rows(q, 12)
    np.testing.assert_allclose(dt, df, rtol=1e-5, atol=1e-5 * scale)
    assert (rt == rf).mean() >= 0.99


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
@pytest.mark.parametrize("round_query", [False, True])
def test_pairwise_distance_matches_reference(metric, round_query):
    """ops.distance by metric, f32 compute or the bf16 mirror's (bf16 rows,
    the query rounded in the product, f32 norms)."""
    rng = np.random.default_rng(50)
    x = rng.standard_normal((300, D)).astype(np.float32)
    q = rng.standard_normal((7, D)).astype(np.float32)
    x_sq = (x * x).sum(1)
    xb = x.astype(ml_dtypes.bfloat16) if round_query else x
    dj = dist_j.pairwise_distance(
        jnp.asarray(q), jnp.asarray(xb), metric=metric, x_sq=jnp.asarray(x_sq),
        compute_dtype=jnp.bfloat16 if round_query else jnp.float32)
    dt = dist_t.pairwise_distance(torch.from_numpy(q), _tb(xb), metric,
                                  torch.from_numpy(x_sq), round_query)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=2e-4)


def test_distance_helpers_match_reference():
    """finalize_distance, inner_product_to_cosine and angular_distance on
    the reference's own cases (parallel, orthogonal, antiparallel, a zero
    vector) and on random pairs."""
    a = np.array([1.0, 0.0], np.float32)
    for b, want in (([2.0, 0.0], 0.0), ([0.0, 3.0], np.pi / 2),
                    ([-1.0, 0.0], np.pi), ([0.0, 0.0], np.pi / 2)):
        b = np.array(b, np.float32)
        got = float(dist_t.angular_distance(torch.from_numpy(a),
                                            torch.from_numpy(b)))
        ref = float(dist_j.angular_distance(jnp.asarray(a), jnp.asarray(b)))
        assert got == pytest.approx(ref, abs=1e-6)
        assert got == pytest.approx(want, abs=1e-6)
    z = torch.zeros(2)
    assert float(dist_t.inner_product_to_cosine(
        torch.tensor(0.0), torch.from_numpy(a), z)) == 0.0
    assert not np.isnan(float(dist_t.angular_distance(z, z)))
    rng = np.random.default_rng(51)
    u = rng.standard_normal((20, D)).astype(np.float32)
    v = rng.standard_normal((20, D)).astype(np.float32)
    ip = (u * v).sum(1)
    np.testing.assert_allclose(
        dist_t.inner_product_to_cosine(torch.from_numpy(ip),
                                       torch.from_numpy(u),
                                       torch.from_numpy(v)).numpy(),
        np.asarray(dist_j.inner_product_to_cosine(
            jnp.asarray(ip), jnp.asarray(u), jnp.asarray(v))), atol=1e-6)
    d = rng.standard_normal((4, 9)).astype(np.float32)
    for metric in ("euclidean", "cosine", "dot"):
        want = np.asarray(dist_j.finalize_distance(jnp.asarray(d), metric))
        np.testing.assert_allclose(dist_t.finalize_distance(d, metric), want,
                                   atol=1e-6)


@pytest.mark.parametrize("chunk,masked", [(32, False), (50, True)])
def test_chunked_topk_with_negative_distances_matches_reference(chunk,
                                                                masked):
    """chunked_topk over a dist_fn of negative dot distances (and a mask):
    the reference's fori_loop of masked top-k + merge."""
    import jax

    rng = np.random.default_rng(60)
    n, b, k = 4 * chunk, 3, 7
    x = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((b, 16)).astype(np.float32)
    keep = rng.random(n) < 0.6

    def fn_j(start):  # start is traced inside the reference's fori_loop
        xs = jax.lax.dynamic_slice_in_dim(jnp.asarray(x), start, chunk)
        m = jax.lax.dynamic_slice_in_dim(jnp.asarray(keep), start, chunk) \
            if masked else jnp.ones((chunk,), bool)
        return -(jnp.asarray(q) @ xs.T), m

    def fn_t(start):
        xs = torch.from_numpy(x)[start: start + chunk]
        m = torch.from_numpy(keep)[start: start + chunk] if masked else None
        return -(torch.from_numpy(q) @ xs.T), m

    vj, rj = topk_j.chunked_topk(fn_j, n, chunk, k, b)()
    vt, rt = topk_t.chunked_topk(fn_t, n, chunk, k, b, device=CPU)()
    _assert_same(vj, rj, vt, rt, atol=1e-5)
    assert (vt[:, 0] < 0).all()
    full = np.where(keep if masked else True, -(q @ x.T), np.inf)
    np.testing.assert_array_equal(
        rt.numpy(), np.argsort(full, axis=1, kind="stable")[:, :k])
