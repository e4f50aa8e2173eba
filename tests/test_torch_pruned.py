"""The port's pruned-regime search against the JAX package's, on the CPU.

One JAX hybrid index (an HNSW graph of the recent rows, an IVF over the
old ones), built from seeded numpy data, is carried into the port with
``convert.hybrid_from_numpy``; the same arrays then go through the JAX
package's jitted programs and the port's kernels, which take their plain
versions on CPU tensors. Graph walks and list scans must agree exactly:
the same rows in the same order. Squared distances agree within rtol 1e-5
and atol 2e-4: they are |q|^2 - 2 q.x + |x|^2 in f32 with |q|^2 + |x|^2
up to ~300 here, and the two packages sum the dot product in another
order, which moves the result by a few f32 ulps of those norms (~3e-5
each). The fixed seeds here meet no near-tie that would send a walk
elsewhere.
"""
import copy
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.index import fused as fused_j  # noqa: E402
from fabstir_vectordb_tpu.index import hnsw as hnsw_j  # noqa: E402
from fabstir_vectordb_tpu.index import ivf as ivf_j  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridConfig as HybridConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridIndex as HybridJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import SearchConfig as SearchConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.ivf import IVFConfig as IVFConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.store import VectorStore as StoreJ  # noqa: E402
from fabstir_vectordb_tpu.utils import limits as limits_j  # noqa: E402
from fabstir_vectordb_tpu_torch import convert  # noqa: E402
from fabstir_vectordb_tpu_torch.index import fused as fused_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index import hnsw as hnsw_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index import ivf as ivf_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index.hybrid import (  # noqa: E402
    HybridConfig, SearchConfig)
from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig  # noqa: E402
from fabstir_vectordb_tpu_torch.index.store import VectorStore  # noqa: E402
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


def _queries(x, seed, n):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, x.shape[0], n)
    return (x[rows] + 0.3 * rng.standard_normal((n, D))).astype(np.float32)


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
    """A JAX hybrid index (800 recent rows in HNSW, 1,600 old rows in a
    16-list IVF) and its port, carried across by convert."""
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


def _arrays(h):
    """The engine state both packages' search programs read, as numpy."""
    n = h.store.capacity
    act = h.store.active_mask(n)
    hm = act & h.hnsw.member_mask(n)
    x = h.store.data
    return {"x": x, "x_sq": (x * x).sum(1), "hnsw_mask": hm,
            "ivf_mask": act & h.ivf.member_mask(n) & ~hm,
            "nbrs0": h.hnsw.nbrs0, "nbrs_up": h.hnsw.nbrs_up,
            "up_offset": h.hnsw.up_offset, "entry": h.hnsw.entry_point,
            "level": h.hnsw.max_level}


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _assert_same(dj, rj, dt, rt):
    """Rows equal in order; distances within rtol 1e-5 / atol 2e-4 (see
    the module note); +inf where a row is -1."""
    dj, rj, dt, rt = (np.asarray(a) for a in (dj, rj, dt, rt))
    np.testing.assert_array_equal(rt, rj)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=1e-5, atol=2e-4)


def test_greedy_descent_matches_reference(pair):
    hj, _, x = pair
    a = _arrays(hj)
    q = _queries(x, 2, 24)
    stop = np.random.default_rng(3).integers(0, 2, 24).astype(np.int32)
    cur_j, d_j = hnsw_j.greedy_descent_kernel(
        *_j(a["x"], a["x_sq"], a["hnsw_mask"], a["nbrs_up"], a["up_offset"],
            q), a["entry"], a["level"], jnp.asarray(stop))
    cur_t, d_t = hnsw_t.greedy_descent(
        *_t(a["x"], a["x_sq"], a["hnsw_mask"], a["nbrs_up"], a["up_offset"],
            q), a["entry"], a["level"], torch.from_numpy(stop))
    np.testing.assert_array_equal(cur_t.numpy(), np.asarray(cur_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=2e-4)
    assert a["level"] >= 2  # the walk crossed upper layers


def _reference_steps(a, q, stop, max_hops=512):
    """The reference's greedy descent (hnsw_j.greedy_descent_kernel's
    while_loop body) for one query, step by step in numpy: its end (cur,
    cur_d) and the hop attempts it made."""
    x, x_sq, mask = a["x"], a["x_sq"], a["hnsw_mask"]
    nbrs_up, up_offset = a["nbrs_up"], a["up_offset"]
    q_sq = np.float32((q * q).sum())

    def dists(ids):
        safe = np.maximum(ids, 0)
        d = q_sq - 2.0 * (x[safe] @ q) + x_sq[safe]
        return np.maximum(d.astype(np.float32), 0.0)

    cur, layer = a["entry"], a["level"]
    cur_d = dists(np.array([cur]))[0] if mask[max(cur, 0)] else np.inf
    steps = 0
    while layer > stop and steps < max_hops:
        row = min(max(up_offset[max(cur, 0)] + layer - 1, 0),
                  nbrs_up.shape[0] - 1)
        nbr = nbrs_up[row]
        d = np.where((nbr >= 0) & mask[np.maximum(nbr, 0)], dists(nbr),
                     np.inf)
        j = int(np.argmin(d))
        if d[j] < cur_d:
            cur, cur_d = int(nbr[j]), d[j]
        else:
            layer -= 1
        steps += 1
    return cur, cur_d, steps


@pytest.mark.parametrize("max_hops", [512, 3])
def test_greedy_descent_longest_counts_the_reference_steps(pair, max_hops):
    """The plain version's "longest" (the most hop attempts of any one
    query, the chain that K10's latency bound counts) equals the attempts
    of the reference's loop run one query at a time, step by step; that
    loop ends where the JAX kernel does."""
    hj, _, x = pair
    a = _arrays(hj)
    q = _queries(x, 5, 16)
    stop = np.random.default_rng(6).integers(0, 2, 16).astype(np.int32)
    cur_j, d_j = hnsw_j.greedy_descent_kernel(
        *_j(a["x"], a["x_sq"], a["hnsw_mask"], a["nbrs_up"], a["up_offset"],
            q), a["entry"], a["level"], jnp.asarray(stop), max_hops=max_hops)
    arrs = _t(a["x"], a["x_sq"], a["hnsw_mask"], a["nbrs_up"],
              a["up_offset"])
    steps = []
    for i in range(16):
        cur, cur_d, n = _reference_steps(a, q[i], stop[i], max_hops)
        assert cur == int(cur_j[i])
        np.testing.assert_allclose(cur_d, float(d_j[i]), rtol=1e-5,
                                   atol=2e-4)
        st = {}
        hnsw_t.greedy_descent_plain(
            *arrs, torch.from_numpy(q[i:i + 1]), a["entry"], a["level"],
            torch.from_numpy(stop[i:i + 1]), max_hops, stats=st)
        assert st["longest"] == n == st["hops"]
        steps.append(n)
    st = {}
    hnsw_t.greedy_descent_plain(*arrs, torch.from_numpy(q), a["entry"],
                                a["level"], torch.from_numpy(stop), max_hops,
                                stats=st)
    assert st["longest"] == max(steps)
    assert st["hops"] == sum(steps)
    if max_hops == 3:  # every walk is cut at max_hops
        assert max(steps) == 3
    else:  # the queries' chains differ
        assert max(steps) > min(steps)


@pytest.mark.parametrize("expand,filtered,layer,starts", [
    (1, False, 0, "one"), (4, False, 0, "one"), (4, True, 0, "one"),
    (1, True, 0, "many"), (4, False, 1, "many")])
def test_beam_search_matches_reference(pair, expand, filtered, layer, starts):
    hj, _, x = pair
    a = _arrays(hj)
    b = 16
    q = _queries(x, 4, b)
    rng = np.random.default_rng(5)
    members = np.nonzero(a["hnsw_mask"] & (hj.hnsw.levels[
        :a["hnsw_mask"].shape[0]] >= layer))[0]
    if starts == "one":
        start = rng.choice(members, (b, 1)).astype(np.int32)
    else:  # repeats and -1 padding among S = 6 starts
        start = rng.choice(members, (b, 6)).astype(np.int32)
        start[:, 3] = start[:, 0]
        start[:, 5] = -1
    active = np.ones(b, bool)
    active[3] = False  # an inactive query passes through
    res = (np.arange(a["x"].shape[0]) % 3 != 0) if filtered else None
    ef = 32
    args = (a["x"], a["x_sq"], a["hnsw_mask"], a["nbrs0"], a["nbrs_up"],
            a["up_offset"], q, start, active)
    dj, rj = hnsw_j.beam_search_kernel(
        *_j(*args), layer=layer, ef=ef, max_iters=ef + 32,
        result_mask=None if res is None else jnp.asarray(res),
        has_result_mask=filtered, expand=expand)
    dt, rt = hnsw_t.beam_search(
        *_t(*args), layer=layer, ef=ef, max_iters=ef + 32,
        result_mask=None if res is None else torch.from_numpy(res),
        expand=expand)
    _assert_same(dj, rj, dt, rt)
    got = np.asarray(rt)
    assert (got[:, 0] >= 0).all()
    if filtered:
        assert res[got[got >= 0]].all()


def test_tiles_match_reference(pair):
    hj, ht, _ = pair
    np.testing.assert_array_equal(ht.ivf.tiles(), hj.ivf._build_tiles())
    assert ht.ivf.tiles() is ht.ivf.tiles()  # cached by version
    ht.ivf.remove_rows(np.array([N_RECENT]))
    assert (ht.ivf.tiles() != N_RECENT).all()
    ht.ivf.assignments[N_RECENT] = hj.ivf.assignments[N_RECENT]
    ht.ivf._version += 1
    np.testing.assert_array_equal(ht.ivf.tiles(), hj.ivf._build_tiles())


def test_device_lists_are_shared_and_bound_the_candidates(pair):
    """The IVF uploads its lists once a version, the fused searcher reads
    the same ones, and most_candidates is the sum of the longest lists."""
    _, ht, _ = pair
    lists = ht.ivf.device_lists()
    assert ht.ivf.device_lists() is lists
    assert ht.fused._device_state(pruned=True)["ivf"] is lists
    lens = (ht.ivf.tiles() >= 0).sum(1)
    np.testing.assert_array_equal(lists.list_len.numpy(), lens)
    longest = np.sort(lens)[::-1]
    for p in (1, 4, lens.size, lens.size + 3):
        assert lists.most_candidates(p) == longest[:p].sum()


@pytest.mark.parametrize("k,n_probe", [(10, 4), (64, 16)])
def test_ivf_search_matches_reference(pair, k, n_probe):
    hj, _, x = pair
    a = _arrays(hj)
    tiles = hj.ivf._build_tiles()
    cents = hj.ivf.centroids
    q = _queries(x, 6, 12)
    mask = a["ivf_mask"] & (np.arange(a["x"].shape[0]) % 5 != 1)
    vj, rj, pj = ivf_j.ivf_search_kernel(
        *_j(a["x"], a["x_sq"], mask, cents, tiles, q), k, n_probe)
    lists = ivf_t.IVFLists.upload(cents, tiles, torch.device(CPU))
    x_t, xsq_t, mask_t, q_t = _t(a["x"], a["x_sq"], mask, q)
    vt, rt, pt = ivf_t.ivf_search(x_t, xsq_t, mask_t, lists, q_t, k,
                                  n_probe)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    _assert_same(vj, rj, vt, rt)


@pytest.mark.parametrize("n_probe,c_lo,c_local", [(4, 0, 16), (16, 0, 16),
                                                   (6, 4, 8)])
def test_ivf_work_list_covers_the_reference_probes(pair, n_probe, c_lo,
                                                    c_local):
    """K12's grouped work list (``ivf_groups_plain``) from the reference's
    own probes: each (query, probe) pair of an owned, non-empty list sits
    exactly once under its list, its slot is its query's earlier probes'
    owned lengths summed, and each list's tasks cover its queries in
    groups of GROUP_QT and its rows in chunks of GROUP_RT. With a list
    range (a shard's lists c_lo .. c_lo + c_local - 1) a probe outside it
    scans nothing."""
    hj, _, x = pair
    a = _arrays(hj)
    tiles = hj.ivf._build_tiles()
    q = _queries(x, 8, 40)
    _, _, pj = ivf_j.ivf_search_kernel(
        *_j(a["x"], a["x_sq"], a["ivf_mask"], hj.ivf.centroids, tiles, q),
        10, n_probe)
    probe = np.array(pj, np.int32)
    lens = (tiles >= 0).sum(1)[c_lo: c_lo + c_local]
    w = ivf_t.ivf_groups_plain(torch.from_numpy(probe),
                               torch.from_numpy(lens.astype(np.int32)), c_lo)
    local = probe - c_lo
    owned = (local >= 0) & (local < c_local)
    own_len = np.where(owned, lens[np.clip(local, 0, c_local - 1)], 0)
    want_slot = np.cumsum(own_len, 1) - own_len
    np.testing.assert_array_equal(w["slot"].numpy(), want_slot)
    np.testing.assert_array_equal(w["n_lists"].numpy(), own_len.sum(1))
    lstart, tstart = w["lstart"].numpy(), w["tstart"].numpy()
    pair_b, pair_slot = w["pair_b"].numpy(), w["pair_slot"].numpy()
    seen = set()
    tasks = 0
    for li in range(c_local):
        qs = pair_b[lstart[li]: lstart[li + 1]]
        want = np.nonzero((local == li).any(1) & (lens[li] > 0))[0]
        np.testing.assert_array_equal(np.sort(qs), want)
        for b, s in zip(qs, pair_slot[lstart[li]: lstart[li + 1]]):
            p = int(np.nonzero(local[b] == li)[0][0])
            assert s == want_slot[b, p] and (b, p) not in seen
            seen.add((b, p))
        if qs.size:
            tasks += (-(-qs.size // ivf_t.GROUP_QT)
                      * -(-int(lens[li]) // ivf_t.GROUP_RT))
        assert tstart[li + 1] - tstart[li] == (tasks - tstart[li])
    assert seen == {(b, p) for b, p in zip(*np.nonzero(own_len > 0))}
    assert w["n_tasks"] == tasks == tstart[-1]


def test_hybrid_search_composition_matches_reference(pair):
    """K13 with the beam's top-k seeding K12 equals the reference's
    beam, merge_topk, list scan, merge_topk program."""
    hj, _, x = pair
    a = _arrays(hj)
    tiles = hj.ivf._build_tiles()
    cents = hj.ivf.centroids
    q = _queries(x, 7, 12)
    lists = ivf_t.IVFLists.upload(cents, tiles, torch.device(CPU))
    extra = np.arange(a["x"].shape[0]) % 4 != 2
    for filtered in (False, True):
        ex = extra if filtered else np.ones_like(extra)
        vj, rj = fused_j.hybrid_search_kernel(
            *_j(a["x"], a["x_sq"], a["hnsw_mask"], a["ivf_mask"], ex,
                a["nbrs0"], a["nbrs_up"], a["up_offset"]), a["entry"],
            a["level"], *_j(cents, tiles, q), 16, 64, 4, True, True,
            has_filter=filtered, beam_expand=4)
        vt, rt = fused_t.hybrid_search(
            *_t(a["x"], a["x_sq"], a["hnsw_mask"], a["ivf_mask"], ex,
                a["nbrs0"], a["nbrs_up"], a["up_offset"]), a["entry"],
            a["level"], lists, torch.from_numpy(q), 16, 64, 4, True,
            has_filter=filtered, beam_expand=4)
        _assert_same(vj, rj, vt, rt)
        got = rt.numpy()
        assert (a["hnsw_mask"][got[got >= 0]]).any()
        assert (a["ivf_mask"][got[got >= 0]]).any()


@pytest.fixture
def pruned(monkeypatch):
    """Both packages in the pruned regime, as bench.py forces it."""
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "0")
    monkeypatch.setenv("FVDB_PCA_SERVE", "0")
    for lim in (limits_j, limits_t):
        monkeypatch.setattr(lim, "FLAT_THRESHOLD", 0)


def test_pruned_search_matches_reference(pair, pruned):
    hj, ht, x = pair
    assert ht.fused.serving_info()["regime"] == "pruned"
    assert hj.fused.serving_info()["regime"] == "pruned"
    q = _queries(x, 8, 16)
    cj, ct = SearchConfigJ(auto_migrate=False), SearchConfig(auto_migrate=False)
    for h in (hj, ht):  # among them the entry point and IVF rows
        h.batch_delete([f"v{hj.hnsw.entry_point}", "v3", "v900", "v901"])
    mask = np.arange(ht.store.capacity) % 3 == 1
    try:
        for k in (10, 40):
            dj, rj = hj.search_rows(q, k, cj, now=NOW)
            dt, rt = ht.search_rows(q, k, ct, now=NOW)
            _assert_same(dj, rj, dt, rt)
            dj, rj = hj.search_rows(q, k, cj, extra_mask=mask, now=NOW)
            dt, rt = ht.search_rows(q, k, ct, extra_mask=mask, now=NOW)
            _assert_same(dj, rj, dt, rt)
        assert mask[rt[rt >= 0]].all()
        dead = {ht.store.row_of(v) for v in ("v3", "v900", "v901")}
        assert not dead & set(rt.ravel().tolist())
        got = ht.search_with_filter(q[0], 5, {"a": 1}, row_mask=mask, now=NOW)
        want = hj.search_with_filter(q[0], 5, {"a": 1}, row_mask=mask,
                                     now=NOW)
        assert [i for i, _ in got] == [i for i, _ in want]
    finally:
        for h in (hj, ht):  # the module's pair serves later tests too
            h.store.deleted[:] = False
            h.store._version += 1


def test_per_engine_k_matches_reference(pair):
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
    d1, r1 = ht.hnsw.search_rows(q, 6)
    d2, r2 = hj.hnsw.search_rows(q, 6)
    _assert_same(d2, r2, d1, r1)
    d1, r1 = ht.ivf.search_rows(q, 6, n_probe=3)
    d2, r2 = hj.ivf.search_rows(q, 6, n_probe=3)
    _assert_same(d2, r2, d1, r1)
    # cosine distances (1 - cos) as they are, probes ranked by cosine
    d1, r1 = ht.ivf.search_rows(q, 6, n_probe=3, metric="cosine")
    d2, r2 = hj.ivf.search_rows(q, 6, n_probe=3, metric="cosine")
    _assert_same(d2, r2, d1, r1)
    assert (np.asarray(d1) < 1.0).all()
    with pytest.raises(ValueError, match="metric"):
        ht.ivf.search_rows(q, 6, metric="manhattan")


def test_layer0_beam_link_plan_matches_reference(pair, pruned):
    """Inserts above the flat threshold link through greedy descent + one
    layer-0 beam + the heuristic in both packages, from the same graph.
    The plan's candidates (ids, kept flags) are equal. The graphs that come
    out have equal levels and entry, and >= 99% identical rows: the
    reverse-link prune sorts pair distances that the two packages sum in
    another order, so a near-tie there may keep another link (as in
    test_torch_index's build test)."""
    _, _, x_all = pair
    x = x_all[:1200]
    sj, st = StoreJ(D), VectorStore(D, device=CPU)
    ids = [f"r{i}" for i in range(1200)]
    rows = sj.add_batch(ids, x)
    st.add_batch(ids, x)
    cfg = dict(bootstrap_threshold=256, ef_construction=64)
    gj = hnsw_j.HNSWIndex(sj, hnsw_j.HNSWConfig(**cfg))
    gt = hnsw_t.HNSWIndex(st, hnsw_t.HNSWConfig(**cfg))
    gj.insert_rows(rows[:300])  # host-exact while the graph is small
    for name in ("levels", "nbrs0", "nbrs_up", "up_offset", "up_count",
                 "up_cap", "entry_point", "max_level"):
        v = getattr(gj, name)
        setattr(gt, name, v.copy() if isinstance(v, np.ndarray) else v)
    gt._rng = copy.deepcopy(gj._rng)  # the same level draws from here on
    gt._invalidate_device()
    gt._version += 1
    batch = rows[300:]
    cj = gj._device_candidates(batch, np.zeros(batch.size, np.int32))
    ct = gt._device_candidates(batch, np.zeros(batch.size, np.int32))
    np.testing.assert_array_equal(ct["ids"], np.asarray(cj["ids"])[:batch.size])
    np.testing.assert_array_equal(ct["kept"],
                                  np.asarray(cj["kept"])[:batch.size])
    gj.insert_rows(batch)
    gt.insert_rows(batch)
    np.testing.assert_array_equal(gt.levels, gj.levels)
    assert (gt.entry_point, gt.max_level) == (gj.entry_point, gj.max_level)
    members = np.nonzero(gj.levels >= 0)[0]
    assert members.size == 1200
    same0 = (gt.nbrs0[members] == gj.nbrs0[members]).all(1).mean()
    same_up = (gt.nbrs_up[:gj.up_count] == gj.nbrs_up[:gj.up_count]).all(
        1).mean()
    assert same0 >= 0.99 and same_up >= 0.99, (same0, same_up)
    # the device adjacency followed the links by dirty-row deltas
    dev = gt._device_arrays()
    np.testing.assert_array_equal(dev["nbrs0"].numpy(), gt.nbrs0)
    np.testing.assert_array_equal(dev["nbrs_up"].numpy(), gt.nbrs_up)
    np.testing.assert_array_equal(dev["up_offset"].numpy(), gt.up_offset)


def test_layer0_link_mode_and_per_layer(monkeypatch):
    """link_mode="layer0" takes the beam plan even under the threshold;
    "per_layer" takes a beam at every layer from the new rows' levels down
    (K11 above layer 0 among them) and links as well."""
    x = _mixture(11, 400)
    st = VectorStore(D, device=CPU)
    rows = st.add_batch([f"r{i}" for i in range(400)], x)
    g = hnsw_t.HNSWIndex(st, hnsw_t.HNSWConfig(bootstrap_threshold=64,
                                               link_mode="layer0"))
    g.insert_rows(rows[:100])  # host-exact up to 64 members
    calls = []
    real = hnsw_t.beam_search
    monkeypatch.setattr(hnsw_t, "beam_search",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    g.insert_rows(rows[100:])
    assert calls and g.num_nodes == 400
    d, r = g.search_rows(x[:20], 1)
    assert (r[:, 0] == np.arange(20)).mean() >= 0.95
    g2 = hnsw_t.HNSWIndex(st, hnsw_t.HNSWConfig(bootstrap_threshold=64,
                                                link_mode="per_layer"))
    g2.insert_rows(rows[:100])
    layers = []
    monkeypatch.setattr(hnsw_t, "beam_search", lambda *a, **k: layers.append(
        k["layer"]) or real(*a, **k))
    g2.insert_rows(rows[100:])
    assert g2.num_nodes == 400 and 0 in layers and max(layers) >= 1
    d, r = g2.search_rows(x[:20], 1)
    assert (r[:, 0] == np.arange(20)).mean() >= 0.95
