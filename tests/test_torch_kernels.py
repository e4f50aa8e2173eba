"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so on a machine
without JAX they run with the repository's conftest switched off:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The helpers here also serve ``test_torch_ops.py``.
"""
import numpy as np
import pytest
import torch

from fabstir_vectordb_tpu_torch.index import hnsw as hnsw_t
from fabstir_vectordb_tpu_torch.ops import kmeans as km_t
from fabstir_vectordb_tpu_torch.ops import quantization as qz_t
from fabstir_vectordb_tpu_torch.ops import topk as topk_t
from fabstir_vectordb_tpu_torch.parallel import ingest as ingest_t

D = 32
# squared distances: f32 products summed in different orders
RTOL = ATOL = 1e-5


def _data(seed, n, d=D):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32)


def _sorted_pairs(vals, rows):
    """Each row's (distance, row) pairs ordered by distance then row, so
    tie order cannot differ between the two packages."""
    vals = np.asarray(vals, np.float64)
    rows = np.asarray(rows, np.int64)
    order = np.lexsort((rows, vals), axis=1)
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(rows, order, 1))


def _assert_topk_equal(vj, rj, vt, rt):
    vj, rj = _sorted_pairs(vj, rj)
    vt, rt = _sorted_pairs(vt, rt)
    np.testing.assert_array_equal(rt, rj)
    fin = np.isfinite(vj)
    np.testing.assert_array_equal(np.isfinite(vt), fin)
    np.testing.assert_allclose(vt[fin], vj[fin], rtol=RTOL, atol=ATOL)


def _candidate_pools(seed, b, c, n=2000, pad_from=None):
    """Candidate pools sorted by distance to their query, as the link path
    builds them; rows past ``pad_from`` are (-1, +inf) padding."""
    rng = np.random.default_rng(seed)
    x = _data(seed, n)
    q = _data(seed + 1, b)
    ids = np.stack([rng.choice(n, c, replace=False) for _ in range(b)])
    d = ((x[ids] - q[:, None, :]) ** 2).sum(-1)
    order = np.argsort(d, axis=1)
    ids = np.take_along_axis(ids, order, 1).astype(np.int32)
    d = np.take_along_axis(d, order, 1).astype(np.float32)
    if pad_from is not None:
        ids[:, pad_from:] = -1
        d[:, pad_from:] = np.inf
    return x, ids, d


def _assert_kept_equal_up_to_near_ties(kept_ref, kept, ids, d, x):
    """Kept masks equal, or a row's first difference sits at a near-tie
    |d_i - dmin| <= 1e-5 * d_i of the reference's scan (the rest of that
    row follows from the flip)."""
    for b in np.nonzero((kept_ref != kept).any(1))[0]:
        i = int(np.nonzero(kept_ref[b] != kept[b])[0][0])
        v = x[np.maximum(ids[b], 0)].astype(np.float64)
        before = np.nonzero(kept_ref[b, :i])[0]
        pd = ((v[i] - v[before]) ** 2).sum(-1)
        dmin = pd.min() if pd.size else np.inf
        assert abs(d[b, i] - dmin) <= 1e-5 * d[b, i], (b, i)


def _mixture(seed, n, c, d=D, spread=0.05):
    """n rows around c separated centers, and each row's center."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)).astype(np.float32) * 4
    lab = rng.integers(0, c, n)
    x = centers[lab] + spread * rng.standard_normal((n, d))
    return x.astype(np.float32), lab


def _clustered(seed, n, c, d=D, spread=0.05):
    return _mixture(seed, n, c, d, spread)[0]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,mask_kind", [
    (128, 131_072, 16, "rows"), (1024, 16_384, 200, "rows"),
    (37, 4096, 64, "per_query"), (3, 1000, 256, "sparse")])
def test_l2_topk_kernel_matches_plain_on_card(b, n, k, mask_kind):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, 384, device=dev, generator=g)
    q = torch.randn(b, 384, device=dev, generator=g)
    if mask_kind == "per_query":
        mask = torch.rand(b, n, device=dev, generator=g) < 0.5
    elif mask_kind == "sparse":  # fewer rows than k: the tail pads
        mask = torch.rand(n, device=dev, generator=g) < 0.1
    else:
        mask = torch.rand(n, device=dev, generator=g) < 0.9
    x_sq = (x * x).sum(1)
    vt, rt = topk_t.l2_topk(x, x_sq, mask, q, k)
    vp, rp = topk_t.l2_topk_plain(x, x_sq, mask, q, k)
    # f32 sums in another order: |d| ~ 800 here, so 1e-5 relative of that
    vt, rt, vp, rp = (t.cpu().numpy() for t in (vt, rt, vp, rp))
    np.testing.assert_array_equal(np.isfinite(vt), np.isfinite(vp))
    fin = np.isfinite(vp)
    np.testing.assert_allclose(vt[fin], vp[fin], rtol=1e-5, atol=1e-2)
    for i in range(b):  # rows agree except at a tie with the k-th
        diff = set(rt[i][rt[i] >= 0]) ^ set(rp[i][rp[i] >= 0])
        if diff:
            kth = vp[i][fin[i]].max()
            for r in diff:
                d = vp[i][rp[i] == r] if r in set(rp[i]) else vt[i][rt[i] == r]
                assert abs(float(d[0]) - kth) <= 1e-2


@pytest.mark.cuda
def test_heuristic_kept_and_pair_kernels_match_plain_on_card():
    dev = _card()
    x, ids, d = _candidate_pools(23, 256, 128, n=20_000)
    xt = torch.from_numpy(x).to(dev)
    kt = hnsw_t.heuristic_kept(xt, torch.from_numpy(ids).to(dev),
                               torch.from_numpy(d).to(dev), 32).cpu().numpy()
    kp = hnsw_t.heuristic_kept_plain(xt, torch.from_numpy(ids).to(dev),
                                     torch.from_numpy(d).to(dev),
                                     32).cpu().numpy()
    _assert_kept_equal_up_to_near_ties(kp, kt, ids, d, x)
    t = torch.randint(0, 20_000, (65_536,), device=dev, dtype=torch.int32)
    c = torch.randint(0, 20_000, (65_536,), device=dev, dtype=torch.int32)
    x_sq = (xt * xt).sum(1)
    torch.testing.assert_close(hnsw_t.pair_sq_l2(xt, x_sq, t, c),
                               hnsw_t.pair_sq_l2_plain(xt, x_sq, t, c),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_lloyd_kernels_match_plain_on_card():
    dev = _card()
    xs, lab = _mixture(24, 65_536, 256, d=384)
    x = torch.from_numpy(xs).to(dev)
    mask = torch.ones(65_536, dtype=torch.bool, device=dev)
    # one starting centroid per cluster: with two in one cluster, rows on
    # their bisector are near-ties that the two f32 sum orders may split
    # differently, and the centroids then differ by a row's share
    first = [int(np.nonzero(lab == c)[0][0]) for c in range(256)]
    init = x[first].clone()
    ct, et = km_t.lloyd_block(x, mask, init, 5)
    cp, ep = km_t.lloyd_block_plain(x, mask, init, 5)
    torch.testing.assert_close(ct, cp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(et, ep, rtol=1e-4, atol=1e-4)
    at, _ = km_t.assign_clusters(x, init)
    ap, _ = km_t.assign_clusters_plain(x, init)
    assert (at == ap).float().mean().item() > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("k", [512, 4096, 65_536])
def test_l2_topk_large_k_matches_plain_on_card(k):
    """K1's k > 256 path (distance buffer + radix select), with its sort in
    shared memory (k <= 4,096) and in a global scratch row (65,536)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    n = 131_072
    x = torch.randn(n, 384, device=dev, generator=g)
    x_sq = (x * x).sum(1)
    q = torch.randn(3, 384, device=dev, generator=g)
    # 45% of rows unmasked: 59K, fewer than k = 65,536, so the tail pads
    mask = torch.rand(n, device=dev, generator=g) < 0.45
    vt, rt = topk_t.l2_topk(x, x_sq, mask, q, k)
    vp, rp = topk_t.l2_topk_plain(x, x_sq, mask, q, k)
    vt, rt, vp, rp = (t.cpu().numpy() for t in (vt, rt, vp, rp))
    np.testing.assert_array_equal(np.isfinite(vt), np.isfinite(vp))
    fin = np.isfinite(vp)
    for i in range(3):  # ascending over the found rows, then the padding
        assert (np.diff(vt[i][fin[i]]) >= 0).all()
    np.testing.assert_allclose(vt[fin], vp[fin], rtol=1e-5, atol=1e-2)
    assert (rt[~fin] == -1).all()
    for i in range(3):  # rows agree except at a tie with the k-th
        diff = set(rt[i][rt[i] >= 0]) ^ set(rp[i][rp[i] >= 0])
        kth = vp[i][fin[i]].max()
        for r in diff:
            d = vp[i][rp[i] == r] if r in set(rp[i]) else vt[i][rt[i] == r]
            assert abs(float(d[0]) - kth) <= 1e-2


def _graph_on_card(n=3000, d=64, seed=31):
    """A port HNSW graph over a clustered corpus, built on the card."""
    from fabstir_vectordb_tpu_torch.index.store import VectorStore

    dev = _card()
    x, _ = _mixture(seed, n, 24, d=d, spread=0.5)
    st = VectorStore(d, device=dev)
    rows = st.add_batch([f"r{i}" for i in range(n)], x)
    g = hnsw_t.HNSWIndex(st, hnsw_t.HNSWConfig(bootstrap_threshold=256))
    g.insert_rows(rows)
    m = st.device_mirror()
    mask = torch.from_numpy(g._search_mask()).to(dev)
    arrs = g._device_arrays()
    rng = np.random.default_rng(seed)
    q = torch.from_numpy((x[rng.integers(0, n, 64)] + 0.3 * rng.standard_normal(
        (64, d))).astype(np.float32)).to(dev)
    return g, m, mask, arrs, q


def _overlap(a, b):
    """Mean share of each row's valid ids of b that a holds too."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    out = []
    for ra, rb in zip(a, b):
        sb = set(rb[rb >= 0].tolist())
        out.append(len(sb & set(ra[ra >= 0].tolist())) / max(len(sb), 1))
    return float(np.mean(out))


@pytest.mark.cuda
def test_greedy_descent_kernel_matches_plain_on_card():
    g, m, mask, a, q = _graph_on_card()
    stop = torch.tensor(np.arange(64) % 2, dtype=torch.int32, device=q.device)
    for s in (None, stop):
        ck, dk = hnsw_t.greedy_descent(m.x, m.x_sq, mask, a["nbrs_up"],
                                       a["up_offset"], q, g.entry_point,
                                       g.max_level, s)
        cp, dp = hnsw_t.greedy_descent_plain(m.x, m.x_sq, mask, a["nbrs_up"],
                                             a["up_offset"], q, g.entry_point,
                                             g.max_level, s)
        # a near-tie may send one walk elsewhere: 99% agree exactly
        assert (ck == cp).float().mean().item() >= 0.99
        same = ck == cp
        torch.testing.assert_close(dk[same], dp[same], rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("expand,filtered,layer,s,ef", [
    (1, False, 0, 1, 200), (4, False, 0, 1, 64), (4, True, 0, 1, 64),
    (4, True, 0, 5, 512), (1, False, 1, 3, 32), (4, True, 0, 1, 2048)])
def test_beam_search_kernel_matches_plain_on_card(expand, filtered, layer, s,
                                                  ef):
    """Serve (ef 64, W 4) and link (ef 200, W 1) shapes, a filter, several
    starts, an upper layer, and ef = 2,048, whose lists live in global
    scratch. A near-tie may turn a walk: results overlap >= 0.99."""
    g, m, mask, a, q = _graph_on_card()
    dev = q.device
    rng = np.random.default_rng(7)
    members = np.nonzero(g._search_mask() & (g.levels >= layer))[0]
    start = torch.from_numpy(rng.choice(members, (64, s)).astype(np.int32)
                             ).to(dev)
    res = None
    if filtered:
        res = torch.from_numpy(np.arange(m.x.shape[0]) % 3 != 0).to(dev)
    active = torch.ones(64, dtype=torch.bool, device=dev)
    active[5] = False
    args = (m.x, m.x_sq, mask, a["nbrs0"], a["nbrs_up"], a["up_offset"], q,
            start, active, layer, ef, ef + 32, res, None, expand)
    dk, ik = hnsw_t.beam_search(*args)
    dp, ip = hnsw_t.beam_search_plain(*args)
    assert _overlap(ik, ip) >= 0.99
    dk_n, ik_n = dk.cpu().numpy(), ik.cpu().numpy()
    for dr, ir in zip(dk_n, ik_n):  # ascending, then (+inf, -1) padding
        assert (np.diff(dr[ir >= 0]) >= 0).all()
        assert np.isinf(dr[ir < 0]).all() and (ir[: (ir >= 0).sum()] >= 0).all()
    for row in ik_n:  # no id twice
        v = row[row >= 0]
        assert len(set(v.tolist())) == v.size
    if filtered:
        assert res.cpu().numpy()[ik_n[ik_n >= 0]].all()
    torch.testing.assert_close(ik[5], ip[5])  # inactive: the starts only


@pytest.mark.cuda
@pytest.mark.parametrize("k,seeded,chunked", [
    (16, True, False), (512, False, False), (8192, True, False),
    (16, True, True)])
def test_ivf_scan_kernel_matches_plain_on_card(k, seeded, chunked,
                                               monkeypatch):
    from fabstir_vectordb_tpu_torch.index import ivf as ivf_mod
    from fabstir_vectordb_tpu_torch.index.ivf import (IVFIndex, IVFLists,
                                                      ivf_search,
                                                      ivf_search_plain)
    from fabstir_vectordb_tpu_torch.index.store import VectorStore

    dev = _card()
    if chunked:  # a few queries a launch: the chunks must join up
        monkeypatch.setattr(ivf_mod, "_CAND_BYTES", 1 << 20)
    n, d = 20_000, 384
    x, _ = _mixture(41, n, 64, d=d, spread=0.5)
    st = VectorStore(d, device=dev)
    rows = st.add_batch([f"r{i}" for i in range(n)], x)
    ivf = IVFIndex(st)
    rng = np.random.default_rng(3)
    ivf.set_trained(x[rng.choice(n, 32, replace=False)])
    ivf.insert_rows(rows[: n - 500])
    m = st.device_mirror()
    lists = IVFLists.upload(ivf.centroids, ivf.tiles(), dev)
    mask = torch.from_numpy(st.active_mask() & ivf.member_mask()).to(dev)
    extra = torch.from_numpy(np.arange(st.capacity) % 4 != 1).to(dev)
    q = torch.from_numpy(x[:37] + 0.2).to(dev)
    seed = None
    if seeded:  # rows outside the lists, as the beam's are
        sr = torch.arange(n - 500, n - 500 + 40, dtype=torch.int32,
                          device=dev)[None].repeat(37, 1)
        sd = torch.linspace(1.0, 400.0, 40, device=dev)[None].repeat(37, 1)
        seed = (sd.contiguous(), sr.contiguous())
    vk, rk, pk = ivf_search(m.x, m.x_sq, mask, lists, q, k, 8,
                            extra_mask=extra, seed=seed)
    vp, rp, pp = ivf_search_plain(m.x, m.x_sq, mask, lists, q, k, 8,
                                  extra_mask=extra, seed=seed)
    assert (pk == pp).all()
    vk, rk, vp, rp = (t.cpu().numpy() for t in (vk, rk, vp, rp))
    np.testing.assert_array_equal(np.isfinite(vk), np.isfinite(vp))
    fin = np.isfinite(vp)
    np.testing.assert_allclose(vk[fin], vp[fin], rtol=1e-5, atol=1e-2)
    for i in range(37):  # the same rows but at ties with the k-th
        diff = set(rk[i][rk[i] >= 0]) ^ set(rp[i][rp[i] >= 0])
        kth = vp[i][fin[i]].max() if fin[i].any() else np.inf
        for r in diff:
            dd = vp[i][rp[i] == r] if r in set(rp[i]) else vk[i][rk[i] == r]
            assert abs(float(dd[0]) - kth) <= 1e-2


def _assert_close_up_to_ties(vt, rt, vp, rp, rtol, atol):
    """Kernel top-k (vt, rt) against the plain one: the same padding,
    distances within tolerance position by position, and rows that differ
    only at a tie with the k-th distance."""
    vt, rt, vp, rp = (np.asarray(t.cpu()) for t in (vt, rt, vp, rp))
    np.testing.assert_array_equal(np.isfinite(vt), np.isfinite(vp))
    fin = np.isfinite(vp)
    np.testing.assert_allclose(vt[fin], vp[fin], rtol=rtol, atol=atol)
    assert (rt[~fin] == -1).all()
    for i in range(vt.shape[0]):
        diff = set(rt[i][rt[i] >= 0]) ^ set(rp[i][rp[i] >= 0])
        kth = vp[i][fin[i]].max() if fin[i].any() else np.inf
        for r in diff:
            d = vp[i][rp[i] == r] if r in set(rp[i]) else vt[i][rt[i] == r]
            assert abs(float(d[0]) - kth) <= atol + rtol * abs(kth)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ov_k,n,keep,chunk", [
    (1, 64, 200_003, 0.9, 0), (128, 256, 200_003, 0.9, 48),
    (128, 1024, 200_003, 0.9, 0), (5, 2048, 200_003, 0.5, 0),
    (3, 64, 5000, 0.004, 0), (2, 300, 5000, 0.0, 0)])
def test_stage1_select_kernel_matches_plain_on_card(b, ov_k, n, keep, chunk,
                                                    monkeypatch):
    """K14's stage 1 over a bf16 mirror at small and large ov_k, a last
    partial tile, (keep 0.4%) fewer unmasked rows than ov_k, so the tail
    pads, every row masked, and (chunk) a batch taken in query chunks whose
    distance buffers are held one at a time, one launch counted each."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    r = 192
    xp = torch.randn(n, r, device=dev, generator=g).to(torch.bfloat16)
    xp_sq = (xp.float() ** 2).sum(1)
    qp = torch.randn(b, r, device=dev, generator=g)
    mask = torch.rand(n, device=dev, generator=g) < keep
    before = native.launches["stage1_select"]
    budget = {"transient_bytes": chunk * n * 4} if chunk else {}
    vt, rt = fused_t.stage1_select(xp, xp_sq, mask, qp, ov_k, **budget)
    assert native.launches["stage1_select"] - before == -(-b // (chunk or b))
    vp, rp = fused_t.stage1_select_plain(xp, xp_sq, mask, qp, ov_k)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d,r,off", [(384, 20, 0.0), (384, 192, 0.0),
                                     (384, 300, 0.0), (3072, 600, 0.0),
                                     (100, 130, 0.0), (384, 600, 0.0),
                                     (384, 192, 3.0)])
def test_project_kernels_match_plain_on_card(d, r, off):
    """K14's projection of a block into the bf16 mirror at row lo (a last
    partial block of 37 rows) and of queries, also for wide embeddings, a
    rank past one and two tensor-core column tiles, D and r that are not
    multiples of 16 or 64, and an off-center block (every row shifted by a
    common vector ``off`` times the rows' spread, mu its mean)."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    n, lo = 10_037, 4096
    src = torch.randn(n, d, device=dev, generator=g) + 0.3
    mu = torch.randn(d, device=dev, generator=g) * 0.1
    if off:
        src = src + off * torch.randn(d, device=dev, generator=g)
    src = src.to(torch.bfloat16)
    if off:
        mu = src.float().mean(0)
    p = torch.linalg.qr(torch.randn(d, r, device=dev, generator=g))[0] \
        if r <= d else torch.randn(d, r, device=dev, generator=g) * 0.05
    p = p.contiguous()
    out_k = torch.zeros((lo + n, r), dtype=torch.bfloat16, device=dev)
    sq_k = torch.zeros(lo + n, device=dev)
    out_p, sq_p = out_k.clone(), sq_k.clone()
    fused_t.project_rows(src, mu, p, out_k, sq_k, lo)
    fused_t.project_rows_plain(src, mu, p, out_p, sq_p, lo)
    yk, yp = out_k[lo:].float(), out_p[lo:].float()
    assert (out_k[:lo].float() == 0).all()
    same = yk == yp
    assert same.float().mean().item() >= 0.999
    # one bf16 ulp of the larger of the two, or (where the product cancels
    # to near 0) the f32 sums' own spread, 1e-6 of the block's scale
    big = torch.maximum(yk.abs(), yp.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    slack = torch.maximum(ulp * 1.0001, 1e-6 * yp.abs().max())
    assert ((yk - yp).abs()[~same] <= slack[~same]).all()
    rows = same.all(1)
    torch.testing.assert_close(sq_k[lo:][rows], sq_p[lo:][rows], rtol=1e-6,
                               atol=0.0)
    # the same block again: the norms are the same bit for bit
    sq_2 = torch.zeros_like(sq_k)
    fused_t.project_rows(src, mu, p, out_k, sq_2, lo)
    assert torch.equal(sq_2, sq_k)
    q = torch.randn(77, d, device=dev, generator=g) + src[:77].float()
    torch.testing.assert_close(fused_t.project_queries(q, mu, p),
                               fused_t.project_queries_plain(q, mu, p),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("ov,m", [(1024, 64), (100, 128), (8192, 2048)])
def test_rerank_f32_kernel_matches_plain_on_card(ov, m):
    """K2 at OV = 1,024, with -1 padding, a query whose pool is all -1,
    (OV < m) a padded tail, and the wide pool of a filtered k = 100
    search."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    n, d, b = 300_000, 384, 128
    x = torch.randn(n, d, device=dev, generator=g).to(torch.bfloat16)
    q = torch.randn(b, d, device=dev, generator=g)
    # distinct rows in each pool, as stage 1 gives them
    rows = torch.argsort(torch.rand(b, n, device=dev, generator=g), dim=1)[
        :, :ov].to(torch.int32).contiguous()
    rows[:, -ov // 8:] = -1
    rows[3] = -1
    vt, rt = fused_t.rerank_f32(x, q, rows, m)
    vp, rp = fused_t.rerank_f32_plain(x, q, rows, m)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-3)
    assert (rt[3] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("ka,kb,k", [(11, 11, 11), (5, 3, 16)])
def test_merge_topk_kernel_matches_plain_on_card(ka, kb, k):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    b = 128
    va = torch.rand(b, ka, device=dev, generator=g)
    vb = torch.rand(b, kb, device=dev, generator=g)
    va[:, 0] = vb[:, 0]  # equal values: the lower row goes first
    ra = torch.randint(0, 10_000, (b, ka), device=dev, generator=g,
                       dtype=torch.int32)
    rb = torch.randint(0, 10_000, (b, kb), device=dev, generator=g,
                       dtype=torch.int32)
    va[:8, ka // 2:] = float("inf")
    ra[:8, ka // 2:] = -1
    mt = topk_t.merge_topk(va, ra, vb, rb, k)
    mp = topk_t.merge_topk_plain(va, ra, vb, rb, k)
    assert torch.equal(mt[1], mp[1]) and torch.equal(mt[0], mp[0])


@pytest.mark.cuda
def test_oracle_step_kernels_match_plain_on_card():
    """K8's oracle step: K1 on bf16 blocks with a row base (norms taken in
    the kernel), then the merge, over a last partial block."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(6)
    n, d, p, k = 112_345, 384, 128, 11
    x = torch.randn(n, d, device=dev, generator=g).to(torch.bfloat16)
    q = torch.randn(p, d, device=dev, generator=g)
    members = torch.rand(n, device=dev, generator=g) < 0.9
    state = {}
    for tag in ("kernel", "plain"):
        step = fused_t.oracle_step if tag == "kernel" \
            else fused_t.oracle_step_plain
        vals = torch.full((p, k), float("inf"), device=dev)
        rows = torch.full((p, k), -1, dtype=torch.int32, device=dev)
        for lo in range(0, n, 50_000):
            hi = min(n, lo + 50_000)
            vals, rows = step(x[lo:hi], members[lo:hi].contiguous(), q, lo,
                              vals, rows, k)
        state[tag] = (vals, rows)
    _assert_close_up_to_ties(*state["kernel"], *state["plain"], 1e-5, 1e-2)


@pytest.mark.cuda
def test_kmeans_seed_kernels_match_plain_on_card():
    """K7 at the IVF training shape (10,000 x 384, l = 409, 2,046
    candidates)."""
    dev = _card()
    xs, _ = _mixture(25, 10_000, 256, d=384, spread=0.5)
    x = torch.from_numpy(xs).to(dev)
    mask = torch.ones(10_000, dtype=torch.bool, device=dev)
    mask[-17:] = False
    g = torch.Generator(device=dev).manual_seed(7)
    u = torch.rand(10_000, device=dev, generator=g)
    first_k = km_t.seed_pick(None, mask, u, 1, weighted=False)
    first_p = km_t.seed_pick_plain(None, mask, u, 1, weighted=False)
    assert torch.equal(first_k, first_p)
    d2 = torch.full((10_000,), float("inf"), device=dev)
    d2 = km_t.seed_min_update_plain(x, mask, d2, first_p)
    cand = [first_p]
    for _ in range(5):
        u = torch.rand(10_000, device=dev, generator=g)
        rk = km_t.seed_pick(d2, mask, u, 409)
        rp = km_t.seed_pick_plain(d2, mask, u, 409)
        assert torch.equal(rk, rp)
        dk = km_t.seed_min_update(x, mask, d2, rk)
        dp = km_t.seed_min_update_plain(x, mask, d2, rk)
        torch.testing.assert_close(dk, dp, rtol=1e-5, atol=5e-3)
        d2 = dp
        cand.append(rk)
    cand = torch.cat(cand)
    ck = km_t.seed_counts(x, mask, cand)
    cp = km_t.seed_counts_plain(x, mask, cand)
    assert int(ck.sum()) == int(cp.sum()) == int(mask.sum())
    assert (ck == cp).float().mean().item() >= 0.99


def _bf16_order(t):
    """bf16 values as integers in a total order (adjacent values differ by
    one): negatives reflected below 0x8000, +0 and -0 both at 0x8000."""
    u = t.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(u >= 0x8000, 0x8000 - (u & 0x7FFF), 0x8000 + u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_kind", ["range", "offsets", "centers"])
def test_synth_kernel_matches_plain_on_card(dtype, rows_kind):
    """K17 against its plain version at the 10M tier's widths (D = 384,
    4,096 centers): assignments exactly; f32 values within 1e-6 (log1p and
    the f64-emulated fused multiply-adds round alike to a few ulps); bf16
    values at most 0.5% one bf16 ulp apart, none further."""
    from fabstir_vectordb_tpu_torch.utils import synth

    dev = _card()
    src = synth.SyntheticCorpusSource(0, 384, n_centers=4096, scale=0.35,
                                      block_rows=1 << 20, device=dev)
    kz, ka = src.block_keys(3)
    if rows_kind == "centers":
        key = synth.prng_key(0 ^ 0x5EED)
        got, ga = synth.synth_rows(key, None, range(0, 4096), 384,
                                   dtype=dtype, device=dev)
        want, wa = synth.synth_rows_plain(
            key, None, torch.arange(4096, device=dev), 384, dtype=dtype)
    else:
        if rows_kind == "range":
            rows = range(1_000_000, 1_048_576)
            idx = torch.arange(rows.start, rows.stop, device=dev)
        else:
            idx = torch.randint(0, 1 << 20, (5000,), device=dev,
                                dtype=torch.int32)
            rows = idx
        got, ga = synth.synth_rows(kz, ka, rows, 384, src.centers(), 0.35,
                                   dtype, device=dev)
        want, wa = synth.synth_rows_plain(kz, ka, idx, 384, src.centers(),
                                          0.35, dtype)
        assert torch.equal(ga, wa)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6
    else:
        off = (_bf16_order(got) - _bf16_order(want)).abs()
        assert int(off.max()) <= 1
        assert float((off > 0).float().mean()) <= 0.005
    # the mirror writes straight into its rows of one tensor
    if rows_kind == "range" and dtype == torch.bfloat16:
        small = synth.SyntheticCorpusSource(0, 384, n_centers=4096,
                                            scale=0.35, block_rows=4096,
                                            device=dev)
        m = small.mirror_bf16(4096 * 2 + 100)
        assert torch.equal(m[4096:8192], small.device_block(1,
                                                            torch.bfloat16))
        assert torch.equal(m[8192:], small.rows(2, range(0, 100),
                                                torch.bfloat16)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 300])
def test_tile_step_matches_plain_on_card(k):
    """K8's tile step: K1 on an f32 tile with its norms taken in the kernel
    and a row base, then the merge into the running top-k."""
    from fabstir_vectordb_tpu_torch.index import tiered as tiered_t

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(100_000, 384, device=dev, generator=g)
    m = torch.rand(100_000, device=dev, generator=g) < 0.9
    q = torch.randn(32, 384, device=dev, generator=g)
    vals = torch.sort(torch.rand(32, k, device=dev, generator=g) * 700,
                      dim=1).values
    rows = torch.randint(10**6, 2 * 10**6, (32, k), device=dev, generator=g,
                         dtype=torch.int32)
    vt, rt = tiered_t.tile_step(x, m, q, 699_392, vals, rows, k)
    vp, rp = tiered_t.tile_step_plain(x, m, q, 699_392, vals, rows, k)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)
    out = (torch.empty_like(vals), torch.empty_like(rows))
    vo, ro = tiered_t.tile_step(x, m, q, 699_392, vals, rows, k, out=out)
    assert vo is out[0] and torch.equal(ro, rt)


@pytest.mark.cuda
def test_tiered_search_streams_exactly_on_card():
    """The double-buffered stream (pinned buffers, a copy stream, events)
    over a ragged tail gives the CPU searcher's answers."""
    from fabstir_vectordb_tpu_torch.index import tiered as tiered_t

    dev = _card()
    xs, _ = _mixture(26, 50_000, 64, d=384, spread=0.5)
    rng = np.random.default_rng(27)
    mask = rng.random(50_000) < 0.95
    q = xs[rng.integers(0, 50_000, 32)] + 0.05
    seen = []
    on_card = tiered_t.TieredFlatSearcher(xs, mask, tile_rows=8192,
                                          device=dev)
    vt, rt = on_card.search(q, 10, progress=seen.append)
    vp, rp = tiered_t.TieredFlatSearcher(xs, mask, tile_rows=8192,
                                         device="cpu").search(q, 10)
    assert seen == list(range(7))
    _assert_close_up_to_ties(torch.from_numpy(vt), torch.from_numpy(rt),
                             torch.from_numpy(vp), torch.from_numpy(rp),
                             1e-5, 1e-2)
    # a second search reuses the buffers
    vt2, rt2 = on_card.search(q, 10)
    assert np.array_equal(rt2, rt)


@pytest.mark.cuda
@pytest.mark.parametrize("budget_gib,launches", [(2, 1), (1, 2)])
def test_stage1_launches_follow_the_transient_budget(budget_gib, launches):
    """A 32-query sub-batch over 10,485,760 rows: under 1 GiB a launch
    holds 25 queries (two launches, two passes over the mirror); under the
    2 GiB that the reduced-rank dispatch passes at bench.py's operating
    point it is one launch, and the answers are the same."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(12)
    n, r, b = 10_485_760, 16, 32
    assert (1 << 30) // (4 * n) == 25
    xp = torch.randn(n, r, device=dev, generator=g).to(torch.bfloat16)
    xp_sq = (xp.float() ** 2).sum(1)
    qp = torch.randn(b, r, device=dev, generator=g)
    before = native.launches["stage1_select"]
    vt, rt = fused_t.stage1_select(xp, xp_sq, None, qp, 64,
                                   budget_gib << 30)
    assert native.launches["stage1_select"] - before == launches
    vr, rr = fused_t.stage1_select(xp, xp_sq, None, qp, 64, 4 << 30)
    assert torch.equal(vt, vr) and torch.equal(rt, rr)


def _pool_overlap(rt, rp):
    """Mean share of each query's plain pool rows that the kernel's holds."""
    rt, rp = rt.cpu().numpy(), rp.cpu().numpy()
    return float(np.mean([
        len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
        / max(int((b >= 0).sum()), 1) for a, b in zip(rt, rp)]))


def _assert_shared_rows_close(vt, rt, vp, rp, rtol):
    """Rows in both pools carry the same distance within rtol."""
    vt, rt, vp, rp = (t.cpu().numpy() for t in (vt, rt, vp, rp))
    for i in range(rt.shape[0]):
        dt = dict(zip(rt[i].tolist(), vt[i].tolist()))
        for r, v in zip(rp[i].tolist(), vp[i].tolist()):
            if r >= 0 and r in dt:
                assert abs(dt[r] - v) <= rtol * max(abs(v), 1.0), (i, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,n,ov_k,keep", [
    ("float32", 128, 262_144, 128, 0.9), ("bfloat16", 128, 262_144, 128, 0.9),
    ("float32", 1, 1_000_003, 128, 1.0), ("bfloat16", 3, 100_000, 16, 0.5),
    ("float32", 5, 2000, 128, 0.9), ("bfloat16", 4, 5000, 64, 0.002)])
def test_approx_topk_kernel_matches_plain_on_card(dtype, b, n, ov_k, keep):
    """K9 against its plain version on f32 and bf16 rows (the query rounded
    on bf16 rows): the pools share >= 0.99 of their rows on average and the
    shared rows' distances agree within 1e-5 relative (near-tied bin
    minima may go either way under another summation order). Also M = N
    (an exact pool), a last partial round, and (keep 0.2%) fewer unmasked
    rows than ov_k, so the pool pads with (+inf, -1)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(n, 384, device=dev, generator=g)
    bf16 = dtype == "bfloat16"
    x_sq = (x * x).sum(1)
    if bf16:
        x = x.to(torch.bfloat16)
    q = torch.randn(b, 384, device=dev, generator=g)
    mask = torch.rand(n, device=dev, generator=g) < keep
    vt, rt = topk_t.approx_topk(x, x_sq, mask, q, ov_k, round_query=bf16)
    vp, rp = topk_t.approx_topk_plain(x, x_sq, mask, q, ov_k,
                                      round_query=bf16)
    assert _pool_overlap(rt, rp) >= 0.99
    _assert_shared_rows_close(vt, rt, vp, rp, 1e-5)
    fin = torch.isfinite(vt)
    assert torch.equal(fin, torch.isfinite(vp)) and (rt[~fin] == -1).all()
    assert mask[rt[fin].long()].all()
    assert (vt[:, 1:] >= vt[:, :-1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(128, 16), (128, 128), (37, 256),
                                 (128, 1024), (5, 5000)])
def test_l2_topk_rounded_query_on_bf16_rows_matches_plain_on_card(b, k):
    """K1 on a bf16 serving mirror: the query rounded to bf16 in the
    product, |q|^2 from the f32 query, x_sq the f32 norms of the f32 rows,
    at k <= 256 (lists) and k > 256 (buffer + radix select)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(14)
    n = 131_072
    xf = torch.randn(n, 384, device=dev, generator=g)
    x_sq = (xf * xf).sum(1)
    x = xf.to(torch.bfloat16)
    q = torch.randn(b, 384, device=dev, generator=g)
    mask = torch.rand(n, device=dev, generator=g) < 0.9
    vt, rt = topk_t.l2_topk(x, x_sq, mask, q, k, round_query=True)
    vp, rp = topk_t.l2_topk_plain(x, x_sq, mask, q, k, round_query=True)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)
    # rounding changes the distances: the unrounded kernel differs
    vu, _ = topk_t.l2_topk(x, x_sq, mask, q, k)
    assert not torch.equal(vu, vt)


@pytest.mark.cuda
@pytest.mark.parametrize("ov,m", [(128, 16), (1024, 64), (8192, 2048)])
def test_rerank_f32_kernel_on_f32_rows_matches_plain_on_card(ov, m):
    """K2 over an f32 mirror (the approximate flat pool's re-score), with
    -1 padding and a query whose pool is all -1."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(15)
    n, d, b = 300_000, 384, 128
    x = torch.randn(n, d, device=dev, generator=g)
    q = torch.randn(b, d, device=dev, generator=g)
    rows = torch.argsort(torch.rand(b, n, device=dev, generator=g), dim=1)[
        :, :ov].to(torch.int32).contiguous()
    rows[:, -ov // 8:] = -1
    rows[3] = -1
    vt, rt = fused_t.rerank_f32(x, q, rows, m)
    vp, rp = fused_t.rerank_f32_plain(x, q, rows, m)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-3)
    assert (rt[3] == -1).all()


@pytest.mark.cuda
def test_heuristic_kept_and_pair_kernels_on_bf16_rows_match_plain_on_card():
    """K4 and K5 over a bf16 mirror: rows upcast exactly, K4's norms from
    the upcast rows, K5's from the mirror's f32 norms of the f32 rows."""
    dev = _card()
    x, ids, d = _candidate_pools(25, 256, 128, n=20_000)
    xf = torch.from_numpy(x).to(dev)
    xb = xf.to(torch.bfloat16)
    idt, dt = torch.from_numpy(ids).to(dev), torch.from_numpy(d).to(dev)
    kt = hnsw_t.heuristic_kept(xb, idt, dt, 32).cpu().numpy()
    kp = hnsw_t.heuristic_kept_plain(xb, idt, dt, 32).cpu().numpy()
    _assert_kept_equal_up_to_near_ties(kp, kt, ids, d,
                                       xb.float().cpu().numpy())
    t = torch.randint(0, 20_000, (65_536,), device=dev, dtype=torch.int32)
    c = torch.randint(0, 20_000, (65_536,), device=dev, dtype=torch.int32)
    x_sq = (xf * xf).sum(1)
    torch.testing.assert_close(hnsw_t.pair_sq_l2(xb, x_sq, t, c),
                               hnsw_t.pair_sq_l2_plain(xb, x_sq, t, c),
                               rtol=1e-5, atol=1e-4)


def _cpu_topk(d, k):
    """The plain selection on the CPU (a comparison sort: -0 equals +0,
    ties go to the lower row) of distances d [B, N]."""
    return topk_t.masked_topk(d.cpu(), None, k)


@pytest.mark.cuda
@pytest.mark.parametrize("path,k", [("k1", 64), ("k1", 512),
                                    ("select", 64), ("select", 700)])
def test_selection_orders_signed_distances_on_card(path, k):
    """Negative distances rank before positive ones and -0 ties +0 (the
    lower row first), in K1's list path (k <= 256), the radix select (K1 at
    k > 256, and a chunk's step at k 700) and the fused chunk step (k 64):
    the rows the plain version picks. Raw float bits as keys put every negative distance
    after the positives and -0 after +inf."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(21)
    n, b = 5000, 8
    rows = torch.arange(n, device=dev)
    if path == "k1":  # dot distances -q.x over a masked subset; zero rows
        x = torch.randn(n, 384, device=dev, generator=g)
        zero = rows % 97 == 0
        x[zero] = 0.0  # q.x = +0, so the distance is -0
        q = torch.randn(b, 384, device=dev, generator=g)
        mask = zero | (rows % (n // (k + k // 2)) == 1)
        vt, rt = topk_t.l2_topk(x, None, mask, q, k, metric="dot")
        d = torch.where(mask.cpu(), -(q.cpu() @ x.cpu().T),
                        torch.tensor(float("inf")))
    else:  # a buffer of positives, a few negatives, -0, +0 and +inf
        d = torch.rand(b, n, device=dev, generator=g) + 0.1
        d[:, rows % 157 == 2] *= -1.0
        d[:, rows % 97 == 0] = 0.0
        d[:, rows % 89 == 0] = -0.0
        d[:, rows % 50 == 3] = float("inf")
        run_v = torch.full((b, k), float("inf"), device=dev)
        run_r = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        vt, rt = topk_t.chunk_step(d, None, 0, run_v, run_r, k)
    vp, rp = _cpu_topk(d, k)
    zeros = (vp == 0) & (rp >= 0)
    assert (vp[:, 0] < 0).all() and zeros.any(1).all()
    if path == "k1":  # f32 sums in another order than the CPU's
        _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-3)
        assert torch.equal(rt.cpu()[zeros], rp[zeros])
    else:
        np.testing.assert_array_equal(rt.cpu().numpy(), rp.numpy())
        assert torch.equal(vt.cpu(), vp)


@pytest.mark.cuda
@pytest.mark.parametrize("metric,k,bf16", [
    ("dot", 16, False), ("cosine", 16, False), ("dot", 1024, False),
    ("cosine", 1024, True), ("dot", 128, True), ("cosine", 300, False)])
def test_l2_topk_by_metric_matches_plain_on_card(metric, k, bf16):
    """K1 by metric on f32 rows and on bf16 rows with the query rounded, at
    k <= 256 (lists) and k > 256 (buffer + radix select); dot distances are
    negative. A zero row sits at cosine distance 1."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(22)
    n, b = 131_072, 37
    xf = torch.randn(n, 384, device=dev, generator=g) + 0.5
    xf[5] = 0.0
    x_sq = (xf * xf).sum(1)
    x = xf.to(torch.bfloat16) if bf16 else xf
    q = torch.randn(b, 384, device=dev, generator=g) + 0.5
    mask = torch.rand(n, device=dev, generator=g) < 0.9
    mask[5] = True
    vt, rt = topk_t.l2_topk(x, x_sq, mask, q, k, round_query=bf16,
                            metric=metric)
    vp, rp = topk_t.l2_topk_plain(x, x_sq, mask, q, k, round_query=bf16,
                                  metric=metric)
    # dot: |q.x| ~ 100 here, f32 sums in another order; cosine within 1e-5
    atol = 1e-2 if metric == "dot" else 1e-5
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, atol)
    if metric == "dot":
        assert (vt[:, 0] < 0).all()
    else:
        full = topk_t.l2_topk(x, x_sq, mask, q[:1], n, round_query=bf16,
                              metric=metric)
        assert float(full[0][0][full[1][0] == 5][0]) == 1.0


def _bf16_mirror(m):
    """The f32 mirror's rows in bf16 with the f32 rows' norms, as a bf16
    serving mirror holds them."""
    return m.x.to(torch.bfloat16), m.x_sq


@pytest.mark.cuda
def test_greedy_descent_kernel_on_bf16_rows_matches_plain_on_card():
    g, m, mask, a, q = _graph_on_card()
    xb, x_sq = _bf16_mirror(m)
    stop = torch.tensor(np.arange(64) % 3, dtype=torch.int32, device=q.device)
    for s in (None, stop):
        ck, dk = hnsw_t.greedy_descent(xb, x_sq, mask, a["nbrs_up"],
                                       a["up_offset"], q, g.entry_point,
                                       g.max_level, s)
        cp, dp = hnsw_t.greedy_descent_plain(xb, x_sq, mask, a["nbrs_up"],
                                             a["up_offset"], q, g.entry_point,
                                             g.max_level, s)
        assert (ck == cp).float().mean().item() >= 0.99
        same = ck == cp
        torch.testing.assert_close(dk[same], dp[same], rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("expand,filtered,layer,s,ef", [
    (1, False, 0, 1, 200), (4, True, 0, 1, 64), (1, False, 1, 3, 64),
    (1, False, 2, 1, 200)])
def test_beam_search_kernel_on_bf16_rows_matches_plain_on_card(
        expand, filtered, layer, s, ef):
    """K11 on bf16 rows at the serve and link shapes and above layer 0
    (the per-layer link plan's beams), with inactive queries there: an
    inactive query returns its start set. Results overlap >= 0.99."""
    from fabstir_vectordb_tpu_torch.utils import native

    g, m, mask, a, q = _graph_on_card()
    xb, x_sq = _bf16_mirror(m)
    dev = q.device
    rng = np.random.default_rng(8)
    members = np.nonzero(g._search_mask() & (g.levels >= layer))[0]
    assert members.size > 0
    start = torch.from_numpy(rng.choice(members, (64, s)).astype(np.int32)
                             ).to(dev)
    res = None
    if filtered:
        res = torch.from_numpy(np.arange(m.x.shape[0]) % 3 != 0).to(dev)
    active = torch.from_numpy(np.arange(64) % 4 != 1).to(dev)
    args = (xb, x_sq, mask, a["nbrs0"], a["nbrs_up"], a["up_offset"], q,
            start, active, layer, ef, ef + 32, res, None, expand)
    name = native.counter("beam_search", True, up=layer > 0)
    before = native.launches[name]
    dk, ik = hnsw_t.beam_search(*args)
    assert native.launches[name] == before + 1
    dp, ip = hnsw_t.beam_search_plain(*args)
    # inactive queries: their (eligible) starts only, which may be none
    assert torch.equal(ik[~active], ip[~active])
    assert _overlap(ik[active], ip[active]) >= 0.99
    both = (ik == ip) & (ik >= 0)
    torch.testing.assert_close(dk[both], dp[both], rtol=1e-5, atol=1e-3)
    if filtered:
        got = ik.cpu().numpy()
        assert res.cpu().numpy()[got[got >= 0]].all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric,bf16,k,seeded", [
    ("euclidean", True, 16, True), ("cosine", False, 16, False),
    ("dot", False, 512, False), ("cosine", True, 16, False),
    ("dot", True, 16, False)])
def test_ivf_scan_kernel_by_metric_and_row_type_matches_plain_on_card(
        metric, bf16, k, seeded):
    """K12 on bf16 rows (upcast, f32 query, the f32 rows' norms) and by
    metric (probes ranked by K1 of the same metric; dot distances are
    negative), with a seed list joining."""
    from fabstir_vectordb_tpu_torch.index.ivf import (IVFIndex, IVFLists,
                                                      ivf_search,
                                                      ivf_search_plain)
    from fabstir_vectordb_tpu_torch.index.store import VectorStore

    dev = _card()
    n, d = 20_000, 384
    x, _ = _mixture(42, n, 64, d=d, spread=0.5)
    st = VectorStore(d, device=dev)
    rows = st.add_batch([f"r{i}" for i in range(n)], x)
    ivf = IVFIndex(st)
    rng = np.random.default_rng(4)
    ivf.set_trained(x[rng.choice(n, 32, replace=False)])
    ivf.insert_rows(rows[: n - 500])
    m = st.device_mirror("bfloat16" if bf16 else "float32")
    lists = IVFLists.upload(ivf.centroids, ivf.tiles(), dev)
    mask = torch.from_numpy(st.active_mask() & ivf.member_mask()).to(dev)
    q = torch.from_numpy(x[:37] + 0.2).to(dev)
    seed = None
    if seeded:
        sr = torch.arange(n - 500, n - 460, dtype=torch.int32,
                          device=dev)[None].repeat(37, 1)
        sd = torch.linspace(1.0, 400.0, 40, device=dev)[None].repeat(37, 1)
        seed = (sd.contiguous(), sr.contiguous())
    vk, rk, pk = ivf_search(m.x, m.x_sq, mask, lists, q, k, 8, seed=seed,
                            metric=metric)
    vp, rp, pp = ivf_search_plain(m.x, m.x_sq, mask, lists, q, k, 8,
                                  seed=seed, metric=metric)
    assert (pk == pp).all()
    atol = 1e-5 if metric == "cosine" else 1e-2
    _assert_close_up_to_ties(vk, rk, vp, rp, 1e-5, atol)
    if metric == "dot":
        assert (vk[:, 0] < 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,k,masked", [(4096, 10, False),
                                            (1000, 300, True)])
def test_chunked_topk_matches_plain_on_card(chunk, k, masked):
    """chunked_topk with a dist_fn of negative dot distances (and a mask):
    the composition of the chunk's radix select and K8's merge gives the
    plain version's rows, whose chunks are offset by their start."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(23)
    n, b = 20_000, 16
    x = torch.randn(n, 384, device=dev, generator=g)
    q = torch.randn(b, 384, device=dev, generator=g)
    keep = torch.rand(n, device=dev, generator=g) < 0.7

    def dist_fn(start, on=dev):
        xs = x[start: start + chunk].to(on)
        m = keep[start: start + chunk].to(on) if masked else None
        return -(q.to(on) @ xs.T), m

    vt, rt = topk_t.chunked_topk(dist_fn, n, chunk, k, b, device=dev)()
    vp, rp = topk_t.chunked_topk(lambda s: dist_fn(s, "cpu"), n, chunk, k,
                                 b, device="cpu")()
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)
    assert (vt[:, 0] < 0).all()
    if masked:
        assert keep[rt[rt >= 0].long()].all()


@pytest.mark.cuda
@pytest.mark.parametrize("k,mask_kind", [(10, "rows"), (256, "queries"),
                                         (256, None), (257, "rows")])
def test_chunk_step_pruning_bar_on_card(k, mask_kind):
    """A chunk step after a first one: entries that tie the running k-th
    distance exactly (at higher rows, so the running entries keep their
    places), entries just below it, slices whose every entry is masked out
    (the whole second half of the chunk, and for a [B, C] mask one query's
    whole chunk), negative distances; the fused step at kc 10 and 256, the
    radix select and merge at 257. The plain version's rows and values
    exactly."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(29)
    b, c = 8, 40_000
    d0 = torch.randn(b, c, device=dev, generator=g)
    run_v = torch.full((b, k), float("inf"), device=dev)
    run_r = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    v1, r1 = topk_t.chunk_step(d0, None, 0, run_v, run_r, k)
    d = torch.randn(b, c, device=dev, generator=g) + 0.5
    kth = v1[:, -1:]
    cols = torch.arange(c, device=dev)
    d = torch.where(cols % 37 == 5, kth, d)  # exact ties with the k-th
    d = torch.where(cols % 53 == 7, torch.nextafter(kth, kth - 1), d)
    if mask_kind == "rows":
        mask = cols < c // 2
    elif mask_kind == "queries":
        mask = (cols < c // 2)[None, :].expand(b, c).clone()
        mask[3] = False
    else:
        mask = None
    before = topk_t.native.launches["chunk_step"]
    vt, rt = topk_t.chunk_step(d, mask, c, v1, r1, k)
    assert topk_t.native.launches["chunk_step"] == before + 1
    vp, rp = topk_t.chunk_step_plain(
        d.cpu(), None if mask is None else mask.cpu(), c, v1.cpu(),
        r1.cpu(), k)
    np.testing.assert_array_equal(rt.cpu().numpy(), rp.numpy())
    assert torch.equal(vt.cpu(), vp)
    tied = (d == kth) & (mask if mask is not None else True)
    assert tied.any()
    # no tied entry enters: the running k-th keeps its place
    assert not torch.isin(rt.cpu(), (cols[tied.any(0)] + c).cpu()).any()


@pytest.mark.cuda
def test_seed_pick_fallback_flag_leaves_kmeans_par_bit_identical_on_card():
    """The k-means++ fallback flag changes nothing where a row is eligible
    (kmeans||'s picks, l = 1 and 409), and where none is it draws as the
    unweighted pick over the mask."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(31)
    n = 10_000
    mask = torch.rand(n, device=dev, generator=g) < 0.9
    d2 = torch.rand(n, device=dev, generator=g)
    d2[::3] = 0.0
    for l in (1, 409):
        u = torch.rand(n, device=dev, generator=g)
        a = km_t.seed_pick(d2, mask, u, l)
        b = km_t.seed_pick(d2, mask, u, l, unweighted_if_empty=True)
        assert torch.equal(a, b)
        assert torch.equal(a, km_t.seed_pick_plain(d2, mask, u, l))
    zero = torch.zeros(n, device=dev)
    u = torch.rand(n, device=dev, generator=g)
    assert int(km_t.seed_pick(zero, mask, u, 1)[0]) == -1
    got = km_t.seed_pick(zero, mask, u, 1, unweighted_if_empty=True)
    assert torch.equal(got, km_t.seed_pick(None, mask, u, 1, weighted=False))
    assert torch.equal(got, km_t.seed_pick_plain(zero, mask, u, 1, True,
                                                 unweighted_if_empty=True))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c", [(4_097, 48, 256), (1_000, 8, 16),
                                   (2_000, 384, 64)])
def test_kmeans_pp_and_train_match_plain_on_card(n, d, c):
    """k-means++ on K7's kernels picks the plain version's rows from the
    same generator state (a key tie between two rows, ~1e-6 a pick here,
    is the only way apart), never a row outside the mask; Lloyd from it
    converges within 1% of the plain run's error."""
    dev = _card()
    xs, _ = _mixture(32, n, 40, d=d, spread=0.5)
    x = torch.from_numpy(xs).to(dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[-13:] = False
    x[-13:] = 1e4  # poisoned and masked out
    state = torch.Generator(device=dev).manual_seed(5).get_state()
    picks = {}
    for plain in (False, True):
        g = torch.Generator(device=dev)
        g.set_state(state)
        picks[plain] = km_t._pp_rows(g, x, mask, c, plain=plain)
    assert torch.equal(picks[False], picks[True])
    rows = picks[False].cpu().numpy()
    assert ((rows >= 0) & (rows < n - 13)).all()
    assert len(set(rows.tolist())) == c
    init = x[picks[False].long()]
    kern = km_t._lloyd_until(x, mask, init, 25, 1e-4, km_t.lloyd_block)
    plain = km_t._lloyd_until(x, mask, init, 25, 1e-4,
                              km_t.lloyd_block_plain)
    assert kern.iterations == plain.iterations
    assert kern.converged == plain.converged
    assert abs(kern.final_error - plain.final_error) <= \
        0.01 * plain.final_error
    assert kern.centroids.shape == (c, d)
    tol = 1e-5 * float(x[:-13].abs().max())
    assert float((kern.centroids - plain.centroids).abs().max()) <= tol


@pytest.mark.cuda
def test_kmeans_pp_init_past_the_rows_on_card():
    """More clusters than rows in the mask, and all-duplicate rows: the
    fallback keeps every pick a real row of the mask."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(300, 384, device=dev, generator=g)
    mask = torch.arange(300, device=dev) < 287
    rows = km_t._pp_rows(g, x, mask, 300).cpu().numpy()
    assert rows.shape == (300,) and ((rows >= 0) & (rows < 287)).all()
    assert len(set(rows.tolist())) >= 280
    dup = x[:1].repeat(500, 1)
    c = km_t.kmeans_pp_init(g, dup, torch.ones(500, dtype=torch.bool,
                                                device=dev), 8)
    assert torch.equal(c, dup[:8])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1_000, 384), (37, 33), (5_000, 8)])
def test_quantize_kernels_match_plain_on_card(n, d):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(33)
    x = torch.randn(n, d, device=dev, generator=g) * 3.0
    x[1] = 0.5  # a constant row
    ck, mk, sk = qz_t.quantize_u8(x)
    cp, mp, sp = qz_t.quantize_u8_plain(x)
    assert torch.equal(ck, cp) and torch.equal(mk, mp) and torch.equal(sk, sp)
    assert float(sk[1]) == 1.0 and int(ck[1].max()) == 0
    yk = qz_t.dequantize_u8(ck, mk, sk)
    assert torch.equal(yk, qz_t.dequantize_u8_plain(ck, mk, sk))
    assert ((yk - x).abs() <= sk[:, None] / 2
            + 1e-6 * (x.abs() + mk.abs()[:, None])).all()


def _codes_equal_up_to_ties(x, cents, got, want, rel=1e-6):
    """PQ codes equal, or the two codes' distances to the row's subvector
    tie within rel of the norm expansion's terms (f32 sums in another order
    may pick either). Returns the count of codes that differ."""
    ds = cents.shape[2]
    n_idx, m_idx = torch.nonzero(got != want, as_tuple=True)
    for n, j in zip(n_idx.tolist(), m_idx.tolist()):
        v = x[n, j * ds:(j + 1) * ds].double()
        a = cents[j, int(got[n, j])].double()
        b = cents[j, int(want[n, j])].double()
        da, db = ((v - a) ** 2).sum(), ((v - b) ** 2).sum()
        scale = (v * v).sum() + max((a * a).sum(), (b * b).sum())
        assert abs(float(da - db)) <= rel * float(scale), (n, j)
    return int(n_idx.numel())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,ds", [(1, 16, 48), (8, 256, 48), (48, 256, 4),
                                    (8, 16, 4), (48, 16, 48), (48, 256, 8),
                                    (1, 256, 384), (3, 256, 128),
                                    (2, 200, 130), (384, 16, 1),
                                    (250, 16, 2)])
def test_pq_kernels_match_plain_on_card(m, k, ds):
    """encode / decode / tables / the ADC scan at odd shapes: N not a
    multiple of a block's rows, every code-load width of the scan (M = 1:
    bytes, 8: 8-byte, 48: 16-byte loads), B not a multiple of its query
    group; codebooks too wide for shared memory (Ds = 384, 128, 130: the
    sliced encode) and more subspaces than one launch of the scan holds
    (M = 384, 250: launches of 96)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(34)
    n, b = 3_001, 37
    cents = torch.randn(m, k, ds, device=dev, generator=g)
    x = torch.randn(n, m * ds, device=dev, generator=g)
    q = torch.randn(b, m * ds, device=dev, generator=g)
    ck = qz_t.pq_encode(cents, x)
    cp = qz_t.pq_encode_plain(cents, x)
    assert ck.dtype == torch.uint8 and ck.shape == (n, m)
    assert _codes_equal_up_to_ties(x, cents, ck, cp) <= n * m // 1000
    dk = qz_t.pq_decode(cents, ck)
    assert torch.equal(dk, qz_t.pq_decode_plain(cents, ck))
    tk = qz_t.pq_adc_table(cents, q)
    tp = qz_t.pq_adc_table_plain(cents, q)
    torch.testing.assert_close(tk, tp, rtol=1e-5, atol=1e-5)
    for bb in (1, b):
        ak = qz_t.pq_adc_distances(tk[:bb].contiguous(), ck)
        ap = qz_t.pq_adc_distances_plain(tk[:bb].contiguous(), ck)
        assert torch.equal(ak, ap)  # the same adds in the same order
    exact = ((q[:, None, :].double() - dk[None].double()) ** 2).sum(-1)
    torch.testing.assert_close(ak.double(), exact, rtol=1e-5, atol=1e-4)


def _shard_lists(g, dev, s, b, ks, signed=True):
    """Each of s shards' partial top-ks lists of b queries, sorted, with
    signed distances, a few ties and a (+inf, -1) padded tail."""
    vals = torch.randn(s, b, ks, device=dev, generator=g) * 10
    if not signed:
        vals = vals.abs()
    vals[:, :, ::7] = vals[:, :, :1]  # ties inside a list and across shards
    vals, _ = torch.sort(vals, dim=-1)
    rows = torch.randint(0, 1_000, (s, b, ks), device=dev, generator=g,
                         dtype=torch.int32)
    rows = rows + torch.arange(ks, device=dev, dtype=torch.int32) * 1_000
    pad = max(1, ks // 5)
    vals[:, 1::2, -pad:] = float("inf")
    rows[:, 1::2, -pad:] = -1
    rows[-1, 0, 0] = -1  # a lone -1 with a finite distance never enters
    return vals.contiguous(), rows.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 4, 8])
@pytest.mark.parametrize("ks", [10, 200, 2048])
@pytest.mark.parametrize("mapped", [False, True])
def test_shard_merge_matches_plain_on_card(s, ks, mapped):
    """K15's shard merge: the bitonic path (S * k_s <= 2,048) and the radix
    select past it, signed distances, padding, row bases and a row map;
    exactly the plain version's (distance, row) list."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(s * 10_000 + ks)
    b = 37
    vals, rows = _shard_lists(g, dev, s, b, ks)
    per = int(rows.max()) + 1
    base = torch.arange(s, dtype=torch.int32, device=dev) * per
    row_map = None
    if mapped:  # shard s's local row r is global row_map[s * per + r]
        row_map = torch.randperm(s * per, device=dev, generator=g).to(
            torch.int32)
    for k in sorted({1, 10, min(ks, 200), ks, s * ks + 3}):
        vk, rk = topk_t.shard_merge(vals, rows, k, base=base, row_map=row_map)
        vp, rp = topk_t.shard_merge_plain(vals, rows, k, base=base,
                                          row_map=row_map)
        assert torch.equal(rk, rp) and torch.equal(vk, vp), (k,)
    assert (rk[:, -3:] == -1).all() and torch.isinf(vk[:, -3:]).all()


@pytest.mark.cuda
def test_set_rows_matches_plain_on_card():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(35)
    mask = torch.rand(100_003, device=dev, generator=g) < 0.3
    rows = torch.randint(-5, 100_010, (4_097,), device=dev, generator=g,
                         dtype=torch.int32)
    rows[-64:] = rows[0]  # the builder's idempotent bucket padding
    want = ingest_t._set_rows_true_plain(mask.clone(), rows)
    got = ingest_t._set_rows_true(mask, rows)
    assert got is mask and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,shards", [(65_536, 256, 1), (65_536, 256, 4),
                                        (1_001, 16, 8)])
def test_lloyd_partial_finish_equal_a_lloyd_block_step_on_card(n, c, shards):
    """K6 split: the shards' partials summed then the finish equal one
    lloyd_block step (and the plain halves) up to K6's atomic order."""
    dev = _card()
    x_np, _ = _mixture(36, n, c, d=64, spread=1.0)
    x = torch.from_numpy(x_np).to(dev)
    mask = torch.rand(n, device=dev, generator=torch.Generator(
        device=dev).manual_seed(37)) < 0.9
    rng = np.random.default_rng(38)
    init = x[torch.from_numpy(rng.choice(n, c, replace=False)).to(dev)]
    sl = [slice(i * n // shards, (i + 1) * n // shards) for i in range(shards)]
    parts = [km_t.lloyd_partial(x[s], mask[s], init) for s in sl]
    sums, counts, stats = (sum(p[i] for p in parts) for i in range(3))
    ck, ek = km_t.lloyd_finish(sums, counts, stats, init)
    cb, eb = km_t.lloyd_block(x, mask, init, 1)
    pp = [km_t.lloyd_partial_plain(x[s], mask[s], init) for s in sl]
    cp, ep = km_t.lloyd_finish_plain(*(sum(p[i] for p in pp)
                                       for i in range(3)), init)
    tol = 1e-5 * float(x.abs().max())
    assert float((ck - cb[0]).abs().max()) <= tol
    assert float((ck - cp).abs().max()) <= tol
    assert abs(float(ek) - float(eb[0])) <= 1e-5 * float(eb[0])
    assert abs(float(ek) - float(ep)) <= 1e-5 * float(ep)
    assert torch.equal(counts, sum(p[1] for p in pp))


@pytest.mark.cuda
def test_ivf_scan_with_a_list_range_matches_plain_on_card():
    """K12 on each of 4 shards' lists (probes global, lists outside the
    shard's range scan nothing), against the plain version, and the 4
    shards merged equal to one scan of every list."""
    from fabstir_vectordb_tpu_torch.index.ivf import (IVFIndex, IVFLists,
                                                      ivf_scan,
                                                      ivf_scan_plain)
    from fabstir_vectordb_tpu_torch.index.store import VectorStore
    from fabstir_vectordb_tpu_torch.parallel import sharded as sharded_t
    from fabstir_vectordb_tpu_torch.parallel.mesh import LocalMesh

    dev = _card()
    n, d, c = 20_000, 384, 64
    x, _ = _mixture(39, n, 64, d=d, spread=0.5)
    st = VectorStore(d, device=dev)
    rows = st.add_batch([f"r{i}" for i in range(n)], x)
    ivf = IVFIndex(st)
    rng = np.random.default_rng(40)
    ivf.set_trained(x[rng.choice(n, c, replace=False)])
    ivf.insert_rows(rows)
    active = st.active_mask()
    active[rng.choice(n, 500, replace=False)] = False
    mesh = LocalMesh(4, device=dev)
    state = sharded_t.shard_ivf_state(mesh, ivf.centroids, ivf.tiles(), x,
                                      active)
    q = torch.from_numpy(x[:37] + 0.2).to(dev)
    _, probe = topk_t.l2_topk(state.centroids, state.c_sq, None, q, 16)
    parts = []
    for s, sh in state.shards.items():
        vk, rk = ivf_scan(sh.x, sh.x_sq, sh.valid, sh.lists, probe, q, 16,
                          c_lo=sh.c_lo)
        vp, rp = ivf_scan_plain(sh.x, sh.x_sq, sh.valid, sh.lists, probe, q,
                                16, c_lo=sh.c_lo)
        _assert_close_up_to_ties(vk, rk, vp, rp, 1e-5, 1e-2)
        parts.append((vk, rk))
    vm, rm = topk_t.shard_merge(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1] for p in parts]), 16,
                                base=state.map_base, row_map=state.row_map)
    lists = IVFLists.upload(ivf.centroids, ivf.tiles(), dev)
    mask = torch.from_numpy(active & ivf.member_mask()).to(dev)
    xd = torch.from_numpy(x).to(dev)
    vw, rw = ivf_scan(xd, (xd * xd).sum(1), mask, lists, probe, q, 16)
    _assert_close_up_to_ties(vm, rm, vw, rw, 1e-5, 1e-2)


@pytest.mark.cuda
def test_set_member_rows_matches_plain_on_card():
    """B1: the pipelined build's member scatter, through the set-rows
    kernel, with its own counter."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(47)
    mask = torch.rand(1_048_576, device=dev, generator=g) < 0.1
    rows = torch.randint(0, 1_048_576, (1_024,), device=dev, generator=g,
                         dtype=torch.int32)
    want = hnsw_t.set_member_rows_plain(mask.clone(), rows)
    before = native.launches["set_member_rows"]
    got = hnsw_t.set_member_rows(mask, rows)
    assert native.launches["set_member_rows"] == before + 1
    assert got is mask and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_lloyd_step_matches_plain_on_card(masked):
    """B2: one Lloyd iteration (K6's partial and finish) against the plain
    step, centroids within 1e-5 of the data scale (K6's atomic order), the
    error within 1e-5 relative."""
    dev = _card()
    n, c = 65_536, 256
    x_np, lab = _mixture(48, n, c, d=384, spread=1.0)
    x = torch.from_numpy(x_np).to(dev)
    mask = (torch.rand(n, device=dev, generator=torch.Generator(
        device=dev).manual_seed(49)) < 0.9) if masked else None
    # one starting centroid a cluster, so no bisector rows tie
    first = np.array([np.flatnonzero(lab == i)[0] for i in range(c)])
    init = x[torch.from_numpy(first).to(dev)]
    ck, ek = km_t.lloyd_step(x, mask, init)
    cp, ep = km_t.lloyd_step_plain(x, mask, init)
    assert float((ck - cp).abs().max()) <= 1e-5 * float(x.abs().max())
    assert abs(float(ek) - float(ep)) <= 1e-5 * float(ep)
    cb, eb = km_t.lloyd_block(x, mask if masked else torch.ones(
        n, dtype=torch.bool, device=dev), init, 1)
    assert float((ck - cb[0]).abs().max()) <= 1e-5 * float(x.abs().max())


def _signed_matrix(g, dev, b, n):
    """Signed distances with ties, +-inf and NaNs."""
    d = torch.randn(b, n, device=dev, generator=g)
    d[:, 1::7] = d[:, ::7][:, : d[:, 1::7].shape[1]]  # exact ties
    d[:, 3::101] = float("nan")
    d[:, 5::211] = float("inf")
    d[:, 9::307] = -float("inf")
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,mask_kind", [
    (128, 1_048_576, 16, "rows"), (128, 1_048_576, 1_024, "rows"),
    (37, 4096, 64, "per_query"), (5, 300, 700, "none"),
    (3, 1000, 256, "sparse")])
def test_masked_topk_matches_plain_on_card(b, n, k, mask_kind):
    """B3: the entry point's radix select against the plain sort, exactly
    (the same (distance, row) list), k > N and NaN / +-inf entries
    included (never selected)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(51 + k)
    d = _signed_matrix(g, dev, b, n)
    mask = {"rows": lambda: torch.rand(n, device=dev, generator=g) < 0.9,
            "per_query": lambda: torch.rand(b, n, device=dev,
                                            generator=g) < 0.5,
            "sparse": lambda: torch.rand(n, device=dev, generator=g) < 0.05,
            "none": lambda: None}[mask_kind]()
    vk, rk = topk_t.masked_topk(d, mask, k)
    vp, rp = topk_t.masked_topk_plain(d, mask, k)
    assert torch.equal(rk, rp) and torch.equal(vk, vp)
    if k > n:
        assert (rk[:, n:] == -1).all() and torch.isinf(vk[:, n:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,mask_kind", [
    (128, 1_048_576, 128, "rows"), (37, 100_000, 16, "per_query"),
    (4, 4096, 1_000, "none"), (3, 50_000, 64, "sparse")])
def test_masked_approx_topk_matches_plain_on_card(b, n, k, mask_kind):
    """B4: the bin minima of a given matrix and their radix select against
    the plain binning, exactly; M >= N (k = 1,000 of 4,096) takes B3."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(61 + k)
    d = _signed_matrix(g, dev, b, n)
    mask = {"rows": lambda: torch.rand(n, device=dev, generator=g) < 0.9,
            "per_query": lambda: torch.rand(b, n, device=dev,
                                            generator=g) < 0.5,
            "sparse": lambda: torch.rand(n, device=dev, generator=g) < 0.01,
            "none": lambda: None}[mask_kind]()
    vk, rk = topk_t.masked_approx_topk(d, mask, k)
    vp, rp = topk_t.masked_approx_topk_plain(d, mask, k)
    assert torch.equal(rk, rp) and torch.equal(vk, vp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_mirror_on_card_equals_an_upload(dtype, monkeypatch):
    """A lazy load's materializer stages the rows' uploads on a side stream
    and installs the mirror with an event: after it, the mirror is
    bit-identical to a fresh upload, and a search straight after the
    install (its stream waits on the event) answers as one after a fresh
    upload."""
    from fabstir_vectordb_tpu_torch.core.object_store import \
        MemoryObjectStore
    from fabstir_vectordb_tpu_torch.index.hybrid import (HybridConfig,
                                                         HybridIndex,
                                                         SearchConfig)
    from fabstir_vectordb_tpu_torch.storage.persistence import \
        HybridPersister

    dev = _card()
    monkeypatch.setenv("FVDB_SERVING_DTYPE", dtype)
    x = _data(52, 50_000, d=384)
    h = HybridIndex(384, HybridConfig(auto_migrate=False), device=dev)
    h.insert_batch([f"v{i}" for i in range(50_000)], x,
                   np.full(50_000, 1.0e9), now=1.0e9)
    mem = MemoryObjectStore()
    HybridPersister(mem).save_index_chunked(h, "s", chunk_size=4_096)
    for lazy in (True, False):
        loaded, _ = HybridPersister(mem).load_index_chunked("s", lazy=lazy)
        loaded.wait_ready(timeout=600)
        m = loaded.store._mirror
        assert m is not None and m.ready is not None and m.dtype == dtype
        q = x[:64] + 0.1
        cfg = SearchConfig(auto_migrate=False)
        d, rows = loaded.search_rows(q, 10, config=cfg, now=1.0e9)
        staged_x, staged_sq = m.x.clone(), m.x_sq.clone()
        loaded.store.release_mirror()
        fresh = loaded.store.device_mirror(dtype)
        assert torch.equal(staged_x, fresh.x)
        assert torch.equal(staged_sq, fresh.x_sq)
        # the search on the staged mirror answers as on a fresh upload
        dw, want = loaded.search_rows(q, 10, config=cfg, now=1.0e9)
        assert np.array_equal(rows, want) and np.array_equal(d, dw)
