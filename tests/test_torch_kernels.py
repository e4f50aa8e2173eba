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

from .test_torch_kmeans_checks import (TIE, lloyd_check, pp_key_gaps,
                                       pp_uniforms_card, recording)

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


def _candidate_pools(seed, b, c, n=2000, pad_from=None, d=D):
    """Candidate pools sorted by distance to their query, as the link path
    builds them; rows past ``pad_from`` are (-1, +inf) padding."""
    rng = np.random.default_rng(seed)
    x = _data(seed, n, d)
    q = _data(seed + 1, b, d)
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
    m = st.device()
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
    m = st.device()
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
    scratch (the tensor-core route's plan) is held one at a time, one
    launch counted each."""
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
    per_query = fused_t.stage1_query_bytes(n, r, ov_k, "cuda")
    budget = {"transient_bytes": chunk * per_query} if chunk else {}
    vt, rt = fused_t.stage1_select(xp, xp_sq, mask, qp, ov_k, **budget)
    assert native.launches["stage1_select"] - before == -(-b // (chunk or b))
    assert native.launches["stage1_select_overflow"] == 0
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
    candidates): the pick, and the table update and counts on K6's tile
    pass (the first update, one candidate, on the FMA route)."""
    from fabstir_vectordb_tpu_torch.utils import native

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
    native.reset_launches()
    d2 = torch.full((10_000,), float("inf"), device=dev)
    dk = km_t.seed_min_update(x, mask, d2, first_p)
    d2 = km_t.seed_min_update_plain(x, mask, d2, first_p)
    # distances to one candidate, up to ~12,000: f32 sums of 384 products in
    # two orders, ~2e-6 of the expansion's terms each
    x_sq = float((x * x).sum(1).max())
    torch.testing.assert_close(dk, d2, rtol=1e-5, atol=4e-6 * x_sq)
    assert native.launches["seed_min_update_fma"] == 1
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
    assert native.launches["seed_min_update"] == 5
    cand = torch.cat(cand)
    ck = km_t.seed_counts(x, mask, cand)
    cp = km_t.seed_counts_plain(x, mask, cand)
    assert native.launches["seed_counts"] == 1
    assert int(ck.sum()) == int(cp.sum()) == int(mask.sum())
    assert (ck == cp).float().mean().item() >= 0.99
    # rows moved between candidates: at most 0.1%
    assert int((ck - cp).abs().sum()) // 2 <= 0.001 * int(mask.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c,short,route", [
    (10_000, 384, 409, 0, "tf32x3"),     # a kmeans|| round at 256 lists
    (10_000, 384, 2_046, 0, "tf32x3"),   # the counts' candidates
    (10_000, 384, 409, 57, "tf32x3"),    # a short pick: -1 at the end
    (5_000, 128, 63, 5, "fma"),          # under LLOYD_TC_MIN_C
    (5_000, 128, 64, 5, "tf32x3"),
    (3_001, 130, 200, 9, "fma"),         # D % 4 != 0
])
def test_kmeans_seed_tile_pass_matches_plain_on_card(n, d, c, short, route):
    """kmeans||'s table update and counts by route (ops/kmeans.py
    lloyd_route): the table within rtol 1e-5 (and 4e-6 of the largest
    |x|^2: f32 sums of d products in two orders, ~2e-6 of the expansion's
    terms each), the histograms with the same total and at most 0.1% of
    the rows moved; -1 candidates skipped."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    xs, _ = _mixture(26, n, 96, d=d, spread=0.5)
    x = torch.from_numpy(xs).to(dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[::29] = False
    g = torch.Generator(device=dev).manual_seed(8)
    cand = torch.randperm(n, device=dev, generator=g)[:c].to(torch.int32)
    if short:
        cand[-short:] = -1
    d2 = torch.rand(n, device=dev, generator=g) * 400.0
    d2[::7] = float("inf")
    assert km_t.lloyd_route(n, c, d) == route
    native.reset_launches()
    dk = km_t.seed_min_update(x, mask, d2, cand)
    dp = km_t.seed_min_update_plain(x, mask, d2, cand)
    ck = km_t.seed_counts(x, mask, cand)
    cp = km_t.seed_counts_plain(x, mask, cand)
    torch.cuda.synchronize()
    tail = "" if route == "tf32x3" else "_fma"
    assert native.launches[f"seed_min_update{tail}"] == 1
    assert native.launches[f"seed_counts{tail}"] == 1
    x_sq = float((x * x).sum(1).max())
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=4e-6 * x_sq)
    assert bool((dk[~mask] == 0).all())
    assert int(ck.sum()) == int(cp.sum()) == int(mask.sum())
    if short:
        assert int(ck[-short:].abs().sum()) == 0
    assert int((ck - cp).abs().sum()) // 2 <= 0.001 * int(mask.sum())


def _pp_case(n, d, seed=27, spread=0.5):
    """Rows of a mixture with the last 13 masked out and poisoned with
    1e4 (they would win every weighted draw)."""
    xs, _ = _mixture(seed, n, 40, d=d, spread=spread)
    xs[-13:] = 1e4
    mask = np.arange(n) < n - 13
    return xs, mask


def _pp_check(x, mask, c, n_sub, seed, upto=None):
    """The kernel's k-means++ picks against the plain version's under one
    seed: every subspace's first pick apart (if any, before ``upto``) is a
    key tie within 1e-6, no masked row is picked, and the card's Philox
    routine (the one the kernel draws through) gives the plain version's
    uniforms bit for bit."""
    rk = km_t.kmeans_pp_rows(seed, x, mask, c, n_sub)
    rp = km_t.kmeans_pp_rows(seed, x, mask, c, n_sub, plain=True)
    assert rk.shape == (n_sub, c)
    for m, i, gap in pp_key_gaps(seed, x, mask, rk, rp, n_sub):
        assert i >= (upto or c) or gap <= 1e-6, (m, i, gap)
    assert bool(mask[rk.long()].all())
    n = x.shape[0]
    for m, step in ((0, 0), (n_sub - 1, c - 1), (n_sub // 2, 1)):
        assert torch.equal(pp_uniforms_card(seed, m, step, n, x.device),
                           km_t.pp_uniforms(seed, [m], step, n, x.device)[0])
    return rk, rp


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c,n_sub", [
    (4_097, 48, 256, 1), (1_000, 8, 16, 1), (2_000, 384, 64, 1),
    (4_096, 384, 256, 8), (4_096, 384, 256, 48),   # PQ's M = 8 and 48
    (1_000, 33, 16, 1), (999, 30, 12, 3),         # 4-byte loads
])
def test_kmeans_pp_kernel_matches_plain_on_card(n, d, c, n_sub):
    """K7's k-means++ in one launch (every pick of every subspace) against
    its plain version, pick for pick up to key ties; masked rows poisoned,
    N not a multiple of a block's rows."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    xs, mask = _pp_case(n, d)
    x, mask = torch.from_numpy(xs).to(dev), torch.from_numpy(mask).to(dev)
    native.reset_launches()
    rk, rp = _pp_check(x, mask, c, n_sub, 0x1234_5678_9ABC + n)
    assert native.launches["kmeans_pp"] == 1
    for m in range(n_sub):
        assert len(set(rk[m].tolist())) == c


@pytest.mark.cuda
@pytest.mark.parametrize("n_sub", [1, 4])
def test_kmeans_pp_kernel_duplicates_and_few_rows_on_card(n_sub):
    """All-duplicate rows take the uniform fallback (the plain version's
    draws exactly), and C past the rows in the mask repeats rows: pick for
    pick while a row in the mask is left, then rows of the mask (each
    picked row's d2 there is its own rounding, 0 in the kernel, in the
    plain version whatever its sums give)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(28)
    dup = torch.randn(1, 64, device=dev, generator=g).repeat(700, 1)
    mask = torch.arange(700, device=dev) < 650
    rk, rp = _pp_check(dup, mask, 32, n_sub, 77)
    assert torch.equal(rk, rp)
    x = torch.randn(300, 384, device=dev, generator=g)
    mask = torch.arange(300, device=dev) < 287
    rk, _ = _pp_check(x, mask, 300, n_sub, 78, upto=287)
    for m in range(n_sub):
        assert len(set(rk[m].tolist())) == 287


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
@pytest.mark.parametrize("budget_gib,launches", [(2, 1), (1, 1), (0, 2)])
def test_stage1_launches_follow_the_transient_budget(budget_gib, launches):
    """A 32-query sub-batch over 10,485,760 rows: the tensor-core route
    holds the sample's and the survivors' keys, not a [B, N] buffer
    (41.9 MB a query, 25 queries under 1 GiB), so under 1 GiB and under
    the 2 GiB that the reduced-rank dispatch passes at bench.py's operating
    point it is one launch that reads the mirror once; under 16 queries'
    worth of scratch (budget 0 here) two launches; the answers are the
    same."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(12)
    n, r, b = 10_485_760, 16, 32
    assert (1 << 30) // (4 * n) == 25
    per_query = fused_t.stage1_query_bytes(n, r, 64, "cuda")
    budget = (budget_gib << 30) or 16 * per_query
    xp = torch.randn(n, r, device=dev, generator=g).to(torch.bfloat16)
    xp_sq = (xp.float() ** 2).sum(1)
    qp = torch.randn(b, r, device=dev, generator=g)
    before = native.launches["stage1_select"]
    vt, rt = fused_t.stage1_select(xp, xp_sq, None, qp, 64, budget)
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


def _serving_mirror(seed, n, d, b, mask_kind, dev):
    """A bf16 serving mirror on the card: rows rounded to bf16 with the f32
    rows' norms (shifted off the origin, so cosine and dot rank), queries,
    and a mask of rows ("rows", 90%), of (query, row) pairs ("per_query",
    50%) or none."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xf = torch.randn(n, d, device=dev, generator=g) + 0.3
    x_sq = (xf * xf).sum(1)
    q = torch.randn(b, d, device=dev, generator=g) + 0.3
    mask = None
    if mask_kind == "rows":
        mask = torch.rand(n, device=dev, generator=g) < 0.9
    elif mask_kind == "per_query":
        mask = torch.rand(b, n, device=dev, generator=g) < 0.5
    return xf.to(torch.bfloat16), x_sq, q, mask


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,d,mask_kind,metric", [
    (1, 1, 384, "rows", "euclidean"), (1, 128, 384, "none", "euclidean"),
    (8, 16, 384, "per_query", "euclidean"), (9, 256, 384, "rows", "cosine"),
    (128, 16, 384, "rows", "dot"), (128, 128, 768, "rows", "euclidean"),
    (129, 64, 384, "per_query", "cosine"), (129, 1024, 384, "rows",
                                             "euclidean"),
    (1, 1024, 768, "none", "dot"), (9, 1024, 384, "per_query", "cosine"),
    (128, 1, 768, "none", "cosine"), (8, 256, 768, "per_query", "dot"),
    (9, 16, 96, "rows", "euclidean"), (129, 300, 200, "per_query", "dot"),
    (8, 16, 8, "none", "euclidean"),
    (128, 256, 100, "rows", "euclidean"), (8, 1024, 100, "none", "cosine"),
    (1, 16, 100, "per_query", "dot")])
def test_l2_topk_rounded_query_by_shape_matches_plain_on_card(
        b, k, d, mask_kind, metric):
    """K1 on a bf16 serving mirror, the query rounded, at B 1 / 8 / 9 / 128
    / 129, k 1 to 1,024 (lists and buffer), D 384 / 768 on the tensor cores
    (csrc/bf16_tile.cuh; 96, 200 and 8 an odd count of 32-dim steps) and
    D 100 on the FMA pass, with each mask kind
    and metric, over N = 50,001 (not a multiple of a tile): rows equal to
    the plain version up to ties, distances within 1e-5 relative; the
    launch counted on the route tile_route names."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    x, x_sq, q, mask = _serving_mirror(31, 50_001, d, b, mask_kind, dev)
    counter = native.counter("l2_topk", True, metric, rq=True)
    before = (native.launches[counter],
              native.launches[native.counter("l2_topk", True, metric,
                                             rq=True, fma=True)])
    vt, rt = topk_t.l2_topk(x, x_sq, mask, q, k, round_query=True,
                            metric=metric)
    after = (native.launches[counter],
             native.launches[native.counter("l2_topk", True, metric,
                                            rq=True, fma=True)])
    tc = topk_t.tile_route(x.dtype, True, d) == "wgmma"
    assert (after[0] - before[0], after[1] - before[1]) == \
        ((1, 0) if tc else (0, 1))
    vp, rp = topk_t.l2_topk_plain(x, x_sq, mask, q, k, round_query=True,
                                  metric=metric)
    atol = 1e-5 if metric == "cosine" else 1e-2
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, atol)
    assert (vt[:, 1:] >= vt[:, :-1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,keep,n,ov_k", [
    (1, 384, 1.0, 262_144, 128), (128, 384, 0.9, 262_144, 128),
    (129, 384, 0.002, 100_000, 64), (1, 100, 0.9, 100_000, 128),
    (129, 100, 1.0, 50_001, 16), (128, 384, 0.9, 2000, 128),
    (1, 384, 0.002, 4000, 256), (128, 200, 0.9, 100_000, 128)])
def test_approx_topk_rounded_query_by_shape_matches_plain_on_card(
        b, d, keep, n, ov_k):
    """K9 on bf16 rows, the query rounded, at B 1 / 128 / 129 and D 384
    or 200 (tensor cores) / 100 (FMA), keeping every row, 90% or 0.2% (the
    pool pads); a last partial round (N not a multiple of M) and M = N (N
    <= 4,972 at these ov_k): pools share >= 0.99 of their rows, shared
    rows' distances within 1e-5 relative."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    x, x_sq, q, _ = _serving_mirror(32, n, d, b, "none", dev)
    g = torch.Generator(device=dev).manual_seed(33)
    mask = torch.rand(n, device=dev, generator=g) < keep
    before = (native.launches["approx_topk"],
              native.launches["approx_topk_bf16_rq_fma"])
    vt, rt = topk_t.approx_topk(x, x_sq, mask, q, ov_k, round_query=True)
    tc = topk_t.tile_route(x.dtype, True, d) == "wgmma"
    assert (native.launches["approx_topk"] - before[0],
            native.launches["approx_topk_bf16_rq_fma"] - before[1]) == \
        ((1, 0) if tc else (0, 1))
    vp, rp = topk_t.approx_topk_plain(x, x_sq, mask, q, ov_k,
                                      round_query=True)
    assert _pool_overlap(rt, rp) >= 0.99
    _assert_shared_rows_close(vt, rt, vp, rp, 1e-5)
    fin = torch.isfinite(vt)
    assert torch.equal(fin, torch.isfinite(vp)) and (rt[~fin] == -1).all()
    assert mask[rt[fin].long()].all()
    assert (vt[:, 1:] >= vt[:, :-1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 100, 129])
def test_bf16_tile_small_corpora_match_plain_on_card(n):
    """The tensor-core pass over fewer rows than a tile (TMA fills the
    rest of the box with zeros): K1 with lists (k 16) and with the buffer
    (k 300), K9 where M = N, against their plain versions; past N the
    results pad with (+inf, -1)."""
    dev = _card()
    x, x_sq, q, mask = _serving_mirror(37, n, 384, 5, "rows", dev)
    for k in (16, 300):
        vt, rt = topk_t.l2_topk(x, x_sq, mask, q, k, round_query=True)
        vp, rp = topk_t.l2_topk_plain(x, x_sq, mask, q, k,
                                      round_query=True)
        _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)
    vt, rt = topk_t.approx_topk(x, x_sq, mask, q, 64, round_query=True)
    vp, rp = topk_t.approx_topk_plain(x, x_sq, mask, q, 64,
                                      round_query=True)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("path,k", [("lists", 16), ("dump", 300),
                                    ("bins", 64)])
def test_bf16_tile_ties_come_out_by_row_on_card(path, k):
    """Duplicated rows sit at equal distances: the tensor-core pass puts
    them in ascending row order, in its lists, its buffer and its bins,
    and picks the rows the plain version picks."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(34)
    half = 3000
    xf = torch.randn(half, 384, device=dev, generator=g)
    xf = torch.cat([xf, xf[:half // 2], xf])  # every row twice or more
    x_sq = (xf * xf).sum(1)
    x = xf.to(torch.bfloat16)
    q = xf[:16] + 0.05 * torch.randn(16, 384, device=dev, generator=g)
    if path == "bins":
        vt, rt = topk_t.approx_topk(x, x_sq, None, q, k, round_query=True)
        vp, rp = topk_t.approx_topk_plain(x, x_sq, None, q, k,
                                          round_query=True)
        assert _pool_overlap(rt, rp) >= 0.99
    else:
        vt, rt = topk_t.l2_topk(x, x_sq, None, q, k, round_query=True)
        vp, rp = topk_t.l2_topk_plain(x, x_sq, None, q, k, round_query=True)
        _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)
    vt, rt = vt.cpu().numpy(), rt.cpu().numpy()
    same = vt[:, 1:] == vt[:, :-1]
    assert same.any()  # the copies did meet
    assert (rt[:, 1:][same] > rt[:, :-1][same]).all()


@pytest.mark.cuda
def test_bf16_tile_route_counts_and_stage1_stays_on_the_fma_pass():
    """The tensor-core routes are what the counters say ran: K1 (both k
    ranges, each metric) and K9 on bf16 rows with the query rounded count
    under l2_topk_bf16_rq* and approx_topk, K1 on f32 rows and on bf16 rows
    with an f32 query (the split routes) under l2_topk and l2_topk_bf16,
    K9 on f32 rows (three TF32 products) under approx_topk_tf32, K9 on
    bf16 rows with an f32 query (the FMA pass) under approx_topk_bf16; K14's stage 1 at r = 192 runs
    the tensor-core pass (its FILTER mode: "stage1_select", no K1 launch,
    no overflow, no FMA pass) and still equals its plain version. (The
    name is the one this test had while stage 1 stayed on the FMA pass.)"""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    x, x_sq, q, mask = _serving_mirror(35, 20_000, 384, 4, "rows", dev)
    native.reset_launches()
    for metric in ("euclidean", "cosine", "dot"):
        for k in (16, 300):
            topk_t.l2_topk(x, x_sq, mask, q, k, round_query=True,
                           metric=metric)
    topk_t.approx_topk(x, x_sq, mask, q, 64, round_query=True)
    topk_t.approx_topk(x.float(), x_sq, mask, q, 64)
    topk_t.approx_topk(x, x_sq, mask, q, 64)
    topk_t.l2_topk(x, x_sq, mask, q, 16)
    topk_t.l2_topk(x.float(), x_sq, mask, q, 16)
    want = {"l2_topk_bf16_rq": 2, "l2_topk_bf16_rq_cosine": 2,
            "l2_topk_bf16_rq_dot": 2, "approx_topk": 1,
            "approx_topk_tf32": 1, "approx_topk_bf16": 1, "l2_topk_bf16": 1,
            "l2_topk": 1}
    assert {key: v for key, v in native.launches.items()
            if v and key.startswith(("l2_topk", "approx_topk"))} == want
    g = torch.Generator(device=dev).manual_seed(36)
    xp = torch.randn(50_001, 192, device=dev, generator=g).to(torch.bfloat16)
    xp_sq = (xp.float() ** 2).sum(1)
    qp = torch.randn(32, 192, device=dev, generator=g)
    native.reset_launches()
    vt, rt = fused_t.stage1_select(xp, xp_sq, None, qp, 512)
    assert native.launches["stage1_select"] == 1
    assert native.launches["stage1_select_fma"] == 0
    assert native.launches["stage1_select_overflow"] == 0
    assert not any(v for key, v in native.launches.items()
                   if key.startswith(("l2_topk", "approx_topk")))
    vp, rp = fused_t.stage1_select_plain(xp, xp_sq, None, qp, 512)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)


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
    m = st.device("bfloat16" if bf16 else "float32")
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
@pytest.mark.parametrize("b,n,chunk,k,mask_kind,data", [
    (16, 20_000, 4096, 10, None, "dot"),
    (16, 20_000, 1000, 300, "rows", "dot"),
    (16, 20_000, 4000, 257, "queries", "signed"),
    (8, 40_000, 10_000, 1024, "rows", "falling"),
    (1, 30_000, 5000, 2049, None, "dot"),
    (300, 8192, 2048, 4096, "queries", "signed"),
    (4, 32_768, 8192, 4096, None, "falling"),
    (3, 24_000, 12_000, 5000, "rows", "falling")])
def test_chunked_topk_matches_plain_on_card(b, n, chunk, k, mask_kind, data):
    """chunked_topk over distances made on the card, against the plain
    steps over the same distances: the same rows and values exactly. Dot
    distances (negative), signed ones with ties, NaNs and +-inf, and
    falling ones (every chunk beats the whole running list, so past the
    first chunk more than 4,096 entries survive the bar and take the radix
    select); [C], [B, C] and no mask; the fused step (k = 10) and the
    filtered select (k = 257 .. 5,000, k > C, B = 1 and 300, a short last
    chunk)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(23 + k)
    if data == "dot":
        x = torch.randn(n, 384, device=dev, generator=g)
        q = torch.randn(b, 384, device=dev, generator=g)
        dist = -(q @ x.T)
    elif data == "signed":
        dist = _signed_matrix(g, dev, b, n)
    else:
        dist = -torch.arange(n, device=dev, dtype=torch.float32)[None] \
            .repeat(b, 1) + torch.rand(b, n, device=dev, generator=g)
    keep = {"rows": lambda: torch.rand(n, device=dev, generator=g) < 0.7,
            "queries": lambda: torch.rand(b, n, device=dev,
                                          generator=g) < 0.5,
            None: lambda: None}[mask_kind]()

    def dist_fn(start, on=dev):
        d = dist[:, start: start + chunk].to(on).contiguous()
        if keep is None:
            return d, None
        return d, keep[..., start: start + chunk].to(on).contiguous()

    vt, rt = topk_t.chunked_topk(dist_fn, n, chunk, k, b, device=dev)()
    vp, rp = topk_t.chunked_topk(lambda s: dist_fn(s, "cpu"), n, chunk, k,
                                 b, device="cpu")()
    np.testing.assert_array_equal(rt.cpu().numpy(), rp.numpy())
    assert torch.equal(vt.cpu(), vp)
    if keep is not None:
        ok = rt[rt >= 0].long()
        assert (keep[ok] if keep.dim() == 1 else keep.gather(
            1, rt.clamp(min=0).long())[rt >= 0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k,mask_kind", [(10, "rows"), (256, "queries"),
                                         (256, None), (257, "rows"),
                                         (1024, "queries"), (2049, None)])
def test_chunk_step_pruning_bar_on_card(k, mask_kind):
    """A chunk step after a first one: entries that tie the running k-th
    distance exactly (at higher rows, so the running entries keep their
    places), entries just below it, slices whose every entry is masked out
    (the whole second half of the chunk, and for a [B, C] mask one query's
    whole chunk), negative distances; the fused step at kc 10 and 256, the
    filtered select at 257, 1,024 and 2,049 (its bar the running k-th). The
    plain version's rows and values exactly."""
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
    """The plain pick's k-means++ fallback flag changes nothing where a row
    is eligible: the kmeans|| pick on the card (l = 1 and 409, a third of
    d2 at 0) equals the plain pick with and without it. Where no row is
    eligible the card's pick is -1, and the flag draws as the unweighted
    pick over the mask."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(31)
    n = 10_000
    mask = torch.rand(n, device=dev, generator=g) < 0.9
    d2 = torch.rand(n, device=dev, generator=g)
    d2[::3] = 0.0
    for l in (1, 409):
        u = torch.rand(n, device=dev, generator=g)
        a = km_t.seed_pick(d2, mask, u, l)
        assert torch.equal(a, km_t.seed_pick_plain(d2, mask, u, l))
        assert torch.equal(a, km_t.seed_pick_plain(d2, mask, u, l, True,
                                                   unweighted_if_empty=True))
    zero = torch.zeros(n, device=dev)
    u = torch.rand(n, device=dev, generator=g)
    assert int(km_t.seed_pick(zero, mask, u, 1)[0]) == -1
    got = km_t.seed_pick_plain(zero, mask, u, 1, True,
                               unweighted_if_empty=True)
    assert torch.equal(got, km_t.seed_pick(None, mask, u, 1, weighted=False))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c", [(4_097, 48, 256), (1_000, 8, 16),
                                   (2_000, 384, 64)])
def test_kmeans_pp_and_train_match_plain_on_card(n, d, c):
    """k-means++ on K7's kernel picks the plain version's rows from the
    same generator state (a key tie between two rows is the only way
    apart), never a row outside the mask; Lloyd from it converges within
    1% of the plain run's error, at the plain run's iteration, its
    centroids within 1e-5 of max|x| of the plain run's. Held step by step
    on its own steps too: each within that tolerance of the plain step
    from the same centroids, and where the two runs assign a row apart,
    a float64 tie within the tensor cores' error (two roundings send such
    a row either way, and the runs part there)."""
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
    g = torch.Generator(device=dev)
    g.set_state(state)
    seed = km_t.pp_seed(g)
    for _, _, gap in pp_key_gaps(seed, x, mask, picks[False][None],
                                      picks[True][None]):
        assert gap <= 1e-6
    rows = picks[False].cpu().numpy()
    assert ((rows >= 0) & (rows < n - 13)).all()
    assert len(set(rows.tolist())) == c
    init = x[picks[False].long()]
    logs = [], []
    kern = km_t._lloyd_until(x, mask, init, 25, 1e-4,
                             recording(km_t.lloyd_block, logs[0]))
    plain = km_t._lloyd_until(x, mask, init, 25, 1e-4,
                              recording(km_t.lloyd_block_plain, logs[1]))
    assert kern.iterations == plain.iterations
    assert kern.converged == plain.converged
    assert abs(kern.final_error - plain.final_error) <= \
        0.01 * plain.final_error
    assert kern.centroids.shape == (c, d)
    tol = 1e-5 * float(x[:-13].abs().max())
    res = lloyd_check(x, mask, init, *logs, kern.iterations)
    assert res["step_err"] <= tol, res
    assert res["off_gap"] <= TIE and res["parting_gap"] <= TIE, res
    assert res["apart"] <= tol, res
    if res["parted_at"] is None:
        cerr = float((kern.centroids - plain.centroids).abs().max())
        assert cerr <= tol, (cerr, res)


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
@pytest.mark.parametrize("s,ks", [(3, 10), (4, 10), (1, 64), (4, 512),
                                  (4, 2048), (8, 2048), (5, 4000)])
def test_shard_merge_routes_match_plain_on_card(s, ks):
    """Each route of K15's merge by candidate count (a warp's registers to
    64, a block's registers to 8,192 and, 16 keys a thread, to 16,384, the
    buffer and radix select past it), with a row map that drops some rows, -1 rows and
    NaN / -inf distances in mid-list, bases and ties across shards:
    exactly the plain version's (distance, row) list."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(s * 7_919 + ks)
    b = 37
    vals, rows = _shard_lists(g, dev, s, b, ks)
    hole = torch.rand(s, b, ks, device=dev, generator=g)
    rows[hole < 0.05] = -1
    vals[(hole > 0.5) & (hole < 0.52)] = float("nan")
    vals[(hole > 0.6) & (hole < 0.61)] = float("-inf")
    vals[:, :, 1] = vals[:, :, 0]  # ties inside and across shards
    per = int(rows.max()) + 1
    base = torch.arange(s, dtype=torch.int32, device=dev) * per
    row_map = torch.randperm(s * per, device=dev, generator=g).to(
        torch.int32)
    row_map[torch.rand(s * per, device=dev, generator=g) < 0.03] = -1
    for rm in (None, row_map):
        for k in sorted({1, 10, min(s * ks, 2048), s * ks + 5}):
            vk, rk = topk_t.shard_merge(vals, rows, k, base=base,
                                        row_map=rm)
            vp, rp = topk_t.shard_merge_plain(vals, rows, k, base=base,
                                              row_map=rm)
            assert torch.equal(rk, rp) and torch.equal(vk, vp), (k, rm)
    assert (rk[:, -5:] == -1).all() and torch.isinf(vk[:, -5:]).all()


def _ivf_case(seed, dev, n=16_000, d=64, c=24, c_lo=0, c_local=None,
              long_len=3000):
    """Lists made by hand: uneven lengths, one list (3) of ``long_len``
    entries (3,000: 12 chunks of 256), two empty lists, entries past the
    mirror (>= N), the rows of lists c_lo .. c_lo + c_local - 1 in the
    tiles."""
    from fabstir_vectordb_tpu_torch.index.ivf import IVFLists

    rng = np.random.default_rng(seed)
    c_local = c if c_local is None else c_local
    lens = rng.integers(50, 700, c)
    lens[3], lens[5], lens[7] = long_len, 0, 0
    rows = rng.permutation(n)
    tiles = np.full((c, max(4096, long_len)), -1, np.int32)
    at = 0
    for i in range(c):
        take = rows[at: at + lens[i]] if at + lens[i] <= n else \
            rng.integers(0, n, lens[i])
        tiles[i, : lens[i]] = np.sort(take)
        at += lens[i]
    tiles[2, 0] = n + 5  # a row past the mirror never enters
    if long_len > 3000:  # lane 31 of every chunk of list 3 past the mirror
        tiles[3, 31:long_len:32] = n + 7
    x = torch.from_numpy(_data(seed, n, d) * 2).to(dev)
    lists = IVFLists.upload(np.zeros((c_local, d), np.float32),
                            tiles[c_lo: c_lo + c_local], dev)
    mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    mask2 = torch.from_numpy(np.arange(n) % 5 != 3).to(dev)
    return x, lists, mask, mask2, rng


def _work_list(grp, n_per, b, p, c, k_seed):
    """The grouped route's work list as csrc/ivf_scan.cu's GroupScratch
    holds it after a call (laid out by carve_group), in ivf_groups_plain's
    terms, pairs by list in arrival order, with each query's |q|^2
    (``q_sq``) and survivor count (``surv``); n_per counts the seed."""
    g = grp.long()
    o = c + 2 * (c + 1)
    lstart, tstart = g[c: c + c + 1], g[c + c + 1: o]
    npairs = int(lstart[-1])
    at = o + 4 * b * p  # past prank, poff, pair_b, pair_off
    return {"slot": g[o + b * p: o + 2 * b * p].reshape(b, p),
            "n_lists": n_per.long() - k_seed, "lstart": lstart, "tstart": tstart,
            "pair_b": g[o + 2 * b * p: o + 2 * b * p + npairs],
            "pair_slot": g[o + 3 * b * p: o + 3 * b * p + npairs],
            "q_sq": grp[at: at + b].view(torch.float32),
            "n_tasks": int(grp[at + b]), "surv": g[at + b + 2: at + 2 * b + 2]}


@pytest.mark.cuda
@pytest.mark.parametrize("b,metric,bf16,seeded,shard,probes", [
    (1, "euclidean", False, True, False, "mixed"),
    (37, "cosine", True, False, False, "mixed"),
    (37, "dot", True, True, False, "mixed"),
    (128, "dot", False, True, True, "mixed"),
    (128, "euclidean", True, False, False, "one list"),
    (128, "cosine", False, True, False, "mixed"),
    (1024, "euclidean", False, True, False, "mixed"),
    (16, "euclidean", False, True, False, "overflow")])
def test_ivf_scan_routes_match_plain_on_card(b, metric, bf16, seeded, shard,
                                             probes):
    """K12's grouped and per-query routes against ivf_scan_plain: f32 and
    bf16 rows by metric, with and without a seed, both masks, a list range
    (probes of lists outside it scan nothing), every query probing the one
    long list, empty lists and entries past the mirror. The grouped
    route's work list equals ivf_groups_plain's. "overflow": half the batch
    probes only a list of 15,000 entries whose every chunk leaves lane 31
    empty, so no task sets those queries' bar (k = 32 needs 32 lane minima)
    and more than 8,192 of their candidates survive the filter (the radix
    passes take them); the other half, on short lists, finish in the block
    sort."""
    from fabstir_vectordb_tpu_torch.index import ivf as ivf_mod

    dev = _card()
    c_lo, c_local = (8, 12) if shard else (0, 24)
    overflow = probes == "overflow"
    x, lists, mask, mask2, rng = _ivf_case(
        50 + b, dev, n=32_000 if overflow else 16_000, c_lo=c_lo,
        c_local=c_local, long_len=15_000 if overflow else 3000)
    xs = x.to(torch.bfloat16) if bf16 else x
    x_sq = (x * x).sum(1)
    if probes == "one list":
        probe = np.full((b, 1), 3, np.int32)
    elif overflow:
        others = np.array([i for i in range(24) if i != 3])
        probe = np.stack([rng.permutation(others)[:6] for _ in range(b)])
        probe[::2] = [3, -1, -1, -1, -1, -1]
    else:
        probe = np.stack([rng.permutation(24)[:6] for _ in range(b)])
        probe[0, :] = [3, 5, 7, 2, 9, -1]  # long, empty, empty, past-N
    probe = torch.from_numpy(probe.astype(np.int32)).to(dev)
    q = torch.from_numpy(_data(b, b, x.shape[1]) * 2).to(dev)
    seed = None
    if seeded:  # rows outside the lists' values, as the beam's are
        sd = torch.sort(torch.rand(b, 20, device=dev) * 50 - 10, 1)[0]
        sr = torch.randint(0, x.shape[0], (b, 20), device=dev,
                           dtype=torch.int32)
        seed = (sd.contiguous(), sr.contiguous())
    k = 32 if overflow else 16 if b > 1 else 300
    vp, rp = ivf_mod.ivf_scan_plain(xs, x_sq, mask, lists, probe, q, k,
                                    extra_mask=mask2, seed=seed,
                                    metric=metric, c_lo=c_lo)
    atol = 1e-5 if metric == "cosine" else 1e-3
    for grouped in (False, True):
        vk, rk, grp, n_per = ivf_mod._scan(xs, x_sq, mask, lists, probe, q,
                                           k, mask2, seed, metric, c_lo,
                                           grouped)
        _assert_close_up_to_ties(vk, rk, vp, rp, 1e-5, atol)
    w = _work_list(grp, n_per, b, probe.shape[1], c_local,
                   min(k, 20) if seeded else 0)
    if overflow:  # the radix passes took the even queries, and only them
        assert (w["surv"][::2] > 8192).all(), w["surv"]
        assert (w["surv"][1::2] <= 8192).all(), w["surv"]
    wp = ivf_mod.ivf_groups_plain(probe, lists.list_len, c_lo)
    for key in ("slot", "n_lists", "lstart", "tstart"):
        assert torch.equal(w[key].cpu(), wp[key].cpu()), key
    assert w["n_tasks"] == wp["n_tasks"]
    torch.testing.assert_close(w["q_sq"], (q * q).sum(1), rtol=1e-5,
                               atol=1e-5)
    ls = wp["lstart"].tolist()
    for li in range(c_local):  # a list's pairs, in any arrival order
        got = sorted(zip(w["pair_b"][ls[li]: ls[li + 1]].tolist(),
                         w["pair_slot"][ls[li]: ls[li + 1]].tolist()))
        want = sorted(zip(wp["pair_b"][ls[li]: ls[li + 1]].tolist(),
                          wp["pair_slot"][ls[li]: ls[li + 1]].tolist()))
        assert got == want, li


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
    (128, 1_048_576, 1_024, "per_query"), (37, 4096, 64, "per_query"),
    (5, 300, 700, "none"), (3, 1000, 256, "sparse"), (5, 4096, 5000, "none"),
    (9, 4097, 64, "rows"), (9, 4097, 300, "per_query"),
    (4, 5000, 6000, "rows"), (70_000, 64, 8, "rows")])
def test_masked_topk_matches_plain_on_card(b, n, k, mask_kind):
    """B3: each route of the entry point against the plain sort, exactly
    (the same (distance, row) list): rows of at most 4,096 sorted whole
    (k > N, N = 4,096, B past one launch's 65,535), the fused kernel at k
    <= 256 and the filtered select past it (N = 4,097; k > N past 4,096
    survivors), [N] and [B, N] masks; NaN / +-inf entries never
    selected."""
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
        fresh = loaded.store.device(dtype)
        assert torch.equal(staged_x, fresh.x)
        assert torch.equal(staged_sq, fresh.x_sq)
        # the search on the staged mirror answers as on a fresh upload
        dw, want = loaded.search_rows(q, 10, config=cfg, now=1.0e9)
        assert np.array_equal(rows, want) and np.array_equal(d, dw)


def _stage1_mirror(seed, n, r, b, keep, dev, dup=0):
    """A projected bf16 mirror on the card with its norms, projected
    queries and a row mask keeping ``keep`` of the rows (None: no mask);
    with ``dup`` the last dup rows repeat the first ones (ties)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xf = torch.randn(n, r, device=dev, generator=g)
    if dup:
        xf[n - dup:] = xf[:dup]
    xp = xf.to(torch.bfloat16)
    xp_sq = (xp.float() ** 2).sum(1)
    qp = torch.randn(b, r, device=dev, generator=g)
    mask = None if keep is None else \
        torch.rand(n, device=dev, generator=g) < keep
    return xp, xp_sq, qp, mask


@pytest.mark.cuda
@pytest.mark.parametrize("r,b,ov_k,keep", [
    (192, 1, 1, None), (192, 32, 256, 0.9), (192, 128, 1024, 0.9),
    (192, 5, 2048, None), (64, 64, 1024, 0.001), (64, 3, 2048, 0.9),
    (192, 9, 256, 0.001), (36, 16, 1024, 0.9)])
def test_stage1_filter_route_matches_plain_on_card(r, b, ov_k, keep):
    """K14's stage 1 by route at 1,000,003 rows: r = 192 and 64 on the
    tensor cores (a sample's bar, the survivors, no [B, N] buffer; counted
    as "stage1_select"), r = 36 on the FMA pass ("stage1_select_fma");
    masks of none, 90% and 0.1% of the rows (ov_k past the unmasked rows:
    no bar, the tail pads); no launch overflows."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    xp, xp_sq, qp, mask = _stage1_mirror(50, 1_000_003, r, b, keep, dev)
    native.reset_launches()
    vt, rt = fused_t.stage1_select(xp, xp_sq, mask, qp, ov_k)
    tc = r % 8 == 0
    assert native.launches["stage1_select"] == int(tc)
    assert native.launches["stage1_select_fma"] == int(not tc)
    assert native.launches["stage1_select_overflow"] == 0
    vp, rp = fused_t.stage1_select_plain(xp, xp_sq, mask, qp, ov_k)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)


@pytest.mark.cuda
def test_stage1_filter_overflow_takes_the_dump_route_on_card():
    """A survivor buffer of 300 keys a query (the wrapper's ``capacity``)
    under a bar that passes ~8 ov_k rows: the launch overflows, runs again
    on the FMA route (counted as "stage1_select_overflow") and still
    equals the plain version."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    xp, xp_sq, qp, mask = _stage1_mirror(51, 200_003, 192, 7, 0.9, dev)
    native.reset_launches()
    vt, rt = fused_t.stage1_select(xp, xp_sq, mask, qp, 256, capacity=300)
    assert native.launches["stage1_select"] == 1
    assert native.launches["stage1_select_overflow"] == 1
    vp, rp = fused_t.stage1_select_plain(xp, xp_sq, mask, qp, 256)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)


@pytest.mark.cuda
def test_stage1_overflow_counts_each_launch_of_the_dump_route_on_card():
    """A launch of the filter route over 7 queries overflows (``capacity``
    300) under a transient that holds the route's scratch for all 7 but
    [2, N] f32 buffers only: the rerun takes four launches of the FMA route
    and "stage1_select_overflow" counts each of them; the answer equals
    the plain version."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    n, r, b, ov_k = 1_000_003, 64, 7, 256
    xp, xp_sq, qp, mask = _stage1_mirror(53, n, r, b, 0.9, dev)
    budget = 5 * 4 * n // 2
    assert budget // fused_t.stage1_query_bytes(n, r, ov_k, "cuda") >= b
    assert budget // (4 * n) == 2
    native.reset_launches()
    vt, rt = fused_t.stage1_select(xp, xp_sq, mask, qp, ov_k, budget,
                                   capacity=300)
    assert native.launches["stage1_select"] == 1
    assert native.launches["stage1_select_overflow"] == 4
    assert native.launches["stage1_select_fma"] == 0
    vp, rp = fused_t.stage1_select_plain(xp, xp_sq, mask, qp, ov_k)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("ov_k", [16, 1024])
def test_stage1_filter_keeps_rows_tied_at_the_bar_on_card(ov_k):
    """Half the rows repeat earlier ones, and the queries sit near
    repeated rows: the copies tie at the bar and inside the pool; the
    route keeps all of them and orders them by row, as the plain version
    does."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    n = 400_000
    xp, xp_sq, _, _ = _stage1_mirror(52, n, 192, 8, None, dev, dup=n // 2)
    qp = xp[:8].float() + 0.01
    native.reset_launches()
    vt, rt = fused_t.stage1_select(xp, xp_sq, None, qp, ov_k)
    assert native.launches["stage1_select_overflow"] == 0
    vp, rp = fused_t.stage1_select_plain(xp, xp_sq, None, qp, ov_k)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)
    vt, rt = vt.cpu().numpy(), rt.cpu().numpy()
    same = vt[:, 1:] == vt[:, :-1]
    assert same.any() and (rt[:, 1:][same] > rt[:, :-1][same]).all()


def _f32_rows(seed, n, d, b, mask_kind, dev, near=False):
    """f32 rows shifted off the origin (cosine and dot rank), queries
    (``near``: each a stored row plus 1e-3 noise, beside a second copy of
    that row moved by 1e-4: near-duplicates), and a mask of rows ("rows",
    90%), of (query, row) pairs ("per_query", 50%) or none."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=g) + 0.3
    q = torch.randn(b, d, device=dev, generator=g) + 0.3
    if near:
        pick = torch.randint(0, n // 2, (b,), device=dev, generator=g)
        x[n // 2: n // 2 + b] = x[pick] + 1e-4
        q = x[pick] + 1e-3 * torch.randn(b, d, device=dev, generator=g)
    mask = None
    if mask_kind == "rows":
        mask = torch.rand(n, device=dev, generator=g) < 0.9
    elif mask_kind == "per_query":
        mask = torch.rand(b, n, device=dev, generator=g) < 0.5
    return x, (x * x).sum(1), q, mask


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,d,mask_kind,metric", [
    (1, 1, 384, "rows", "euclidean"), (128, 16, 384, "rows", "euclidean"),
    (1024, 200, 384, "rows", "euclidean"), (37, 256, 384, "per_query",
                                            "euclidean"),
    (128, 1024, 384, "rows", "euclidean"), (1, 16, 32, "none", "euclidean"),
    (128, 200, 32, "per_query", "cosine"), (128, 16, 384, "rows", "cosine"),
    (129, 16, 384, "per_query", "dot"), (9, 1024, 384, "none", "dot"),
    (128, 16, 36, "rows", "euclidean"), (5, 16, 100, "rows", "euclidean"),
    (64, 16, 37, "rows", "euclidean")])
def test_f32_tile_route_matches_plain_on_card(b, k, d, mask_kind, metric):
    """K1 on f32 rows on its route: D % 4 == 0 on the tensor cores by three
    TF32 products ("l2_topk*", lists to k = 256, the buffer past it), odd
    D on the FMA pass ("l2_topk*_fma"), with [N] and [B, N] masks, by
    metric, at B 1 to 1,024, against the plain version's f32 products
    (sums in another order, ~2^-22 of each product dropped)."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    x, x_sq, q, mask = _f32_rows(53, 65_536, d, b, mask_kind, dev)
    native.reset_launches()
    vt, rt = topk_t.l2_topk(x, x_sq, mask, q, k, metric=metric)
    route = topk_t.tile_route(torch.float32, False, d)
    base = "l2_topk_large" if k > 256 else "l2_topk"
    name = native.counter(base, False, metric, fma=route == "fma")
    assert native.launches[name] == 1
    vp, rp = topk_t.l2_topk_plain(x, x_sq, mask, q, k, metric=metric)
    scale = float(x_sq.max() + (q * q).sum(1).max())
    tol = 2e-6 * scale if metric == "euclidean" else 1e-5
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, tol)


@pytest.mark.cuda
def test_f32_filter_route_overflow_runs_again_on_the_lists_on_card():
    """Every row the same: every distance ties at the bar, the survivors
    pass their buffer, and the chunk runs again on the lists
    ("l2_topk_overflow" 1, "l2_topk" 2: the filter launch and the lists'),
    with the norms the first launch wrote to its scratch; the answer
    equals the plain version's."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(56)
    x = torch.randn(1, 384, device=dev, generator=g).expand(65_536, 384)
    x = x.contiguous()
    q = torch.randn(8, 384, device=dev, generator=g)
    native.reset_launches()
    vt, rt = topk_t.l2_topk(x, None, None, q, 200)
    assert native.launches["l2_topk_overflow"] == 1
    assert native.launches["l2_topk"] == 2
    vp, rp = topk_t.l2_topk_plain(x, None, None, q, 200)
    scale = float((x[0] ** 2).sum() + (q * q).sum(1).max())
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 2e-6 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 300])
def test_f32_tile_route_near_duplicates_on_card(k):
    """Queries a hair from a stored row that has a near-duplicate 1e-4
    away: the split products keep f32 accuracy, so the row and its copy
    come out first, in the plain version's order and within its
    distances' f32 error."""
    dev = _card()
    x, x_sq, q, _ = _f32_rows(54, 100_000, 384, 64, "none", dev, near=True)
    vt, rt = topk_t.l2_topk(x, x_sq, None, q, k)
    vp, rp = topk_t.l2_topk_plain(x, x_sq, None, q, k)
    scale = float(x_sq.max() + (q * q).sum(1).max())
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 2e-6 * scale)
    assert torch.equal(torch.sort(rt[:, :2], 1).values,
                       torch.sort(rp[:, :2], 1).values)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(1024, 200), (128, 11), (4, 1024)])
def test_bf16_rows_f32_query_route_matches_plain_on_card(b, k):
    """K1 on bf16 rows with an f32 query (K3 on a bf16 mirror, the
    calibration oracle's blocks): the query split in three bf16 parts,
    three exact products ("l2_topk_bf16"), against the plain version's
    upcast rows and f32 query."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    x, _, q, mask = _f32_rows(55, 65_536, 384, b, "rows", dev)
    xb = x.to(torch.bfloat16)
    native.reset_launches()
    vt, rt = topk_t.l2_topk(xb, None, mask, q, k)
    assert native.launches["l2_topk_bf16"] == 1
    vp, rp = topk_t.l2_topk_plain(xb, None, mask, q, k)
    scale = float((xb.float() ** 2).sum(1).max() + (q * q).sum(1).max())
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 2e-6 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c,d", [(128, 384), (100, 384), (64, 384),
                                 (37, 384), (32, 384), (17, 384), (128, 98),
                                 (37, 100)])
def test_heuristic_kept_routes_match_plain_on_card(c, d, bf16):
    """K4 by route against its plain version over 301 queries (no multiple
    of a block's queries), each query's last 5 candidates (-1, +inf)
    padding: rows that cp.async copies 16 bytes at a time (f32 at D % 4 ==
    0, bf16 at D % 8 == 0) on the tensor cores (wgmma, the rows padded to
    128 past 64 candidates, else to 64: C = 128 and 100, then 64, 37, 32
    and 17), counted as heuristic_kept / heuristic_kept_bf16; D = 98 and
    100 on the FMA route (heuristic_kept_fma / heuristic_kept_bf16_fma).
    Flags equal but where a query's first flip sits at a near-tie of the
    plain scan."""
    from fabstir_vectordb_tpu_torch.index import hnsw as hn
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    x, ids, dd = _candidate_pools(57, 301, c, n=20_000, pad_from=c - 5, d=d)
    xt = torch.from_numpy(x).to(dev)
    if bf16:
        xt = xt.to(torch.bfloat16)
    idt, dt = torch.from_numpy(ids).to(dev), torch.from_numpy(dd).to(dev)
    route = hn.heuristic_route(xt)
    assert route == ("fma" if d % (8 if bf16 else 4) else
                     "bf16" if bf16 else "tf32x3")
    native.reset_launches()
    kt = hnsw_t.heuristic_kept(xt, idt, dt, 32)
    name = native.counter("heuristic_kept", bf16, fma=route == "fma")
    assert {k: v for k, v in native.launches.items() if v} == {name: 1}
    kp = hnsw_t.heuristic_kept_plain(xt, idt, dt, 32)
    kt, kp = kt.cpu().numpy(), kp.cpu().numpy()
    assert not kt[:, c - 5:].any()
    assert (kt.sum(1) <= 32).all() and kt.any()
    _assert_kept_equal_up_to_near_ties(kp, kt, ids, dd,
                                       xt.float().cpu().numpy())


# both roundings of wgmma.cuh's TF32 routes over a table of f32 bit patterns
_TF32_ROUNDINGS = r"""
#include "wgmma.cuh"
__global__ void both(const uint32_t* in, uint32_t* by_int, uint32_t* by_cvt,
                     int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __uint_as_float(in[i]);
  by_int[i] = fvdb::tf32_rna(x);
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  by_cvt[i] = r & 0xffffe000u;
}
extern "C" int tf32_both(const uint32_t* in, uint32_t* by_int,
                         uint32_t* by_cvt, int n) {
  both<<<(n + 255) / 256, 256>>>(in, by_int, by_cvt, n);
  return (int)cudaDeviceSynchronize();
}
"""


def _f32_bit_patterns() -> np.ndarray:
    """f32 bit patterns of both signs: every low 13 bits (the ties at
    0x1000 among them) under TF32 mantissas 0, 1, 0x155, 0x2aa, 0x3fe and
    0x3ff at exponents 0 (denormals), 1, 2, 100, 127, 200, 253 and 254;
    every pattern from 0x7f7f0000 to the largest finite 0x7f7fffff (the
    ones from 0x7f7ff000 round past it); infinities; 2^22 seeded ones."""
    low = np.arange(1 << 13, dtype=np.uint32)
    grid = [(e << 23) | (h << 13) | low
            for e in (0, 1, 2, 100, 127, 200, 253, 254)
            for h in (0, 1, 0x155, 0x2AA, 0x3FE, 0x3FF)]
    top = np.arange(0x7F7F0000, 0x7F800000 + 1, dtype=np.uint32)
    rng = np.random.default_rng(60)
    seeded = rng.integers(0, 1 << 32, 1 << 22, dtype=np.uint32)
    pos = np.concatenate([*grid, top, seeded])
    return np.concatenate([pos, pos ^ np.uint32(0x80000000)])


@pytest.mark.cuda
def test_tf32_rounding_by_integer_operations_matches_cvt_on_card(tmp_path):
    """wgmma.cuh's tf32_rna (half a TF32 ulp added to the bits, the low 13
    cleared), which every TF32 route splits its f32 values by, against
    cvt.rna.tf32.f32 (to nearest, ties away from zero): the same bits for
    every finite input and for the infinities; at the largest finites both
    round to an infinity. A NaN whose payload lies only in the low 13
    bits becomes an infinity there (its small part x - big stays a NaN)."""
    import ctypes
    import subprocess

    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    src = tmp_path / "tf32_roundings.cu"
    src.write_text(_TF32_ROUNDINGS)
    lib = tmp_path / "tf32_roundings.so"
    subprocess.run([native.nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC),
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    run = ctypes.CDLL(str(lib)).tf32_both
    bits = _f32_bit_patterns()
    x = torch.from_numpy(bits.view(np.int32)).to(dev)
    by_int, by_cvt = torch.empty_like(x), torch.empty_like(x)
    assert run(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(by_int.data_ptr()),
               ctypes.c_void_p(by_cvt.data_ptr()), ctypes.c_int(x.numel())) == 0
    a = by_int.cpu().numpy().view(np.uint32)
    c = by_cvt.cpu().numpy().view(np.uint32)
    vals = bits.view(np.float32)
    finite = np.isfinite(vals)
    assert finite.sum() > 8_000_000
    differ = np.nonzero(finite & (a != c))[0]
    assert differ.size == 0, [hex(v) for v in bits[differ[:8]]]
    inf = np.isinf(vals)
    np.testing.assert_array_equal(a[inf], bits[inf])
    np.testing.assert_array_equal(c[inf], bits[inf])
    big = (bits & 0x7FFFFFFF) >= 0x7F7FF000
    assert np.isinf(a[big & finite].view(np.float32)).all()


@pytest.mark.cuda
def test_heuristic_kept_tensor_cores_on_rows_off_16_bytes_take_fma_on_card():
    """Rows 4 bytes off a 16-byte boundary cannot be copied 16 bytes at a
    time: K4 takes the FMA route and answers as on aligned rows."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    x, ids, dd = _candidate_pools(58, 64, 128, n=5000, d=384)
    xt = torch.from_numpy(x).to(dev)
    xu = torch.empty(xt.numel() + 1, device=dev)[1:].view(xt.shape)
    xu.copy_(xt)
    idt, dt = torch.from_numpy(ids).to(dev), torch.from_numpy(dd).to(dev)
    native.reset_launches()
    ku = hnsw_t.heuristic_kept(xu, idt, dt, 16).cpu().numpy()
    ka = hnsw_t.heuristic_kept(xt, idt, dt, 16).cpu().numpy()
    assert native.launches["heuristic_kept_fma"] == 1
    assert native.launches["heuristic_kept"] == 1
    _assert_kept_equal_up_to_near_ties(ku, ka, ids, dd, x)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,mask_kind,ov_k", [
    (1, 262_144, 384, "rows", 128), (8, 262_144, 384, "per_query", 128),
    (33, 100_000, 384, "rows", 64), (128, 262_144, 384, "per_query", 128),
    (128, 1_048_576, 384, "rows", 128), (33, 2000, 384, "rows", 128),
    (1, 4000, 384, "none", 256), (128, 100_000, 98, "rows", 128),
    (8, 50_001, 36, "per_query", 16)])
def test_approx_topk_f32_rows_by_shape_matches_plain_on_card(
        b, n, d, mask_kind, ov_k):
    """K9 on f32 rows by route: D % 4 == 0 on the tensor cores by three
    TF32 products (counted as approx_topk_tf32), D = 98 on the FMA pass
    (approx_topk_f32), at B 1 / 8 / 33 / 128 with [N] and [B, N] masks,
    M < N and M = N (N = 2,000 and 4,000 at these ov_k: the exact pool):
    pools share >= 0.99 of their rows with the plain version's, shared
    rows' distances within 1e-5 relative, no masked row, (+inf, -1)
    padding where the plain pool pads."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    x, x_sq, q, mask = _f32_rows(59, n, d, b, mask_kind, dev)
    native.reset_launches()
    vt, rt = topk_t.approx_topk(x, x_sq, mask, q, ov_k)
    tc = topk_t.tile_route(torch.float32, False, d) == "tf32x3"
    assert {k: v for k, v in native.launches.items() if v} == \
        {"approx_topk_tf32" if tc else "approx_topk_f32": 1}
    vp, rp = topk_t.approx_topk_plain(x, x_sq, mask, q, ov_k)
    assert _pool_overlap(rt, rp) >= 0.99
    _assert_shared_rows_close(vt, rt, vp, rp, 1e-5)
    fin = torch.isfinite(vt)
    assert torch.equal(fin, torch.isfinite(vp)) and (rt[~fin] == -1).all()
    rows = rt.clamp_min(0).long()
    if mask is None:
        pass
    elif mask.dim() == 1:
        assert mask[rows[fin]].all()
    else:
        assert torch.gather(mask, 1, rows)[fin].all()
    assert (vt[:, 1:] >= vt[:, :-1]).all()
    if topk_t.approx_bins(n, ov_k) >= n:  # the exact pool
        _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-2)


def _queries_on_card(m, b, seed):
    """b queries near the graph's rows (rows plus noise)."""
    rng = np.random.default_rng(seed)
    x = m.x.cpu().numpy()
    q = x[rng.integers(0, x.shape[0], b)] + 0.3 * rng.standard_normal(
        (b, x.shape[1]))
    return torch.from_numpy(q.astype(np.float32)).to(m.x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,expand,filtered,layer,ef,warps", [
    (1, 4, False, 0, 64, 8),        # serve, one query
    (128, 4, False, 0, 64, 8),      # serve, a batch
    (128, 4, True, 0, 64, 8),       # serve, filtered
    (1_024, 1, False, 0, 200, 2),   # the layer-0 link
    (1_024, 1, False, 1, 200, 1),   # an upper layer, inactive queries
    (2_048, 1, False, 0, 200, 1),
    (64, 4, True, 0, 2_048, 8),     # lists in global scratch
    (64, 1, False, 0, 2_048, 2)])
def test_beam_search_plans_match_plain_on_card(bf16, b, expand, filtered,
                                               layer, ef, warps):
    """K11 at each of its plans (warps a query, index/hnsw.py beam_plan)
    and at the scratch path, on both row types: overlap >= 0.99 with the
    plain version, the (eligible) starts of an inactive query exactly, no
    filtered-out row, no id twice, ascending, (+inf, -1) padded."""
    from fabstir_vectordb_tpu_torch.utils import native

    g, m, mask, a, _ = _graph_on_card()
    x, x_sq = _bf16_mirror(m) if bf16 else (m.x, m.x_sq)
    q = _queries_on_card(m, b, 9)
    dev = q.device
    width = (a["nbrs0"] if layer == 0 else a["nbrs_up"]).shape[1]
    assert hnsw_t.beam_plan(b, expand, width) == warps
    rng = np.random.default_rng(10)
    members = np.nonzero(g._search_mask() & (g.levels >= layer))[0]
    start = torch.from_numpy(rng.choice(members, (b, 1)).astype(np.int32)
                             ).to(dev)
    res = None
    if filtered:
        res = torch.from_numpy(np.arange(m.x.shape[0]) % 3 != 0).to(dev)
    active = torch.from_numpy(np.arange(b) % 5 != 3).to(dev)
    args = (x, x_sq, mask, a["nbrs0"], a["nbrs_up"], a["up_offset"], q,
            start, active, layer, ef, ef + 32, res, None, expand)
    name = native.counter("beam_search", bf16, up=layer > 0)
    before = native.launches[name]
    dk, ik = hnsw_t.beam_search(*args)
    assert native.launches[name] == before + 1
    dp, ip = hnsw_t.beam_search_plain(*args)
    assert torch.equal(ik[~active], ip[~active])
    assert _overlap(ik[active], ip[active]) >= 0.99
    both = (ik == ip) & (ik >= 0)
    torch.testing.assert_close(dk[both], dp[both], rtol=1e-5, atol=1e-3)
    dk_n, ik_n = dk.cpu().numpy(), ik.cpu().numpy()
    for dr, ir in zip(dk_n, ik_n):
        n = int((ir >= 0).sum())
        assert (ir[:n] >= 0).all() and (ir[n:] < 0).all()
        assert (np.diff(dr[:n]) >= 0).all() and np.isinf(dr[n:]).all()
        assert len(set(ir[:n].tolist())) == n
    if filtered:
        assert res.cpu().numpy()[ik_n[ik_n >= 0]].all()


def _reentry_graph():
    """Five nodes at squared distances 10, 5, 6, 3, 4 from a query at the
    origin: S (the start), A and E (the only eligible rows), B, C; S links
    A, E; A links B, C; B links back to A; C links B. With ef = 2 the pool
    takes [A, E], then [B, C] (A leaves it), and B's list offers A again:
    it is scored, dropped from the full pool, and merged into the results
    a second time, where it pushes E out."""
    d2 = np.array([10.0, 5.0, 6.0, 3.0, 4.0], np.float32)
    x = np.zeros((5, 4), np.float32)
    x[:, 0] = np.sqrt(d2)
    x_sq = (x * x).sum(1).astype(np.float32)
    nbrs0 = np.array([[1, 2], [3, 4], [-1, -1], [1, -1], [3, -1]], np.int32)
    nbrs_up = np.full((1, 2), -1, np.int32)
    up_offset = np.full(5, -1, np.int32)
    q = np.zeros((1, 4), np.float32)
    start = np.array([[0]], np.int32)
    mask = np.ones(5, bool)
    result_mask = np.array([False, True, True, False, False])
    return (x, x_sq, mask, nbrs0, nbrs_up, up_offset, q, start), result_mask


@pytest.mark.cuda
@pytest.mark.parametrize("expand", [1, 4])
def test_filtered_beam_reentry_matches_plain_on_card(expand):
    """An eligible id that leaves a full pool and comes back as a
    candidate is merged into the result list again, as the plain version
    (and the reference) merge it: the results equal the plain version's
    exactly (tests/test_torch_beam_lloyd.py holds the plain version to
    the JAX package's on this graph)."""
    dev = _card()
    args, res = _reentry_graph()
    t = [torch.from_numpy(a).to(dev) for a in args]
    t[6] = t[6].expand(5, -1).contiguous()  # five copies of the query
    t[7] = t[7].expand(5, -1).contiguous()
    active = torch.tensor([True, True, False, True, True], device=dev)
    rm = torch.from_numpy(res).to(dev)
    dk, ik = hnsw_t.beam_search(*t, active, 0, 2, 10, rm, None, expand)
    dp, ip = hnsw_t.beam_search_plain(*t, active, 0, 2, 10, rm, None, expand)
    assert torch.equal(ik, ip)
    assert ik[0].tolist() == [1, -1]
    torch.testing.assert_close(dk, dp)


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,route", [
    (3, 384, "fma"), (256, 384, "tf32x3"), (300, 384, "tf32x3"),
    (256, 8, "tf32x3"), (256, 48, "tf32x3"), (256, 130, "fma"),
    (300, 130, "fma")])
def test_assign_clusters_routes_match_plain_on_card(c, d, route):
    """K6's assignment by route (ops/kmeans.py lloyd_route), rows outside
    a mask, and two equal centroids: every row nearest to them goes to the
    first. Assignments equal the plain version's (>= 99.9%), distances
    within 1e-5 of the largest squared norm."""
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    xs, lab = _mixture(50, 20_000, c, d=d, spread=0.5)
    x = torch.from_numpy(xs).to(dev)
    first = [int(np.nonzero(lab == i)[0][0]) for i in range(c)]
    cents = x[first].clone()
    cents[c - 1] = cents[1]  # the first of the two wins
    mask = torch.rand(20_000, device=dev, generator=torch.Generator(
        device=dev).manual_seed(51)) < 0.9
    assert km_t.lloyd_route(20_000, c, d) == route
    name = "assign_clusters" + ("" if route == "tf32x3" else "_fma")
    before = native.launches[name]
    ak, dk = km_t.assign_clusters(x, cents, mask)
    assert native.launches[name] == before + 1
    ap, dp = km_t.assign_clusters_plain(x, cents, mask)
    assert (ak == ap).float().mean().item() >= 0.999
    assert bool((ak[~mask] == -1).all()) and bool((dk[~mask] == 0).all())
    assert not bool((ak == c - 1).any()) and bool((ak == 1).any())
    tol = 1e-5 * float((x * x).sum(1).max())
    same = ak == ap
    assert float((dk - dp)[same].abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("c,d", [(3, 384), (256, 384), (300, 384),
                                 (256, 8), (256, 48), (256, 130)])
def test_lloyd_routes_match_plain_on_card(c, d):
    """K6's Lloyd block, step and partial + finish on each route against
    the plain versions from one starting centroid a cluster: centroids
    within 1e-5 of the data scale (the atomics' order), errors within
    1e-5 relative, counts equal."""
    dev = _card()
    n = 30_000
    xs, lab = _mixture(52, n, c, d=d, spread=1.0)
    x = torch.from_numpy(xs).to(dev)
    mask = torch.rand(n, device=dev, generator=torch.Generator(
        device=dev).manual_seed(53)) < 0.9
    first = [int(np.nonzero(lab == i)[0][0]) for i in range(c)]
    init = x[first].clone()
    scale = float(x.abs().max())
    cb, eb = km_t.lloyd_block(x, mask, init, 3)
    cp, ep = km_t.lloyd_block_plain(x, mask, init, 3)
    assert float((cb - cp).abs().max()) <= 1e-5 * scale
    assert float(((eb - ep).abs() / ep).max()) <= 1e-5
    cs, es = km_t.lloyd_step(x, mask, init)
    assert float((cs - cp[0]).abs().max()) <= 1e-5 * scale
    assert abs(float(es) - float(ep[0])) <= 1e-5 * float(ep[0])
    sums, counts, stats = km_t.lloyd_partial(x, mask, init)
    sp, cnp, stp = km_t.lloyd_partial_plain(x, mask, init)
    assert torch.equal(counts, cnp) and float(stats[1]) == float(stp[1])
    assert float((sums - sp).abs().max()) <= 1e-5 * scale * float(
        cnp.max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,ov,m,dtype,d,case", [
    (1, 1024, 64, torch.bfloat16, 384, "split"),
    (3, 1024, 64, torch.float32, 384, "split"),
    (1, 128, 16, torch.float32, 384, "split"),
    (2, 4096, 64, torch.bfloat16, 384, "fused"),
    (2, 4097, 64, torch.bfloat16, 384, "radix"),
    (2, 4097, 16, torch.float32, 384, "radix"),
    (5, 40, 64, torch.float32, 384, "short"),
    (4, 512, 16, torch.bfloat16, 384, "empty"),
    (6, 300, 32, torch.float32, 101, "scalar"),
    (6, 300, 32, torch.bfloat16, 100, "scalar"),
    (6, 300, 32, torch.float32, 384, "unaligned")])
def test_rerank_f32_routes_match_plain_on_card(b, ov, m, dtype, d, case):
    """K2 by route: the grid split over a few queries ("split", where each
    query alone must give the batch's answer bit for bit), the fused select
    at its limit and the radix route just past it (each counted apart), a
    pool shorter than m, pools of all -1, rows off the 16-byte layout (D %
    4 != 0 on f32 rows, D % 8 != 0 on bf16 rows, a mirror 4 bytes off)."""
    from fabstir_vectordb_tpu_torch.index import fused as fused_t
    from fabstir_vectordb_tpu_torch.utils import native

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(21)
    n = 50_000
    base = torch.randn(n * d + 1, device=dev, generator=g).to(dtype)
    x = base[1:] if case == "unaligned" else base[:-1]
    x = x.view(n, d)
    q = torch.randn(b, d, device=dev, generator=g)
    rows = torch.argsort(torch.rand(b, n, device=dev, generator=g), dim=1)[
        :, :ov].to(torch.int32).contiguous()
    rows[:, -max(ov // 8, 1):] = -1
    if case == "empty":
        rows[:] = -1
    name = "rerank_f32" if dtype == torch.bfloat16 else "rerank_f32_rows"
    before = (native.launches[name], native.launches[name + "_radix"])
    vt, rt = fused_t.rerank_f32(x, q, rows, m)
    torch.cuda.synchronize()
    radix = case == "radix"
    assert native.launches[name] - before[0] == int(not radix)
    assert native.launches[name + "_radix"] - before[1] == int(radix)
    vp, rp = fused_t.rerank_f32_plain(x, q, rows, m)
    _assert_close_up_to_ties(vt, rt, vp, rp, 1e-5, 1e-3)
    if case == "empty":
        assert (rt == -1).all() and torch.isinf(vt).all()
    if case == "short":
        assert (rt[:, ov - ov // 8:] == -1).all()
    if case == "split":
        for i in range(b):
            v1, r1 = fused_t.rerank_f32(x, q[i:i + 1].contiguous(),
                                        rows[i:i + 1].contiguous(), m)
            assert torch.equal(r1[0], rt[i]) and torch.equal(v1[0], vt[i])


def _upper_graph(seed, n, d, m, top=4):
    """A seeded upper-layer graph, as index/hnsw.py's device arrays hold it:
    n clustered rows, node i at level l with probability 4^-l (at most
    top, node 0 at top: the entry), its lists on layers 1 .. level at
    nbrs_up[up_offset[i] + l - 1] (up_offset -1 for level-0 nodes), each
    its m nearest nodes of that level (-1 where fewer are left)."""
    rng = np.random.default_rng(seed)
    x, _ = _mixture(seed, n, 24, d=d, spread=0.5)
    level = np.minimum(np.floor(-np.log(rng.random(n)) / np.log(4)),
                       top).astype(np.int32)
    level[0] = top
    up_offset = np.full(n, -1, np.int32)
    upper = np.nonzero(level > 0)[0]
    up_offset[upper] = (np.cumsum(level[upper]) - level[upper]).astype(
        np.int32)
    nbrs_up = np.full((int(level.sum()), m), -1, np.int32)
    for lay in range(1, top + 1):
        at = np.nonzero(level >= lay)[0]
        xa = x[at].astype(np.float64)
        dd = ((xa[:, None, :] - xa[None]) ** 2).sum(-1)
        np.fill_diagonal(dd, np.inf)
        kk = min(m, at.size - 1)
        near = np.argsort(dd, axis=1, kind="stable")[:, :kk]
        nbrs_up[up_offset[at] + lay - 1, :kk] = at[near]
    q = (x[rng.integers(0, n, 64)]
         + 0.3 * rng.standard_normal((64, d))).astype(np.float32)
    return x, nbrs_up, up_offset, q


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,bf16,case", [
    (5, 100, False, "stop"), (32, 128, False, "stop"),
    (16, 96, True, "stop"), (32, 384, True, "stop"),
    (16, 384, False, "masked_entry"), (16, 384, True, "max_hops"),
    (32, 200, False, "masked_entry")])
def test_greedy_descent_shapes_match_plain_on_card(m, d, bf16, case):
    """K10 at M = 5 and 32, D % 128 != 0, bf16 rows, a fifth of the
    nodes masked out (a masked entry too, case "masked_entry"), stop_layer
    per query, max_hops reached (case "max_hops"), each held to the plain
    version (99% of walks equal, distances close where equal: the norm
    expansion |q|^2 - 2 q.x + |x|^2 summed in another order differs by a
    few f32 ulps of |q|^2 + |x|^2, ~12,000 at D = 384 here, so the bound is
    8 ulps of that, 1e-6 of it); every query alone (B = 1) gives the
    batch's answer bit for bit."""
    dev = _card()
    x, nbrs_up, up_offset, q = _upper_graph(7 + m + d, 3000, d, m)
    rng = np.random.default_rng(m * d)
    mask = rng.random(x.shape[0]) >= 0.2
    mask[0] = case != "masked_entry"
    stop = rng.integers(0, 3, q.shape[0]).astype(np.int32)
    xt = torch.from_numpy(x).to(dev)
    x_sq = (xt * xt).sum(1)
    if bf16:
        xt = xt.to(torch.bfloat16)
    args = (xt, x_sq, torch.from_numpy(mask).to(dev),
            torch.from_numpy(nbrs_up).to(dev),
            torch.from_numpy(up_offset).to(dev))
    qt = torch.from_numpy(q).to(dev)
    st = torch.from_numpy(stop).to(dev)
    hops = 2 if case == "max_hops" else 512
    ck, dk = hnsw_t.greedy_descent(*args, qt, 0, 4, st, hops)
    stats = {}
    cp, dp = hnsw_t.greedy_descent_plain(*args, qt, 0, 4, st, hops,
                                         stats=stats)
    assert (ck == cp).float().mean().item() >= 0.99
    same = ck == cp
    norms = float(x_sq.max() + (qt * qt).sum(1).max())
    torch.testing.assert_close(dk[same], dp[same], rtol=1e-5,
                               atol=1e-6 * norms)
    if case == "max_hops":
        assert stats["longest"] == 2
    else:
        assert stats["longest"] > 4  # walks moved on the upper layers
    for i in range(8):
        c1, d1 = hnsw_t.greedy_descent(*args, qt[i:i + 1].contiguous(), 0, 4,
                                       st[i:i + 1].contiguous(), hops)
        assert torch.equal(c1[0], ck[i]) and torch.equal(d1[0], dk[i])
