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
from fabstir_vectordb_tpu_torch.ops import topk as topk_t

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
