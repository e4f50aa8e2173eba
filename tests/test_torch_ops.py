"""The port's ops against the JAX package's, on the CPU at small sizes.

Inputs are made with numpy from a seed and go through the JAX function and
the port's plain version (a wrapper takes its plain version for CPU
tensors). The kernels themselves are held against the same plain versions
on the card by ``test_torch_kernels.py`` and ``chip_smoke.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.index import fused as fused_j  # noqa: E402
from fabstir_vectordb_tpu.index import hnsw as hnsw_j  # noqa: E402
from fabstir_vectordb_tpu.ops import distance as dist_j  # noqa: E402
from fabstir_vectordb_tpu.ops import kmeans as km_j  # noqa: E402
from fabstir_vectordb_tpu.ops import topk as topk_j  # noqa: E402
from fabstir_vectordb_tpu_torch.index import hnsw as hnsw_t  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import distance as dist_t  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import kmeans as km_t  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import topk as topk_t  # noqa: E402
from fabstir_vectordb_tpu_torch.utils import native  # noqa: E402

from .test_torch_kernels import (  # noqa: E402
    ATOL, D, RTOL, _assert_kept_equal_up_to_near_ties, _assert_topk_equal,
    _candidate_pools, _clustered, _data)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
def test_pairwise_distance_matches_reference(metric):
    q, x = _data(1, 16), _data(2, 300)
    want = np.asarray(dist_j.pairwise_distance(jnp.asarray(q), jnp.asarray(x),
                                               metric=metric))
    got = dist_t.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x),
                                   metric=metric).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mask_kind", ["rows", "per_query"])
@pytest.mark.parametrize("k", [1, 16, 200])
def test_l2_topk_matches_flat_search_kernel(mask_kind, k):
    """K1: the port's fused L2 top-k against fused.flat_search_kernel."""
    rng = np.random.default_rng(3)
    x, q = _data(4, 4096), _data(5, 37)
    shape = (4096,) if mask_kind == "rows" else (37, 4096)
    mask = rng.random(shape) < 0.9
    x_sq = (x * x).sum(1)
    vj, rj = fused_j.flat_search_kernel(
        jnp.asarray(x), jnp.asarray(x_sq), jnp.asarray(mask), jnp.asarray(q), k)
    vt, rt = topk_t.l2_topk(torch.from_numpy(x), torch.from_numpy(x_sq),
                            torch.from_numpy(mask), torch.from_numpy(q), k)
    assert vt.dtype == torch.float32 and rt.dtype == torch.int32
    _assert_topk_equal(vj, rj, vt.numpy(), rt.numpy())


def test_l2_topk_pads_when_few_rows_are_masked_in():
    x, q = _data(6, 300), _data(7, 4)
    mask = np.zeros(300, bool)
    mask[[3, 17, 250]] = True
    x_sq = (x * x).sum(1)
    vj, rj = fused_j.flat_search_kernel(
        jnp.asarray(x), jnp.asarray(x_sq), jnp.asarray(mask), jnp.asarray(q), 8)
    vt, rt = topk_t.l2_topk(torch.from_numpy(x), torch.from_numpy(x_sq),
                            torch.from_numpy(mask), torch.from_numpy(q), 8)
    _assert_topk_equal(vj, rj, vt.numpy(), rt.numpy())
    assert (rt.numpy()[:, 3:] == -1).all()
    assert np.isinf(vt.numpy()[:, 3:]).all()


def test_masked_topk_and_merge_topk_match_reference():
    rng = np.random.default_rng(8)
    d = rng.random((5, 500)).astype(np.float32)
    mask = rng.random(500) < 0.5
    vj, ij = topk_j.masked_topk(jnp.asarray(d), jnp.asarray(mask), 20)
    vt, it = topk_t.masked_topk(torch.from_numpy(d), torch.from_numpy(mask), 20)
    _assert_topk_equal(vj, ij, vt.numpy(), it.numpy())
    # merge two result sets, one with padding
    va, ia = vt[:, :10], it[:, :10]
    vb = torch.from_numpy(rng.random((5, 10)).astype(np.float32))
    vb[:, 7:] = float("inf")
    ib = torch.arange(1000, 1010, dtype=torch.int32).repeat(5, 1)
    ib[:, 7:] = -1
    mj = topk_j.merge_topk(jnp.asarray(va.numpy()), jnp.asarray(ia.numpy()),
                           jnp.asarray(vb.numpy()), jnp.asarray(ib.numpy()), 12)
    mt = topk_t.merge_topk(va, ia, vb, ib, 12)
    _assert_topk_equal(mj[0], mj[1], mt[0].numpy(), mt[1].numpy())


def test_streaming_topk_keeps_the_k_best():
    s = topk_t.StreamingTopK(3)
    s.push_many([5.0, 1.0, 4.0, 2.0, 3.0], "abcde")
    assert [it for _, it in s.results()] == ["b", "d", "e"]
    assert s.worst == 3.0


@pytest.mark.parametrize("chunked", [False, True])
def test_link_candidates_match_flat_candidates_kernel(chunked, monkeypatch):
    """K3 is served by K1: the exact candidates over the member prefix
    equal the reference's (its CPU approx_min_k is exact), for the
    monolithic and the chunk-streamed scan."""
    rng = np.random.default_rng(9)
    x = _data(10, 2048)
    x_sq = (x * x).sum(1)
    mask = rng.random(2048) < 0.8
    q = _data(11, 64)
    n_pad = 2048
    if chunked:
        monkeypatch.setattr(hnsw_j, "_CAND_CHUNK", 1024)
        fn = hnsw_j._flat_candidates_chunked
    else:
        fn = hnsw_j._flat_candidates_kernel
    vj, rj = fn(jnp.asarray(x), jnp.asarray(x_sq), jnp.asarray(mask),
                jnp.asarray(q), 200, n_pad)
    vt, rt = topk_t.l2_topk(torch.from_numpy(x[:n_pad]),
                            torch.from_numpy(x_sq[:n_pad]),
                            torch.from_numpy(mask[:n_pad]),
                            torch.from_numpy(q), 200)
    for a, b in zip(np.asarray(rj), rt.numpy()):
        assert set(a.tolist()) == set(b.tolist())
    _assert_topk_equal(vj, rj, vt.numpy(), rt.numpy())


@pytest.mark.parametrize("c,m,pad_from", [(128, 32, None), (64, 32, 50),
                                          (48, 16, None)])
def test_heuristic_kept_matches_reference(c, m, pad_from):
    """K4 against heuristic_kept_kernel and _heuristic_kept_host."""
    x, ids, d = _candidate_pools(12, 96, c, pad_from=pad_from)
    kj = np.asarray(hnsw_j.heuristic_kept_kernel(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(d), m))
    kh = hnsw_j._heuristic_kept_host(x[np.maximum(ids, 0)], d, ids >= 0, m)
    kt = hnsw_t.heuristic_kept(torch.from_numpy(x), torch.from_numpy(ids),
                               torch.from_numpy(d), m).numpy()
    assert kt.dtype == bool and kt.shape == (96, c)
    assert (kt.sum(1) <= m).all()
    assert not kt[ids < 0].any()
    _assert_kept_equal_up_to_near_ties(kj, kt, ids, d, x)
    _assert_kept_equal_up_to_near_ties(kh, kt, ids, d, x)


def test_pair_sq_l2_matches_pair_dists_kernel():
    """K5 against _pair_dists_kernel."""
    rng = np.random.default_rng(13)
    x = _data(14, 3000)
    x_sq = (x * x).sum(1)
    t = rng.integers(0, 3000, 5000).astype(np.int32)
    c = rng.integers(0, 3000, 5000).astype(np.int32)
    want = np.asarray(hnsw_j._pair_dists_kernel(
        jnp.asarray(x), jnp.asarray(x_sq), jnp.asarray(t), jnp.asarray(c)))
    got = hnsw_t.pair_sq_l2(torch.from_numpy(x), torch.from_numpy(x_sq),
                            torch.from_numpy(t), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_assign_clusters_matches_reference():
    x = _data(15, 1000)
    cents = _data(16, 7)
    mask = np.random.default_rng(17).random(1000) < 0.7
    aj, dj = km_j.assign_clusters(jnp.asarray(x), jnp.asarray(cents),
                                  jnp.asarray(mask))
    at, dt = km_t.assign_clusters(torch.from_numpy(x), torch.from_numpy(cents),
                                  torch.from_numpy(mask))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,c", [(16, 3), (1024, 32)])
def test_lloyd_block_matches_reference(n, c):
    """K6: the same initial centroids into both; every stacked iteration's
    centroids within 1e-5 relative, errors too."""
    x = _clustered(18, n, c)
    mask = np.arange(n) < (10 if n == 16 else n - 24)
    init = x[np.random.default_rng(19).choice(int(mask.sum()), c,
                                              replace=False)]
    cj, ej = km_j._lloyd_block(jnp.asarray(x), jnp.asarray(mask),
                               jnp.asarray(init), 5)
    ct, et = km_t.lloyd_block(torch.from_numpy(x), torch.from_numpy(mask),
                              torch.from_numpy(init), 5)
    assert tuple(ct.shape) == (5, c, D) and tuple(et.shape) == (5,)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    # the error sums |x|^2 - 2 x.c + |c|^2 with |x|^2 ~ 500 here: f32
    # cancellation leaves ~5e-5 absolute in each term
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5,
                               atol=1e-4)


def test_kmeans_train_stepped_stops_at_the_same_iteration(monkeypatch):
    x = _clustered(20, 512, 8, spread=0.8)
    mask = np.arange(512) < 500
    init = x[:8].copy()
    monkeypatch.setattr(km_j, "kmeans_scalable_init",
                        lambda *a, **k: jnp.asarray(init))
    monkeypatch.setattr(km_t, "kmeans_scalable_init",
                        lambda *a, **k: torch.from_numpy(init))
    rj = km_j.kmeans_train_stepped(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(mask), 8, max_iterations=25)
    rt = km_t.kmeans_train_stepped(0, torch.from_numpy(x),
                                   torch.from_numpy(mask), 8,
                                   max_iterations=25)
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    np.testing.assert_allclose(rt.centroids.numpy(), np.asarray(rj.centroids),
                               rtol=1e-5, atol=1e-5)
    assert abs(rt.final_error - float(rj.final_error)) <= 1e-5 * max(
        1.0, float(rj.final_error))


def test_kmeans_seeding_reaches_the_reference_error():
    """K7 draws from another RNG, so it is judged by the converged error on
    separated clusters."""
    x = _clustered(21, 1024, 8)
    mask = np.ones(1024, bool)
    rj = km_j.kmeans_train_stepped(jax.random.PRNGKey(42), jnp.asarray(x),
                                   jnp.asarray(mask), 8)
    rt = km_t.kmeans_train_stepped(42, torch.from_numpy(x),
                                   torch.from_numpy(mask), 8)
    assert rt.final_error <= max(1.05 * float(rj.final_error),
                                 float(rj.final_error) + 1e-3)
    assert tuple(rt.centroids.shape) == (8, D)


def test_wrappers_refuse_other_devices():
    x = torch.zeros((4, D), device="meta")
    with pytest.raises(ValueError):
        topk_t.l2_topk(x, torch.zeros(4, device="meta"),
                       torch.ones(4, dtype=torch.bool, device="meta"),
                       torch.zeros((1, D), device="meta"), 2)


def test_launch_counters_stay_at_zero_on_the_cpu():
    """On CPU tensors the wrappers take the plain versions and launch
    nothing."""
    native.reset_launches()
    x = torch.from_numpy(_data(22, 64))
    topk_t.l2_topk(x, (x * x).sum(1), torch.ones(64, dtype=torch.bool),
                   x[:2].clone(), 4)
    assert all(v == 0 for v in native.launches.values())
