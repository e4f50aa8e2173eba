"""The port's tiered exact search against the JAX package's, on the CPU.

``TieredFlatSearcher`` streams a host corpus in fixed-size tiles (the tail
zero-padded and masked out) and merges each tile's top-k into a running
one; on the CPU its steps take K1's and K8's plain versions. The JAX
package's searcher runs its jitted ``_tile_step`` over the same numpy
inputs. Rows must be equal; squared distances agree within 1e-4 relative
(the norm expansion's f32 sums taken in another order). Then
``MultiDeviceTieredSearcher`` over two CPU devices against a float64 brute
force, and ``recall_at_k``, which streams its oracle instead of uploading
an f32 mirror, under the reduced-rank regime.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.index import flat as flat_j  # noqa: E402
from fabstir_vectordb_tpu.index import tiered as tiered_j  # noqa: E402
from fabstir_vectordb_tpu.index.store import VectorStore as StoreJ  # noqa: E402
from fabstir_vectordb_tpu_torch.index import flat as flat_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index import tiered as tiered_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index.hybrid import (  # noqa: E402
    HybridConfig, HybridIndex, SearchConfig)
from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig  # noqa: E402
from fabstir_vectordb_tpu_torch.utils import limits as limits_t  # noqa: E402

D = 32
RTOL = 1e-4


def _corpus(seed, n, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((20, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, 20, n)] \
        + rng.standard_normal((n, d)).astype(np.float32)
    q = x[rng.integers(0, n, 9)] + 0.1 * rng.standard_normal((9, d)) \
        .astype(np.float32)
    mask = rng.random(n) < 0.9
    return x, q.astype(np.float32), mask


def _assert_same(dt, rt, dj, rj, ties=False, atol=1e-4):
    """Distances agree place by place; rows are equal, or with ``ties``
    (k in the thousands, where f32 sums put some neighbours within 1e-7 of
    each other) a row may sit in another place, or drop out at the k-th,
    only where its distance ties the other list's there."""
    dj, rj = np.asarray(dj), np.asarray(rj)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=RTOL, atol=atol)
    if not ties:
        np.testing.assert_array_equal(rt, rj)
        return
    assert (rt != rj).mean() < 0.01
    for i, p in zip(*np.nonzero(rt != rj)):
        where = np.nonzero(rj[i] == rt[i, p])[0]
        d_other = dj[i, where[0]] if where.size else dj[i, -1]
        assert abs(d_other - dt[i, p]) <= RTOL * abs(dt[i, p]) + atol, \
            (i, p)


def _exact(x, q, mask, k):
    """float64 brute force, padded with (+inf, -1) past the live rows, and
    the absolute slack of an f32 norm expansion at these norms."""
    d = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    d = np.concatenate([np.where(mask[None], d, np.inf),
                        np.full((len(q), k), np.inf)], axis=1)
    rows = np.argsort(d, axis=1, kind="stable")[:, :k]
    dk = np.take_along_axis(d, rows, 1)
    slack = 1e-6 * float((x.astype(np.float64) ** 2).sum(1).max()
                         + (q.astype(np.float64) ** 2).sum(1).max())
    return dk, np.where(np.isfinite(dk), rows, -1), slack


@pytest.mark.parametrize("n,tile_rows,k", [
    (2500, 1024, 10),    # a ragged tail tile
    (3072, 1024, 1),     # whole tiles
    (2500, 1024, 1500),  # k larger than a tile
    (700, None, 16),     # one tile, sized from the budget
])
def test_tiered_matches_reference(n, tile_rows, k):
    x, q, mask = _corpus(n, n)
    sj = tiered_j.TieredFlatSearcher(x, mask, tile_rows=tile_rows)
    st = tiered_t.TieredFlatSearcher(x, mask, tile_rows=tile_rows,
                                     device="cpu")
    assert (st.tile_rows, st.n_tiles) == (sj.tile_rows, sj.n_tiles)
    seen = []
    dt, rt = st.search(q, k, progress=seen.append)
    dj, rj = sj.search(q, k)
    assert seen == list(range(st.n_tiles))
    _assert_same(dt, rt, dj, rj, ties=k > 100)
    # exact: the float64 brute force's rows
    de, re, slack = _exact(x, q, mask, k)
    _assert_same(dt, rt, de, re, ties=k > 100, atol=slack)


def test_tiered_extra_mask_and_fully_masked_queries():
    x, q, mask = _corpus(5, 2100)
    extra = np.arange(2100) % 3 == 0
    sj = tiered_j.TieredFlatSearcher(x, mask, tile_rows=1024)
    st = tiered_t.TieredFlatSearcher(x, mask, tile_rows=1024, device="cpu")
    dt, rt = st.search(q, 12, extra_mask=extra)
    dj, rj = sj.search(q, 12, extra_mask=extra)
    _assert_same(dt, rt, dj, rj)
    assert (extra & mask)[rt[rt >= 0]].all()
    # the searcher's own mask is restored after an extra mask
    _, r2 = st.search(q, 12)
    _, rj2 = sj.search(q, 12)
    np.testing.assert_array_equal(r2, np.asarray(rj2))
    # fewer rows than k pass: padded with (+inf, -1) in both
    few = np.zeros(2100, bool)
    few[[3, 1500]] = True
    dt, rt = st.search(q, 5, extra_mask=few)
    dj, rj = sj.search(q, 5, extra_mask=few)
    _assert_same(dt, rt, dj, rj)
    assert (rt[:, 2:] == -1).all() and np.isinf(dt[:, 2:]).all()


def test_budget_sizes_tiles_as_the_reference():
    x = np.zeros((10_000, 384), np.float32)
    for budget in (2 << 30, 1 << 20, 3 << 20):
        sj = tiered_j.TieredFlatSearcher(x, hbm_budget_bytes=budget)
        st = tiered_t.TieredFlatSearcher(x, hbm_budget_bytes=budget,
                                         device="cpu")
        assert (st.tile_rows, st.n_tiles) == (sj.tile_rows, sj.n_tiles)
    # bench.py's 10M tier: 2 GiB / 2 / 1,536 B, rounded up to 1,024 rows
    big = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32),
                                          (10_000_000, 384), (0, 0))
    st = tiered_t.TieredFlatSearcher(big, device="cpu")
    assert (st.tile_rows, st.n_tiles) == (699_392, 15)


def test_tile_step_matches_reference():
    x, q, mask = _corpus(7, 1024)
    k = 10
    rng = np.random.default_rng(8)
    vals = np.sort(rng.random((9, k)).astype(np.float32) * 50, axis=1)
    rows = rng.integers(5000, 6000, (9, k)).astype(np.int32)
    vals[:2, 6:] = np.inf
    rows[:2, 6:] = -1
    vj, rj = tiered_j._tile_step(jnp.asarray(x), jnp.asarray(mask),
                                 jnp.asarray(q), jnp.int32(2048),
                                 jnp.asarray(vals), jnp.asarray(rows), k)
    vt, rt = tiered_t.tile_step(torch.from_numpy(x), torch.from_numpy(mask),
                                torch.from_numpy(q), 2048,
                                torch.from_numpy(vals),
                                torch.from_numpy(rows), k)
    _assert_same(vt.numpy(), rt.numpy(), vj, rj)
    out = (torch.empty(9, k), torch.empty(9, k, dtype=torch.int32))
    vo, ro = tiered_t.tile_step(torch.from_numpy(x), torch.from_numpy(mask),
                                torch.from_numpy(q), 2048,
                                torch.from_numpy(vals),
                                torch.from_numpy(rows), k, out=out)
    assert vo is out[0] and torch.equal(ro, rt)


@pytest.mark.parametrize("n,k", [(3000, 10), (5, 8)])
def test_multi_device_tiered_is_exact(n, k):
    x, q, mask = _corpus(n + 1, n)
    ms = tiered_t.MultiDeviceTieredSearcher(
        x, mask, devices=["cpu", "cpu"], tile_rows=1024)
    assert len(ms.shards) == 2
    d, r = ms.search(q, k)
    de, re, slack = _exact(x, q, mask, k)
    _assert_same(d, r, de, re, atol=slack)


def test_empty_corpus():
    st = tiered_t.TieredFlatSearcher(np.zeros((0, D), np.float32),
                                     device="cpu")
    d, r = st.search(np.ones((2, D), np.float32), 3)
    assert (r == -1).all() and np.isinf(d).all()


def test_recall_at_k_streams_under_the_reduced_regime(monkeypatch):
    """recall_at_k's oracle holds no f32 mirror while the reduced-rank
    regime serves, and gives the JAX package's recall."""
    monkeypatch.setattr(limits_t, "FLAT_THRESHOLD", 0)
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "0")
    for var in ("FVDB_PCA_SERVE", "FVDB_PCA_RERANK", "FVDB_PCA_RANK",
                "FVDB_PCA_OVERSAMPLE"):
        monkeypatch.delenv(var, raising=False)
    x, q, _ = _corpus(11, 3000)
    h = HybridIndex(D, HybridConfig(ivf=IVFConfig(n_clusters=8, n_probe=8,
                                                  seed=0),
                                    auto_migrate=False), device="cpu")
    h.initialize(x[:1000])
    h.insert_batch([f"v{i}" for i in range(3000)], x,
                   np.full(3000, 1.0), now=1e9)
    h.batch_delete([f"v{i}" for i in range(0, 3000, 7)])
    _, rows = h.search_rows(q, 10, config=SearchConfig(auto_migrate=False),
                            now=1e9)
    assert h.fused.serving_info()["regime"] == "reduced-rank"
    assert h.store._mirror is None and h.fused._proj is not None
    rec = flat_t.recall_at_k(h.flat, rows, q, 10)
    assert h.store._mirror is None and h.fused._dev is None
    assert h.fused._proj is not None  # the serving state is kept
    sj = StoreJ(D)
    sj.add_batch([f"v{i}" for i in range(3000)], x, 1.0)
    for i in range(0, 3000, 7):
        sj.mark_deleted(f"v{i}")
    want = flat_j.recall_at_k(flat_j.FlatIndex(sj), rows, q, 10)
    assert rec == want
    assert rec >= 0.9
