"""The port's multi-shard layer (``parallel/``, K15) against the JAX
package's, on the CPU.

The JAX package runs on its 8-device virtual CPU mesh (``cpu_mesh(8)``, the
conftest's XLA flag); the port on ``cpu_mesh(8)``, eight shards of CPU
tensors in this process, where every kernel wrapper takes its plain
version. The same numpy inputs from one seed go into both; results are
compared as sorted (distance, row) pairs (the port merges by (distance,
row), ``lax.top_k`` by shard and position), rows equal and squared
distances within 1e-5. One case per test of
``tests/engine/test_parallel.py``, plus saves carried across packages both
ways and a gloo process group of two ranks. The kernels are held against
the same plain versions on the card by ``test_torch_kernels.py`` and
``chip_smoke.py --phase parallel``.
"""
import json
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu import parallel as pj  # noqa: E402
from fabstir_vectordb_tpu.core.object_store import (  # noqa: E402
    MemoryObjectStore as StoreObjJ)
from fabstir_vectordb_tpu.index import hnsw as hnsw_j  # noqa: E402
from fabstir_vectordb_tpu.index import ivf as ivf_j  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridConfig as HybridConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridIndex as HybridJ  # noqa: E402
from fabstir_vectordb_tpu.index.store import VectorStore as VStoreJ  # noqa: E402
from fabstir_vectordb_tpu.ops.projection import fit_pca, project  # noqa: E402
from fabstir_vectordb_tpu.parallel import sharded as sharded_j  # noqa: E402
from fabstir_vectordb_tpu_torch import convert  # noqa: E402
from fabstir_vectordb_tpu_torch import parallel as pt  # noqa: E402
from fabstir_vectordb_tpu_torch.core.object_store import (  # noqa: E402
    MemoryObjectStore)
from fabstir_vectordb_tpu_torch.index import hnsw as hnsw_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index.hybrid import HybridConfig  # noqa: E402
from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig  # noqa: E402
from fabstir_vectordb_tpu_torch.index.store import VectorStore  # noqa: E402
from fabstir_vectordb_tpu_torch.parallel import ingest as ingest_t  # noqa: E402
from fabstir_vectordb_tpu_torch.parallel import sharded as sharded_t  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(scope="module")
def meshes():
    return pj.cpu_mesh(8), pt.cpu_mesh(8)


def _data(seed, n, d=16, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * scale).astype(np.float32)


def _np(*arrs):
    return [a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in arrs]


def _pairs(vals, rows):
    vals, rows = np.asarray(vals, np.float64), np.asarray(rows, np.int64)
    order = np.lexsort((rows, vals), axis=1)
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(rows, order, 1))


def _assert_same(vj, rj, vt, rt, tol=TOL, atol=None):
    """Sorted (distance, row) pairs: rows equal, distances within tol
    (relative, and absolute unless ``atol``)."""
    vj, rj, vt, rt = _np(vj, rj, vt, rt)
    assert vt.shape == vj.shape and rt.shape == rj.shape
    vj, rj = _pairs(vj, rj)
    vt, rt = _pairs(vt, rt)
    np.testing.assert_array_equal(rt, rj)
    fin = np.isfinite(vj)
    np.testing.assert_array_equal(np.isfinite(vt), fin)
    np.testing.assert_allclose(vt[fin], vj[fin], rtol=tol,
                               atol=tol if atol is None else atol)


def _norm_atol(x, q):
    """1e-5 of the largest |q|^2 + |x|^2: where a query sits on a stored row
    the squared distance is a cancellation of those norms, and two sums in
    another order differ there by a few of their ulps."""
    return TOL * float((x * x).sum(1).max() + (q * q).sum(1).max())


# ------------------------------------------------------------------ flat


def test_sharded_flat_matches_reference(meshes):
    mj, mt = meshes
    n, b, k = 256, 4, 10
    x, q = _data(0, n), _data(1, b)
    mask = np.ones(n, bool)
    mask[5] = False  # a deleted row
    vj, rj = pj.sharded_flat_search(mj)(x, (x * x).sum(1), mask, q, k)
    vt, rt = pt.sharded_flat_search(mt)(x, (x * x).sum(1), mask, q, k)
    _assert_same(vj, rj, vt, rt)
    dist = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    dist[:, 5] = np.inf
    np.testing.assert_array_equal(rt.numpy(), np.argsort(dist, 1)[:, :k])
    assert vt.dtype == torch.float32 and rt.dtype == torch.int32


@pytest.mark.parametrize("n,oversample", [(256, 16), (4096, 16)])
def test_sharded_flat_approx_select_matches_reference(meshes, n, oversample):
    """Where each shard's pool is all its rows (256 / 8 = 32 <= 4k) K9's
    binned pool is exact, as JAX's CPU approx_min_k: rows equal to JAX's.
    At 512 rows a shard the bins drop rows: recall@10 against the exact
    search holds ROADMAP C's K9 bound (>= 0.90)."""
    mj, mt = meshes
    b, k = 4 if n == 256 else 32, 10
    x, q = _data(2, n), _data(3, b)
    mask = np.ones(n, bool)
    mask[5] = False
    mask[200:210] = False
    x_sq = (x * x).sum(1)
    et, ert = pt.sharded_flat_search(mt)(x, x_sq, mask, q, k)
    tv, tr = pt.sharded_flat_search(mt, select="approx",
                                    oversample=oversample)(x, x_sq, mask, q, k)
    assert not np.isin(tr.numpy(), [5] + list(range(200, 210))).any()
    if n == 256:
        jv, jr = pj.sharded_flat_search(mj, select="approx",
                                        oversample=oversample)(
            x, x_sq, mask, q, k)
        _assert_same(jv, jr, tv, tr)
    else:
        hits = sum(len(set(a) & set(e)) for a, e in zip(tr.numpy(),
                                                        ert.numpy()))
        assert hits / (b * k) >= 0.90
        # a row the pool kept has its exact distance
        for i in range(b):
            got = dict(zip(ert[i].tolist(), et[i].tolist()))
            for r, v in zip(tr[i].tolist(), tv[i].tolist()):
                if r in got:
                    assert abs(got[r] - v) <= TOL * max(1.0, abs(v))
    with pytest.raises(ValueError):
        pt.sharded_flat_search(mt, select="bogus")


def test_sharded_flat_2d_mesh_query_sharding(meshes):
    mj, mt = meshes
    devs = jax.devices("cpu")[:8]
    mesh2 = Mesh(np.array(devs).reshape(4, 2), ("data", "query"))
    mt2 = pt.LocalMesh((4, 2), ("data", "query"), device="cpu")
    n, b, k = 512, 4, 10
    x, q = _data(4, n), _data(5, b)
    mask = np.ones(n, bool)
    mask[9] = False
    x_sq = (x * x).sum(1)
    put = lambda a, s: jax.device_put(a, NamedSharding(mesh2, P(s)))  # noqa
    vj, rj = pj.sharded_flat_search(mesh2, query_axis="query")(
        put(x, "data"), put(x_sq, "data"), put(mask, "data"), put(q, "query"),
        k)
    vt, rt = pt.sharded_flat_search(mt2, query_axis="query")(
        x, x_sq, mask, q, k)
    _assert_same(vj, rj, vt, rt)
    v1, r1 = pt.sharded_flat_search(mt)(x, x_sq, mask, q, k)
    _assert_same(v1, r1, vt, rt, tol=0.0)
    assert 9 not in rt.numpy()


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_flat_every_mesh_size_with_padding(n_dev):
    """The reference's scaling test at a CPU size: every mesh size, rows
    padded to a multiple of it with masked rows, equals the exact answer
    and JAX's mesh of the same size (distances near 0 within
    :func:`_norm_atol`)."""
    n, b, k = 4_000, 8, 10
    x = _data(6, n, 32)
    q = x[:b] + 0.01
    n_pad = -(-n // n_dev) * n_dev
    xp = np.concatenate([x, np.zeros((n_pad - n, 32), np.float32)])
    mp = np.arange(n_pad) < n
    sq = (xp * xp).sum(1)
    vt, rt = pt.sharded_flat_search(pt.cpu_mesh(n_dev))(xp, sq, mp, q, k)
    vj, rj = pj.sharded_flat_search(pj.cpu_mesh(n_dev))(xp, sq, mp, q, k)
    _assert_same(vj, rj, vt, rt, atol=_norm_atol(x, q))
    d = (q * q).sum(1)[:, None] - 2.0 * q @ x.T + (x * x).sum(1)[None]
    np.testing.assert_array_equal(np.sort(rt.numpy()),
                                  np.sort(np.argsort(d, 1, kind="stable")
                                          [:, :k]))


def test_sharded_projected_search_matches_reference(meshes):
    mj, mt = meshes
    rng = np.random.default_rng(7)
    n, dim, rank, k = 2048, 32, 16, 5
    centers = rng.standard_normal((8, dim)).astype(np.float32)
    x = (centers[rng.integers(0, 8, n)]
         + 0.1 * rng.standard_normal((n, dim)).astype(np.float32))
    mu, p = fit_pca(x, rank)
    xp = project(x, mu, p)
    xp_sq = np.einsum("nr,nr->n", xp, xp)
    mask = np.ones(n, bool)
    mask[3] = False
    q = x[:16] + 0.01
    sh = NamedSharding(mj, P("data"))
    vj, rj = pj.sharded_projected_search(mj)(
        jax.device_put(jnp.asarray(xp, jnp.bfloat16), sh),
        jax.device_put(jnp.asarray(xp_sq), sh),
        jax.device_put(jnp.asarray(mask), sh), jnp.asarray(mu),
        jnp.asarray(p), jnp.asarray(q), 128)
    xp_t = torch.from_numpy(xp).to(torch.bfloat16)
    vt, rt = pt.sharded_projected_search(mt)(xp_t, xp_sq, mask, mu, p, q, 128)
    assert rt.shape == (16, 128)
    _assert_same(vj, rj, vt, rt)
    # host re-score of the stage-1 candidates -> the exact top-k
    rows = rt.numpy()
    diff = x[np.maximum(rows, 0)] - q[:, None, :]
    d = np.where(rows >= 0, np.einsum("bod,bod->bo", diff, diff), np.inf)
    got = np.take_along_axis(rows, np.argsort(d, 1)[:, :k], 1)
    d_full = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    d_full[:, 3] = np.inf
    truth = np.argsort(d_full, 1)[:, :k]
    hits = sum(len(set(a) & set(b)) for a, b in zip(got, truth))
    assert hits / (16 * k) >= 0.95
    assert 3 not in rows


# ------------------------------------------------------------------ IVF


def _ivf_pair(n, d, c, seed, scale=3.0, delete=17):
    """A JAX IVF index over seeded rows (the reference's own training) and
    the host arrays both packages shard."""
    x = _data(seed, n, d, scale)
    store = VStoreJ(d)
    rows = store.add_batch([f"v{i}" for i in range(n)], x)
    ivf = ivf_j.IVFIndex(store, ivf_j.IVFConfig(n_clusters=c, n_probe=c,
                                                seed=0))
    ivf.train(x)
    ivf.insert_rows(rows)
    if delete is not None:
        store.mark_deleted(f"v{delete}")
    return x, store, ivf


def test_sharded_ivf_matches_reference(meshes):
    mj, mt = meshes
    x, store, ivf = _ivf_pair(400, 8, 16, 8)
    args = (ivf.export_centroids(), ivf.tiles(), store.data,
            store.active_mask())
    sj = pj.shard_ivf_state(mj, *args)
    st = pt.shard_ivf_state(mt, *args)
    assert st.n_clusters == 16 and st.c_pad == sj.centroids.shape[0]
    q = x[:6] + 0.01
    for k, n_probe in ((5, 16), (5, 3), (40, 6)):
        vj, rj = pj.sharded_ivf_search(mj)(sj, q, k, n_probe)
        vt, rt = pt.sharded_ivf_search(mt)(st, q, k, n_probe)
        _assert_same(vj, rj, vt, rt)
        assert 17 not in rt.numpy()
    _, host_rows = ivf.search_rows(q, 5, n_probe=16)
    np.testing.assert_array_equal(
        pt.sharded_ivf_search(mt)(st, q, 5, 16)[1].numpy(), host_rows)
    # the packed shards hold the lists' rows, not their padding
    assert sum(s.x.shape[0] for s in st.shards.values()) \
        == int((ivf.tiles() >= 0).sum())


def test_sharded_ivf_uneven_clusters_and_2d_query_sharding(meshes):
    """12 lists over 8 shards (padding clusters at 1e30 on the last
    shards), and the reference's 2D list x query mesh."""
    mj, mt = meshes
    x, store, ivf = _ivf_pair(200, 8, 12, 9, scale=1.0, delete=None)
    args = (ivf.export_centroids(), ivf.tiles(), store.data,
            store.active_mask())
    q = x[:4] + 0.001
    vj, rj = pj.sharded_ivf_search(mj)(pj.shard_ivf_state(mj, *args), q, 3,
                                       12)
    vt, rt = pt.sharded_ivf_search(mt)(pt.shard_ivf_state(mt, *args), q, 3,
                                       12)
    _assert_same(vj, rj, vt, rt)
    mesh2 = Mesh(np.array(jax.devices("cpu")[:8]).reshape(4, 2),
                 ("list", "query"))
    mt2 = pt.LocalMesh((4, 2), ("list", "query"), device="cpu")
    sj2 = pj.shard_ivf_state(mesh2, *args, axis="list")
    st2 = pt.shard_ivf_state(mt2, *args, axis="list")
    vj2, rj2 = pj.sharded_ivf_search(mesh2, axis="list",
                                     query_axis="query")(sj2, q, 3, 8)
    vt2, rt2 = pt.sharded_ivf_search(mt2, axis="list",
                                     query_axis="query")(st2, q, 3, 8)
    _assert_same(vj2, rj2, vt2, rt2)
    assert rt2.numpy()[0, 0] == 0


# ------------------------------------------------------------------ Lloyd


def _three_clusters(seed, per=50):
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0, 0, 0], [8, 8, 8, 8], [-8, 8, -8, 8]],
                       np.float32)
    pts = np.concatenate([c + 0.2 * rng.standard_normal((per, 4))
                          .astype(np.float32) for c in centers])
    return centers, pts


def test_sharded_lloyd_step_and_stop_rule_match_reference(meshes):
    """From injected centroids: one step equal to JAX's, and Lloyd to the
    reference's stop rule at the same iteration with the same error."""
    mj, mt = meshes
    rng = np.random.default_rng(10)
    centers = rng.standard_normal((6, 16)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 6, 1024)]
         + rng.standard_normal((1024, 16)).astype(np.float32))
    mask = np.ones(1024, bool)
    mask[::7] = False
    init = x[rng.choice(np.nonzero(mask)[0], 6, replace=False)]
    cj, ej = sharded_j.sharded_lloyd_step(mj)(x, mask, init)
    ct, et = pt.sharded_lloyd_step(mt)(x, mask, init)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=TOL,
                               atol=TOL * np.abs(x).max())
    assert abs(float(et) - float(ej)) <= TOL * float(ej)
    # the reference's loop from init, one jitted step at a time
    step = sharded_j.sharded_lloyd_step(mj)
    cents, last, its, conv = jnp.asarray(init), float("inf"), 0, False
    for i in range(25):
        cents, err = step(x, mask, cents)
        err, its = float(err), i + 1
        if i > 0 and abs(last - err) / max(last, 1e-30) < 1e-4:
            conv = True
            break
        last = err
    ct, info = sharded_t.sharded_lloyd_until(mt, x, mask, init)
    assert (info["iterations"], info["converged"]) == (its, conv)
    assert abs(info["final_error"] - err) <= TOL * err
    np.testing.assert_allclose(ct.numpy(), np.asarray(cents), rtol=TOL,
                               atol=TOL * np.abs(x).max())


def test_sharded_kmeans_train_by_converged_error(meshes):
    """The seeding RNGs differ (jax.random against torch.Generator): the
    port's converged error is at most 1.5x JAX's over 3 seeds, and the
    reference test's three centers are recovered."""
    mj, mt = meshes
    centers, pts = _three_clusters(11)
    mask = np.ones(len(pts), bool)
    cents, info = pt.sharded_kmeans_train(mt, pts, mask, n_clusters=3, seed=1)
    assert info["converged"]
    for c in centers:
        assert np.linalg.norm(cents - c, axis=1).min() < 0.5
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1001, 8)).astype(np.float32)  # 1001 % 8 != 0
    m = np.ones(1001, bool)
    for seed in (0, 1, 2):
        _, ij = pj.sharded_kmeans_train(mj, x, m, 16, seed=seed)
        _, it = pt.sharded_kmeans_train(mt, x, m, 16, seed=seed)
        assert it["final_error"] <= 1.5 * ij["final_error"]


# ------------------------------------------------------------------ HNSW


NOW = 1e9


@pytest.fixture(scope="module")
def hybrid_pair():
    """A JAX hybrid index (256 recent rows in HNSW, 768 old rows in a
    16-list IVF) and its port, carried across by convert: the same graph
    and lists in both."""
    n, dim = 1024, 32
    vecs = _data(13, n, dim)
    hj = HybridJ(dim, HybridConfigJ(ivf=ivf_j.IVFConfig(n_clusters=16,
                                                         n_probe=16),
                                    auto_migrate=False))
    rng = np.random.default_rng(14)
    hj.ivf.set_trained(vecs[n // 4:][rng.choice(3 * n // 4, 16,
                                                replace=False)])
    ts = np.full(n, NOW - 30 * 86400.0)
    ts[: n // 4] = NOW - 10.0
    hj.insert_batch([f"v{i}" for i in range(n)], vecs, ts, now=NOW)
    h = hj
    state = {
        "store": {"data": h.store.data, "ids": h.store.row_to_id,
                  "timestamps": h.store.timestamps, "deleted": h.store.deleted},
        "hnsw": {"levels": h.hnsw.levels, "nbrs0": h.hnsw.nbrs0,
                 "nbrs_up": h.hnsw.nbrs_up, "up_offset": h.hnsw.up_offset,
                 "entry_point": h.hnsw.entry_point,
                 "max_level": h.hnsw.max_level, "up_count": h.hnsw.up_count},
        "ivf": {"centroids": h.ivf.centroids,
                "assignments": h.ivf.assignments},
    }
    ht = convert.hybrid_from_numpy(state, device="cpu", config=HybridConfig(
        ivf=IVFConfig(n_clusters=16, n_probe=16), auto_migrate=False))
    assert hj.hnsw.num_nodes == n // 4
    return hj, ht, vecs


def test_sharded_hnsw_matches_reference(meshes, hybrid_pair):
    mj, mt = meshes
    hj, ht, vecs = hybrid_pair
    q = vecs[:16] + 0.01  # a batch divisible by 8 shards
    vj, rj = pj.sharded_hnsw_search(mj)(pj.shard_hnsw_state(mj, hj.hnsw), q,
                                        8, 32)
    vt, rt = pt.sharded_hnsw_search(mt)(pt.shard_hnsw_state(mt, ht.hnsw), q,
                                        8, 32)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=TOL,
                               atol=2e-4)
    _, host_rows = ht.hnsw.search_rows(q, 8, ef=32)
    np.testing.assert_array_equal(rt.numpy(), host_rows)


def test_sharded_hybrid_search_matches_reference(meshes, hybrid_pair):
    mj, mt = meshes
    hj, ht, vecs = hybrid_pair
    n = vecs.shape[0]
    out = {}
    for name, mesh, h, p in (("j", mj, hj, pj), ("t", mt, ht, pt)):
        cap = h.store.capacity
        recent = np.zeros(cap, bool)
        recent[: n // 4] = True
        hist = np.zeros(cap, bool)
        hist[n // 4: n] = True
        hstate = p.shard_hnsw_state(mesh, h.hnsw)
        istate = p.shard_ivf_state(mesh, h.ivf.centroids, h.ivf.tiles(),
                                   h.store.data, h.store.active_mask() & hist)
        targets = np.concatenate([np.arange(8), n // 4 + np.arange(8)])
        q = h.store.data[targets] + 0.01
        out[name] = p.sharded_hybrid_search(mesh)(hstate, istate, q, k=4,
                                                  ef=32, n_probe=16)
    (dj, rj), (dt, rt) = out["j"], out["t"]
    assert rt.shape == (16, 4)
    assert (rt[:, 0] == targets).all()
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_allclose(dt, dj, rtol=TOL, atol=2e-4)


# ------------------------------------------------------------ persistence


def _flat_corpus(seed, n, d=16):
    x = _data(seed, n, d)
    mask = np.ones(n, bool)
    mask[33 % n] = False
    return x, (x * x).sum(1), mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_flat_persistence_reshard_and_across_packages(meshes, dtype):
    """Saved at 8 shards, loaded at 4, 2 and 1: the same search. A JAX save
    loads in the port and a port save in JAX, the blobs byte for byte
    equal."""
    mj, mt = meshes
    n, b, k = 512, 4, 10
    x, x_sq, mask = _flat_corpus(20, n)
    q = _data(21, b)
    bf16 = dtype == "bfloat16"
    xt = torch.from_numpy(x).to(torch.bfloat16) if bf16 \
        else torch.from_numpy(x)
    ot = MemoryObjectStore()
    pt.save_sharded_flat(ot, "mc/flat", xt, x_sq, mask, mt)
    assert len(list(ot.list_keys("mc/flat/shards"))) == 8
    v8, r8 = pt.sharded_flat_search(mt)(xt, x_sq, mask, q, k)
    for n_dev in (4, 2, 1):
        mesh = pt.cpu_mesh(n_dev)
        x2, sq2, m2 = pt.load_sharded_flat(ot, "mc/flat", mesh)
        assert x2.dtype == xt.dtype
        v, r = pt.sharded_flat_search(mesh)(x2, sq2, m2, q, k)
        np.testing.assert_array_equal(r.numpy(), r8.numpy())
        np.testing.assert_array_equal(v.numpy(), v8.numpy())
    assert 33 not in r8.numpy()
    # across packages
    sh = NamedSharding(mj, P("data"))
    xj = jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)
    oj = StoreObjJ()
    pj.save_sharded_flat(oj, "mc/flat", jax.device_put(xj, sh),
                         jax.device_put(x_sq, sh), jax.device_put(mask, sh))
    for key in oj.list_keys("mc/flat"):
        assert oj.get(key) == ot.get(key), key
    x4, sq4, m4 = pt.load_sharded_flat(oj, "mc/flat", pt.cpu_mesh(4))
    _assert_same(*pt.sharded_flat_search(pt.cpu_mesh(4))(x4, sq4, m4, q, k),
                 v8, r8, tol=0.0)
    xj4, sqj4, mj4 = pj.load_sharded_flat(ot, "mc/flat", pj.cpu_mesh(4))
    assert xj4.dtype == (jnp.bfloat16 if bf16 else jnp.float32)
    vj, rj = pj.sharded_flat_search(pj.cpu_mesh(4))(xj4, sqj4, mj4, q, k)
    _assert_same(vj, rj, v8, r8, atol=_norm_atol(x, q))


def test_sharded_ivf_persistence_reshard_and_across_packages(meshes):
    mj, mt = meshes
    x, store, ivf = _ivf_pair(400, 8, 12, 22)
    args = (ivf.export_centroids(), ivf.tiles(), store.data,
            store.active_mask())
    st8 = pt.shard_ivf_state(mt, *args)
    q = x[:6] + 0.01
    v8, r8 = pt.sharded_ivf_search(mt)(st8, q, 5, 12)
    ot = MemoryObjectStore()
    pt.save_sharded_ivf(ot, "mc/ivf", st8)
    for n_dev in (4, 2):
        mesh = pt.cpu_mesh(n_dev)
        st = pt.load_sharded_ivf(ot, "mc/ivf", mesh)
        assert st.n_clusters == 12
        v, r = pt.sharded_ivf_search(mesh)(st, q, 5, 12)
        np.testing.assert_array_equal(r.numpy(), r8.numpy())
        np.testing.assert_allclose(v.numpy(), v8.numpy(), rtol=TOL,
                                   atol=TOL)
    assert 17 not in r8.numpy()
    # across packages: the JAX save of the same state is byte for byte the
    # port's, and each package loads the other's at another shard count
    oj = StoreObjJ()
    pj.save_sharded_ivf(oj, "mc/ivf", pj.shard_ivf_state(mj, *args))
    keys = sorted(oj.list_keys("mc/ivf"))
    assert keys == sorted(ot.list_keys("mc/ivf"))
    for key in keys:
        assert oj.get(key) == ot.get(key), key
    st4 = pt.load_sharded_ivf(oj, "mc/ivf", pt.cpu_mesh(4))
    _assert_same(*pt.sharded_ivf_search(pt.cpu_mesh(4))(st4, q, 5, 12),
                 v8, r8, tol=0.0)
    # JAX's sums run in another order: near-zero distances (queries 0.01
    # off stored rows) differ by a few ulps of the norms
    atol = _norm_atol(x, q)
    sj4 = pj.load_sharded_ivf(ot, "mc/ivf", pj.cpu_mesh(4))
    vj, rj = pj.sharded_ivf_search(pj.cpu_mesh(4))(sj4, q, 5, 12)
    _assert_same(vj, rj, v8, r8, atol=atol)
    # a port load saved again at its own shard count loads in JAX too
    ot4 = MemoryObjectStore()
    pt.save_sharded_ivf(ot4, "p", st4)
    vj2, rj2 = pj.sharded_ivf_search(mj)(pj.load_sharded_ivf(ot4, "p", mj),
                                         q, 5, 12)
    _assert_same(vj2, rj2, v8, r8, atol=atol)


def test_sharded_manifest_forward_version_rejected(meshes):
    _, mt = meshes
    store = MemoryObjectStore()
    store.put("p/sharded_manifest.json", json.dumps(
        {"version": 99, "kind": "flat", "dim": 4, "n_rows": 8,
         "dtype": "float32", "shards": []}).encode())
    with pytest.raises(pt.ShardedPersistenceError):
        pt.load_sharded_flat(store, "p", mt)
    store.put("q/sharded_manifest.json", json.dumps(
        {"version": 1, "kind": "flat", "dim": 4, "n_rows": 8,
         "dtype": "float32", "shards": []}).encode())
    with pytest.raises(pt.ShardedPersistenceError):
        pt.load_sharded_ivf(store, "q", mt)


# ------------------------------------------------------------------ build


def _build(pkg, n_dev, vecs, seed=5, ef=32):
    hn = hnsw_j if pkg is pj else hnsw_t
    store = (VStoreJ if pkg is pj else VectorStore)(vecs.shape[1], **(
        {} if pkg is pj else {"device": "cpu"}))
    rows = store.add_batch([f"v{i}" for i in range(len(vecs))], vecs)
    hnsw = hn.HNSWIndex(store, hn.HNSWConfig(
        seed=seed, ef_construction=ef, bootstrap_threshold=128))
    pkg.ShardedBuilder(hnsw, pkg.cpu_mesh(n_dev)).insert_rows(
        rows, sub_batch=256)
    return hnsw


def test_sharded_build_mesh_size_invariant_and_matches_reference():
    """The same graph at 1, 2 and 8 shards (exact per-shard pools merge to
    the exact pool), and >= 99% of its rows identical to JAX's build of
    the same rows (ROADMAP C's link tolerance)."""
    vecs = _data(30, 1024, 16)
    ref = _build(pt, 1, vecs)
    for n_dev in (2, 8):
        got = _build(pt, n_dev, vecs)
        assert got.entry_point == ref.entry_point
        assert got.max_level == ref.max_level
        np.testing.assert_array_equal(got.levels, ref.levels)
        np.testing.assert_array_equal(got.nbrs0, ref.nbrs0)
        np.testing.assert_array_equal(got.nbrs_up, ref.nbrs_up)
    gj = _build(pj, 8, vecs)
    assert gj.entry_point == ref.entry_point
    np.testing.assert_array_equal(gj.levels, ref.levels)
    n = len(vecs)
    same = (gj.nbrs0[:n] == ref.nbrs0[:n]).all(1).mean()
    assert same >= 0.99, same


def test_sharded_build_recall():
    from fabstir_vectordb_tpu_torch.index.flat import FlatIndex

    vecs = _data(31, 1024, 16)
    hnsw = _build(pt, 8, vecs)
    rng = np.random.default_rng(32)
    q = vecs[:32] + 0.01 * rng.standard_normal((32, 16)).astype(np.float32)
    _, rows = hnsw.search_rows(q, 10, ef=64)
    _, exact = FlatIndex(hnsw.store).search_rows(q, 10)
    hits = sum(len(set(a) & set(b)) for a, b in zip(rows, exact))
    assert hits / (32 * 10) >= 0.95


def test_sharded_build_sees_rows_added_between_builds():
    dim = 16
    vecs = _data(33, 1024, dim)
    store = VectorStore(dim, initial_capacity=2048, device="cpu")
    rows1 = store.add_batch([f"a{i}" for i in range(768)], vecs[:768])
    hnsw = hnsw_t.HNSWIndex(store, hnsw_t.HNSWConfig(
        seed=5, ef_construction=32, bootstrap_threshold=128))
    builder = pt.ShardedBuilder(hnsw, pt.cpu_mesh(8))
    builder.insert_rows(rows1, sub_batch=256)
    rows2 = store.add_batch([f"b{i}" for i in range(256)], vecs[768:])
    assert store.capacity == 2048
    builder.insert_rows(rows2, sub_batch=256)
    q = vecs[768:784] + 0.001
    _, got = hnsw.search_rows(q, 1, ef=64)
    np.testing.assert_array_equal(got[:, 0], rows2[:16])


def test_set_rows_true_is_idempotent_and_ignores_outside_rows():
    mask = torch.zeros(10, dtype=torch.bool)
    rows = torch.tensor([3, 7, 3, 3, -1, 10], dtype=torch.int32)
    out = ingest_t._set_rows_true(mask, rows)
    assert out is mask
    assert mask.nonzero().flatten().tolist() == [3, 7]


@pytest.mark.parametrize("n,c,device_input", [(512, 12, True),
                                              (509, 7, False)])
def test_sharded_assign_clusters_matches_reference(n, c, device_input):
    x = _data(34, n)
    cents = _data(35, c)
    got = pt.sharded_assign_clusters(pt.cpu_mesh(8))(
        torch.from_numpy(x) if device_input else x, cents)
    assert got.shape == (n,) and got.dtype == torch.int32
    want = np.argmin(((x[:, None, :] - cents[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    gj = pj.sharded_assign_clusters(pj.cpu_mesh(8))(x, cents)
    np.testing.assert_array_equal(got.numpy(), np.asarray(gj))
    if not device_input:  # a device tensor that does not divide raises
        with pytest.raises(ValueError, match="divide"):
            pt.sharded_assign_clusters(pt.cpu_mesh(8))(torch.from_numpy(x),
                                                       cents)


# ------------------------------------------------------------------ meshes


def test_make_mesh_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.make_mesh(4)
    m = pt.make_mesh(4, device="cpu")
    assert isinstance(m, pt.LocalMesh) and m.shape == {"data": 4}
    assert pt.cpu_mesh(8).device.type == "cpu"
    with pytest.raises(ValueError):
        m.shard_slices(10, "data")
    with pytest.raises(RuntimeError, match="process group"):
        pt.DistMesh(device="cpu")


_GLOO = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, path, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])


def run():
    from fabstir_vectordb_tpu_torch import parallel as pt

    if world == 2:
        mesh = pt.make_mesh(2, device="cpu")
        query_axis = None
    else:  # rows over "data", queries over "query"
        mesh = pt.DistMesh(axes=("data", "query"), shape=(2, 2),
                           device="cpu")
        query_axis = "query"
    assert isinstance(mesh, pt.DistMesh) and mesh.rank == rank
    d = np.load(out + "/in.npz")
    v, r = pt.sharded_flat_search(mesh, query_axis=query_axis)(
        d["x"], d["x_sq"], d["mask"], d["q"], 10)
    c, e = pt.sharded_lloyd_step(mesh)(d["x"], d["mask"], d["init"])
    np.savez(f"{out}/rank{rank}.npz", v=v.numpy(), r=r.numpy(),
             c=c.numpy(), e=float(e))
    # no rank closes its groups while a peer is still in a collective on
    # them; the mesh (and the groups it holds) goes when run() returns, so
    # no group is left for the interpreter's exit to tear down
    dist.barrier()


dist.init_process_group("gloo", store=dist.FileStore(path, world),
                        rank=rank, world_size=world)
try:
    run()
finally:
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_dist_mesh_matches_local_mesh(tmp_path, world):
    """A DistMesh over a gloo group of CPU processes gives the flat exact
    search and a Lloyd step of the LocalMesh of the same shape, on every
    rank: two ranks on one row axis, and four on a 2 x 2 mesh of rows and
    queries (each axis's collectives on its own subgroup)."""
    n = 512
    x = _data(40, n)
    x_sq = (x * x).sum(1)
    mask = np.ones(n, bool)
    mask[[3, 300]] = False
    q = _data(41, 6)
    init = x[[0, 100, 200, 400]]
    np.savez(tmp_path / "in.npz", x=x, x_sq=x_sq, mask=mask, q=q, init=init)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO, str(r), str(world),
         str(tmp_path / "store"), str(tmp_path)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if world == 2:
        mesh, query_axis = pt.LocalMesh(2, device="cpu"), None
    else:
        mesh = pt.LocalMesh((2, 2), ("data", "query"), device="cpu")
        query_axis = "query"
    v, r = pt.sharded_flat_search(mesh, query_axis=query_axis)(
        x, x_sq, mask, q, 10)
    c, e = pt.sharded_lloyd_step(mesh)(x, mask, init)
    for rank in range(world):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_array_equal(got["r"], r.numpy())
        np.testing.assert_array_equal(got["v"], v.numpy())
        np.testing.assert_allclose(got["c"], c.numpy(), rtol=TOL, atol=TOL)
        assert abs(float(got["e"]) - float(e)) <= TOL * float(e)
