"""The port's reduced-rank regime against the JAX package's, on the CPU.

Kernel by kernel, the same numpy inputs go through the JAX package's jitted
programs and the port's wrappers, which take their plain versions on CPU
tensors: K14's stage-1 selection and projection, K2's f32 re-score, K8's
merge and oracle step, and K7's seeding steps. Then the whole regime on the
ladder corpora of ``tests/integration/test_regime_ladder.py``: a JAX hybrid
index carried into the port with ``convert.hybrid_from_numpy``, and the
JAX searcher's projection (mu, P) with ``convert.install_projection``, so
both packages project onto one basis (an eigensolver may flip the sign of a
column or rotate columns whose eigenvalues nearly tie; the port's own fit is
compared with the reference's by subspace).

Tolerances: squared distances of the same rows within rtol 1e-5 / atol
1e-4 where both sides take the norm expansion (f32 dot products summed in
another order), 1e-6 relative where both take the difference form; a
projected bf16 element may differ by one bf16 ulp where the f32 products
summed in another order straddle a rounding boundary.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.index import fused as fused_j  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridConfig as HybridConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridIndex as HybridJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import SearchConfig as SearchConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.ivf import IVFConfig as IVFConfigJ  # noqa: E402
from fabstir_vectordb_tpu.ops import distance as dist_j  # noqa: E402
from fabstir_vectordb_tpu.ops import kmeans as km_j  # noqa: E402
from fabstir_vectordb_tpu.ops import topk as topk_j  # noqa: E402
from fabstir_vectordb_tpu.utils import limits as limits_j  # noqa: E402
from fabstir_vectordb_tpu_torch import convert  # noqa: E402
from fabstir_vectordb_tpu_torch.index import fused as fused_t  # noqa: E402
from fabstir_vectordb_tpu_torch.index.hybrid import (  # noqa: E402
    HybridConfig, SearchConfig)
from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import kmeans as km_t  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import topk as topk_t  # noqa: E402
from fabstir_vectordb_tpu_torch.utils import limits as limits_t  # noqa: E402

NOW = 1_700_000_000.0
DAY = 86_400.0


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (nearest even), as exactly representable f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .to(torch.bfloat16).float().numpy()


def _tb(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .to(torch.bfloat16)


def _jb(a: np.ndarray):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_rows_and_dists(dj, rj, dt, rt, rtol, atol):
    dj, rj, dt, rt = (np.asarray(a) for a in (dj, rj, dt, rt))
    np.testing.assert_array_equal(rt, rj)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=rtol, atol=atol)


# ------------------------------------------------------------- kernels
def _eighths(rng, shape):
    """Multiples of 1/8 below 32 in magnitude: exact in bf16, and every
    product and sum of 32 of them is exact in f32, so a summation order
    cannot move a distance."""
    return (np.round(rng.standard_normal(shape) * 16) / 8).astype(np.float32)


@pytest.mark.parametrize("ov_k", [64, 300])
def test_stage1_select_matches_reference(ov_k):
    rng = np.random.default_rng(0)
    n, r, b = 3000, 24, 9
    xp = _eighths(rng, (n, r))
    # the norms are an input: a random fraction on each keeps distances
    # apart (no ties for the two selections to break apart), and the one
    # rounding that adds it is the same on both sides
    xp_sq = ((xp.astype(np.float64) ** 2).sum(1)
             + rng.random(n)).astype(np.float32)
    qp = _eighths(rng, (b, r))
    qp[0] += 1.0 / 1024  # one query whose bf16 rounding matters
    mask = rng.random(n) < 0.8
    vj, rj = fused_j.stage1_select_kernel(_jb(xp), jnp.asarray(xp_sq),
                                          jnp.asarray(mask), jnp.asarray(qp),
                                          ov_k)
    vt, rt = fused_t.stage1_select(_tb(xp), _t(xp_sq), _t(mask), _t(qp),
                                   ov_k)
    # approx_min_k (exact on the CPU) leaves two rows at one distance in
    # either order; the port orders them by row
    vj, rj = np.asarray(vj), np.asarray(rj)
    order = np.lexsort((rj, vj), axis=1)
    vj = np.take_along_axis(vj, order, 1)
    rj = np.take_along_axis(rj, order, 1)
    _assert_rows_and_dists(vj, rj, vt.numpy(), rt.numpy(), 1e-5, 1e-4)


def test_project_rows_matches_reference():
    rng = np.random.default_rng(1)
    n, d, r, lo = 700, 48, 20, 100
    blk = _bf16(rng.standard_normal((n, d)) + 0.5)
    mu = rng.standard_normal(d).astype(np.float32) * 0.1
    p = np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
    yj = fused_j._project_chunk(_jb(blk), jnp.asarray(mu), jnp.asarray(p))
    sq_j = np.asarray(fused_j._bf16_row_norms(yj))
    yj = np.asarray(yj.astype(jnp.float32))
    out = torch.zeros((n + lo, r), dtype=torch.bfloat16)
    out_sq = torch.zeros(n + lo)
    fused_t.project_rows(_tb(blk), _t(mu), _t(p), out, out_sq, lo)
    yt = out[lo:].float().numpy()
    assert (out[:lo].float() == 0).all() and (out_sq[:lo] == 0).all()
    same = yt == yj
    assert same.mean() >= 0.999, same.mean()
    # elsewhere one bf16 ulp (8 bits of mantissa) at most
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(yj), 1e-30))) - 7)
    assert (np.abs(yt - yj)[~same] <= ulp[~same] * 1.0001).all()
    rows = same.all(1)
    np.testing.assert_allclose(out_sq[lo:].numpy()[rows], sq_j[rows],
                               rtol=1e-6)
    qt = fused_t.project_queries(_t(blk[:5]), _t(mu), _t(p)).numpy()
    np.testing.assert_allclose(qt, (blk[:5] - mu) @ p, rtol=1e-5, atol=1e-5)


def test_pca_fit_and_projection_match_reference():
    """ops/projection.py: the leading directions up to sign, and the same
    projection of rows with one (mu, P)."""
    from fabstir_vectordb_tpu.ops import projection as proj_j
    from fabstir_vectordb_tpu_torch.ops import projection as proj_t

    rng = np.random.default_rng(9)
    scales = np.geomspace(4.0, 0.1, 40).astype(np.float32)  # spread apart
    x = (rng.standard_normal((3000, 40)) * scales + 0.5).astype(np.float32)
    mu_j, p_j = proj_j.fit_pca(x, 12)
    mu_t, p_t = proj_t.fit_pca(x, 12)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.abs(p_j.T @ p_t), np.eye(12), atol=1e-4)
    np.testing.assert_allclose(proj_t.project(x, mu_j, p_j),
                               proj_j.project(x, mu_j, p_j), rtol=1e-5,
                               atol=1e-5)


def test_rerank_f32_matches_reference():
    rng = np.random.default_rng(2)
    n, d, b, ov, m = 2000, 40, 7, 100, 32
    x = _bf16(rng.standard_normal((n, d)))
    q = rng.standard_normal((b, d)).astype(np.float32)
    rows = np.stack([rng.choice(n, ov, replace=False) for _ in range(b)]) \
        .astype(np.int32)
    rows[:, -10:] = -1  # a stage-1 pool's padding
    vj, rj = fused_j.rerank_f32_kernel(_jb(x), jnp.asarray(q),
                                       jnp.asarray(rows), m)
    vt, rt = fused_t.rerank_f32(_tb(x), _t(q), _t(rows), m)
    _assert_rows_and_dists(vj, rj, vt.numpy(), rt.numpy(), 1e-6, 0.0)


def test_merge_topk_matches_reference():
    rng = np.random.default_rng(3)
    b, ka, kb, k = 6, 11, 11, 11
    va = np.sort(rng.random((b, ka)).astype(np.float32), 1)
    vb = np.sort(rng.random((b, kb)).astype(np.float32), 1)
    ra = rng.integers(0, 1000, (b, ka)).astype(np.int32)
    rb = rng.integers(1000, 2000, (b, kb)).astype(np.int32)
    va[:2, 5:], ra[:2, 5:] = np.inf, -1
    vb[1:, 8:], rb[1:, 8:] = np.inf, -1
    mj = topk_j.merge_topk(*(jnp.asarray(a) for a in (va, ra, vb, rb)), k)
    mt = topk_t.merge_topk(*(_t(a) for a in (va, ra, vb, rb)), k)
    _assert_rows_and_dists(mj[0], mj[1], mt[0].numpy(), mt[1].numpy(), 1e-6,
                           0.0)


def test_oracle_step_matches_reference():
    rng = np.random.default_rng(4)
    d, p, k = 32, 12, 11
    q = rng.standard_normal((p, d)).astype(np.float32)
    vals_j = jnp.full((p, k), jnp.inf, jnp.float32)
    rows_j = jnp.full((p, k), -1, jnp.int32)
    vals_t = torch.full((p, k), float("inf"))
    rows_t = torch.full((p, k), -1, dtype=torch.int32)
    q = _eighths(rng, (p, d))
    for base, n in ((0, 500), (500, 500), (1000, 7)):  # a short last block
        blk = _eighths(rng, (n, d))
        m = rng.random(n) < 0.9
        vals_j, rows_j = fused_j._oracle_step(
            _jb(blk), jnp.asarray(m), jnp.asarray(q), jnp.int32(base),
            vals_j, rows_j, k)
        vals_t, rows_t = fused_t.oracle_step(_tb(blk), _t(m), _t(q), base,
                                             vals_t, rows_t, k)
        _assert_rows_and_dists(vals_j, rows_j, vals_t.numpy(),
                               rows_t.numpy(), 1e-5, 1e-4)


def test_kmeans_seeding_steps_match_reference():
    """K7's min-distance update and candidate counts with the same
    (injected) candidates as the reference's programs."""
    rng = np.random.default_rng(5)
    n, d = 2000, 32
    centers = rng.standard_normal((10, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 10, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    mask = rng.random(n) < 0.95
    cand = rng.choice(n, 41, replace=False).astype(np.int32)
    d2_0 = np.full(n, np.inf, np.float32)
    x_j = jnp.asarray(x)
    x_sq = dist_j.squared_norms(x_j)
    d2_j = jnp.asarray(d2_0)
    d2_t = _t(d2_0)
    for part in (cand[:1], cand[1:21], cand[21:]):  # first pick, two rounds
        dc = dist_j.pairwise_sq_l2(x_j[part], x_j, x_sq)
        d2_j = jnp.where(jnp.asarray(mask),
                         jnp.minimum(d2_j, jnp.min(dc, axis=0)), 0.0)
        d2_t = km_t.seed_min_update(_t(x), _t(mask), d2_t, _t(part))
        # |c|^2 - 2 c.x + |x|^2 in f32, the dot summed in another order:
        # 1e-5 of the norms' scale (~1,000 here) where it cancels to ~0
        np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j),
                                   rtol=1e-5, atol=1e-2)
    wj = km_j._scalable_weights(x_j, jnp.asarray(mask), x_j[cand])
    wt = km_t.seed_counts(_t(x), _t(mask), _t(cand))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    # the pick: l distinct eligible rows, none outside the mask or at d2 = 0
    u = torch.rand(n, generator=torch.Generator().manual_seed(0))
    picked = km_t.seed_pick(d2_t, _t(mask), u, 30).numpy()
    assert len(set(picked.tolist())) == 30
    assert mask[picked].all() and (d2_t.numpy()[picked] > 0).all()


# ------------------------------------------------------------- the regime
def _ladder(kind: str):
    """The two corpora of tests/integration/test_regime_ladder.py:
    ``ladder`` (32 dims, 3,000 rows, 12 centers, a third recent) and
    ``calibration`` (48 dims, 4,000 rows, 16 centers, all old)."""
    if kind == "ladder":
        rng = np.random.default_rng(11)
        dim, n, c, spread, train = 32, 3000, 12, 0.1, 2000
        centers = rng.standard_normal((c, dim)).astype(np.float32)
        vecs = (centers[rng.integers(0, c, n)]
                + spread * rng.standard_normal((n, dim)).astype(np.float32))
        ts = np.where(np.arange(n) % 3 == 0, NOW - DAY, NOW - 30 * DAY)
    else:
        rng = np.random.default_rng(7)
        dim, n, c, spread, train = 48, 4000, 16, 0.25, 2000
        centers = rng.standard_normal((c, dim)).astype(np.float32)
        vecs = (centers[rng.integers(0, c, n)]
                + spread * rng.standard_normal((n, dim)).astype(np.float32))
        ts = np.full(n, NOW - 30 * DAY)
    hj = HybridJ(dim, HybridConfigJ(
        ivf=IVFConfigJ(n_clusters=c, n_probe=c, seed=0), auto_migrate=False))
    hj.initialize(vecs[:train])
    hj.insert_batch([f"v{i}" for i in range(n)], vecs, ts, now=NOW)
    state = {
        "store": {"data": hj.store.data, "ids": hj.store.row_to_id,
                  "timestamps": hj.store.timestamps,
                  "deleted": hj.store.deleted},
        "hnsw": {"levels": hj.hnsw.levels, "nbrs0": hj.hnsw.nbrs0,
                 "nbrs_up": hj.hnsw.nbrs_up, "up_offset": hj.hnsw.up_offset,
                 "entry_point": hj.hnsw.entry_point,
                 "max_level": hj.hnsw.max_level,
                 "up_count": hj.hnsw.up_count},
        "ivf": {"centroids": hj.ivf.centroids,
                "assignments": hj.ivf.assignments},
    }
    ht = convert.hybrid_from_numpy(state, device="cpu", config=HybridConfig(
        ivf=IVFConfig(n_clusters=c, n_probe=c, seed=0), auto_migrate=False))
    return hj, ht, vecs


@pytest.fixture(scope="module")
def calibration_pair():
    return _ladder("calibration")


@pytest.fixture()
def reduced(monkeypatch):
    """Both packages above the flat threshold, knobs at their defaults."""
    for lim in (limits_j, limits_t):
        monkeypatch.setattr(lim, "FLAT_THRESHOLD", 0)
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "0")
    for var in ("FVDB_PCA_SERVE", "FVDB_PCA_RANK", "FVDB_PCA_OVERSAMPLE",
                "FVDB_PCA_RERANK", "FVDB_STAGE1_TRANSIENT_GB"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _exact(vecs, q, k):
    d = ((q[:, None, :].astype(np.float64) - vecs[None]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _recall(rows, exact):
    return np.mean([len(set(a) & set(b)) / len(b)
                    for a, b in zip(rows.tolist(), exact.tolist())])


@pytest.mark.parametrize("mode", ["device", "host"])
def test_reduced_regime_matches_reference(calibration_pair, reduced, mode):
    hj, ht, vecs = calibration_pair
    reduced.setenv("FVDB_PCA_RERANK", mode)
    k = 10
    rng = np.random.default_rng(8)
    q = vecs[rng.integers(0, len(vecs), 32)] + 0.02
    hj.fused._release_proj()
    dj, rj = hj.search_rows(q, k, config=SearchConfigJ(auto_migrate=False),
                            now=NOW)
    info_j = hj.fused.serving_info()
    proj = hj.fused._proj
    convert.install_projection(ht, {"mu": np.asarray(proj["mu"]),
                                    "p": np.asarray(proj["p"])})
    dt, rt = ht.search_rows(q, k, config=SearchConfig(auto_migrate=False),
                            now=NOW)
    info_t = ht.fused.serving_info()
    assert info_t["regime"] == "reduced-rank"
    assert info_t["pca_rerank"] == info_j["pca_rerank"] == mode
    assert info_t["pca_rank"] == info_j["pca_rank"]
    assert info_t["pca_oversample"] == info_j["pca_oversample"]
    assert abs(info_t["pca_calibrated_recall"]
               - info_j["pca_calibrated_recall"]) <= 0.01
    assert (rt == rj).all(1).mean() >= 0.99
    same = rt == rj
    np.testing.assert_allclose(dt[same], dj[same], rtol=1e-5, atol=1e-6)
    assert _recall(rt, _exact(vecs, q, k)) >= 0.95
    # the memory premise: no full-dim f32 mirror while reduced-rank serves
    assert ht.fused._dev is None and ht.store._mirror is None
    assert (ht.fused._proj["rerank_x"] is not None) == (mode == "device")


def test_port_fit_spans_the_reference_subspace(calibration_pair, reduced):
    hj, ht, vecs = calibration_pair
    q = vecs[:8] + 0.02
    hj.fused._release_proj()
    hj.search_rows(q, 10, config=SearchConfigJ(auto_migrate=False), now=NOW)
    ht.fused.install_fit(None, None)
    _, rt = ht.search_rows(q, 10, config=SearchConfig(auto_migrate=False),
                           now=NOW)
    pj = np.asarray(hj.fused._proj["p"])
    pt = ht.fused._proj["p"].numpy()
    assert pt.shape == pj.shape  # the same auto rank
    # the leading directions (well separated eigenvalues) agree up to sign
    lead = np.abs(pj[:, :8].T @ pt[:, :8])
    np.testing.assert_allclose(lead, np.eye(8), atol=1e-3)
    assert _recall(rt, _exact(vecs, q, 10)) >= 0.95


def test_pinned_knobs_skip_the_probe_pass(calibration_pair, reduced):
    hj, ht, vecs = calibration_pair
    reduced.setenv("FVDB_PCA_RANK", "16")
    reduced.setenv("FVDB_PCA_OVERSAMPLE", "16")
    steps = []
    real = fused_t.oracle_step
    reduced.setattr(fused_t, "oracle_step",
                    lambda *a, **kw: steps.append(1) or real(*a, **kw))
    ht.fused.install_fit(None, None)
    q = vecs[::200] + 0.02
    _, rt = ht.search_rows(q, 10, config=SearchConfig(auto_migrate=False),
                           now=NOW)
    info = ht.fused.serving_info()
    assert steps == []
    assert info["pca_calibrated_recall"] is None
    assert info["pca_rank"] == 16 and info["pca_oversample"] == 16
    assert _recall(rt, _exact(vecs, q, 10)) >= 0.9


def test_chunked_stage1_equals_unchunked(calibration_pair, reduced):
    _, ht, vecs = calibration_pair
    q = vecs[::97][:32] + 0.02
    cfg = SearchConfig(auto_migrate=False)
    d1, r1 = ht.search_rows(q, 10, config=cfg, now=NOW)
    calls = []
    real = fused_t.stage1_select
    reduced.setattr(fused_t, "stage1_select",
                    lambda *a, **kw: calls.append(a[3].shape[0])
                    or real(*a, **kw))
    # 4 queries' [B, N] distances a chunk
    n_rows = ht.fused._proj["n_rows"]
    reduced.setenv("FVDB_STAGE1_TRANSIENT_GB", str(4 * n_rows * 4 / 2**30))
    d2, r2 = ht.search_rows(q, 10, config=cfg, now=NOW)
    assert calls == [4] * 8
    np.testing.assert_array_equal(r2, r1)
    np.testing.assert_array_equal(d2, d1)


def test_ladder_mutations_and_regime_switches(reduced):
    """The ladder corpus: reduced-rank serves near-exact top-1, a row
    inserted after the build is found at once, a filter and deletes are
    exact, and each regime releases the others' device state."""
    _, ht, vecs = _ladder("ladder")
    cfg = SearchConfig(auto_migrate=False)
    q = vecs[::97] + 0.001
    expect = np.arange(len(vecs))[::97]
    _, rows = ht.search_rows(q, 1, config=cfg, now=NOW)
    assert (rows[:, 0] == expect).mean() >= 0.95
    assert ht.fused._proj is not None and ht.fused._dev is None
    assert ht.store._mirror is None
    assert ht.fused.serving_info()["regime"] == "reduced-rank"

    new = (vecs[0] + 0.0005).astype(np.float32)
    fresh = ht.insert_batch(["fresh"], new[None], np.full(1, NOW - DAY),
                            now=NOW)
    _, rows = ht.search_rows(new, 1, config=cfg, now=NOW)
    assert rows[0, 0] == fresh[0]

    allow = np.arange(ht.store.capacity) % 2 == 1
    _, rows = ht.search_rows(q, 10, config=cfg, extra_mask=allow, now=NOW)
    assert allow[rows[rows >= 0]].all()
    dead = rows[:, 0]
    ht.batch_delete([ht.store.id_of(int(r)) for r in dead])
    _, rows = ht.search_rows(q, 10, config=cfg, now=NOW)
    assert not np.isin(rows, dead).any()

    reduced.setenv("FVDB_PCA_SERVE", "0")
    _, rows = ht.search_rows(q, 1, config=cfg, now=NOW)
    assert ht.fused._proj is None and ht.fused._dev is not None
    assert ht.fused.serving_info()["regime"] == "pruned"

    reduced.delenv("FVDB_PCA_SERVE")
    reduced.setattr(limits_t, "FLAT_THRESHOLD", 10**9)
    reduced.delenv("FVDB_FLAT_THRESHOLD")
    assert ht.fused.serving_info()["regime"] == "flat-exact"
    _, rows = ht.search_rows(q, 1, config=cfg, now=NOW)
    assert ht.fused._proj is None and ht.fused._dev is not None
