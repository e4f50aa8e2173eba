"""The port's procedural corpus (K17) against the JAX package's, on the CPU.

The port reimplements ``jax.random``'s threefry2x32 streams in integer
torch ops (``fabstir_vectordb_tpu_torch/utils/synth.py``); here its keys,
bits and ``randint`` draws must equal JAX's exactly, its normal draws and
corpus rows must agree within a few f32 ulps, and the assignments of rows
to centers exactly. Then the source's contract as
``tests/unit/test_synth.py`` states it for the JAX package (the mirror's
ragged tail, the spot check, auto-detach), and the 10M tier's construction: a
corpus registered, filled, trained, assigned and attached, then served in
the reduced-rank regime, row for row against the JAX package.

Tolerances: a normal draw within 1e-6 relative (+1e-7), a corpus value
within 1e-6 absolute (a few f32 ulps at these magnitudes): XLA's CPU log1p
rounds differently from PyTorch's in a few draws in a hundred; erfinv's
polynomial and the scaled add are fused multiply-adds on both sides.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.index.hybrid import HybridConfig as HybridConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import HybridIndex as HybridJ  # noqa: E402
from fabstir_vectordb_tpu.index.hybrid import SearchConfig as SearchConfigJ  # noqa: E402
from fabstir_vectordb_tpu.index.ivf import IVFConfig as IVFConfigJ  # noqa: E402
from fabstir_vectordb_tpu.ops import kmeans as km_j  # noqa: E402
from fabstir_vectordb_tpu.utils import limits as limits_j  # noqa: E402
from fabstir_vectordb_tpu.utils.synth import SyntheticCorpusSource as SourceJ  # noqa: E402
from fabstir_vectordb_tpu_torch import convert  # noqa: E402
from fabstir_vectordb_tpu_torch.index.hybrid import (  # noqa: E402
    HybridConfig, HybridIndex, SearchConfig)
from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig  # noqa: E402
from fabstir_vectordb_tpu_torch.index.store import VectorStore  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import kmeans as km_t  # noqa: E402
from fabstir_vectordb_tpu_torch.utils import limits as limits_t  # noqa: E402
from fabstir_vectordb_tpu_torch.utils import synth as st  # noqa: E402

DIM = 32
VALUE_ATOL = 1e-6


def _src(block_rows=256, seed=7, dim=DIM, n_centers=16):
    return st.SyntheticCorpusSource(seed=seed, dim=dim, n_centers=n_centers,
                                    scale=0.35, block_rows=block_rows,
                                    device="cpu")


def _src_j(block_rows=256, seed=7, dim=DIM, n_centers=16):
    return SourceJ(seed=seed, dim=dim, n_centers=n_centers, scale=0.35,
                   block_rows=block_rows)


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _bf16_u16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _from_u16(u: np.ndarray) -> np.ndarray:
    return torch.from_numpy(u.view(np.int16)).view(torch.bfloat16) \
        .float().numpy()


# ------------------------------------------------------------- the streams
@pytest.mark.parametrize("seed,data", [(0, 0), (7, 3), (2**31 - 1, 12345),
                                       (0x5EED, 2**32 - 1)])
def test_key_fold_in_and_split_words_equal_jax(seed, data):
    kj = jax.random.key(seed)
    kt = st.prng_key(seed)
    assert _words(kj) == kt
    fj, ft = jax.random.fold_in(kj, data), st.fold_in(kt, data)
    assert _words(fj) == ft
    assert [_words(k) for k in jax.random.split(fj)] == st.split(ft)
    assert [_words(k) for k in jax.random.split(fj, 3)] == st.split(ft, 3)


@pytest.mark.parametrize("shape", [(7,), (33, 17), (4, 5, 6)])
def test_raw_bits_equal_jax(shape):
    kj = jax.random.fold_in(jax.random.key(11), 5)
    want = np.asarray(jax.random.bits(kj, shape, jnp.uint32))
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    got = st.random_bits(_words(kj), idx).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_bits_at_high_counters_use_both_words():
    # a block at an offset past 2**32 elements: the counter's high word
    kt = st.fold_in(st.prng_key(3), 1)
    c = torch.tensor([2**32 - 1, 2**32, 2**32 + 5], dtype=torch.int64)
    lo_only = st.random_bits(kt, c & 0xFFFFFFFF)
    got = st.random_bits(kt, c)
    assert got[0] == lo_only[0] and got[1] != lo_only[1]


@pytest.mark.parametrize("span", [1, 16, 4096, 1000, 100_003])
def test_randint_equals_jax(span):
    kj = jax.random.fold_in(jax.random.key(5), 2)
    want = np.asarray(jax.random.randint(kj, (5000,), 0, span))
    k_hi, k_lo = st.split(_words(kj))
    rows = torch.arange(5000, dtype=torch.int64)
    got = st.randint_from_bits(st.random_bits(k_hi, rows),
                               st.random_bits(k_lo, rows), span)
    np.testing.assert_array_equal(got.numpy(), want)


def test_normal_within_tolerance_of_jax():
    kj = jax.random.fold_in(jax.random.key(9), 4)
    want = np.asarray(jax.random.normal(kj, (300, 200), jnp.float32))
    idx = torch.arange(60_000, dtype=torch.int64).reshape(300, 200)
    got = st.normal_from_bits(st.random_bits(_words(kj), idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got == want).mean() > 0.95  # a few log1p roundings apart
    # the uniform in front of it is exact
    u = st.uniform_from_bits(st.random_bits(_words(kj), idx)).numpy()
    uj = np.asarray(jax.random.uniform(kj, (300, 200), jnp.float32,
                                       st._UNIFORM_LO, 1.0))
    np.testing.assert_array_equal(u, uj)


# -------------------------------------------------------------- the corpus
@pytest.mark.parametrize("dim,n_centers,block_rows,blk", [
    (DIM, 16, 256, 0), (DIM, 16, 256, 3), (384, 4096, 1024, 1)])
def test_host_block_matches_jax(dim, n_centers, block_rows, blk):
    s = _src(block_rows, seed=0, dim=dim, n_centers=n_centers)
    sj = _src_j(block_rows, seed=0, dim=dim, n_centers=n_centers)
    assert s.tag == sj.tag
    got, want = s.host_block(blk), sj.host_block(blk)
    assert got.shape == want.shape == (block_rows, dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL)
    # the assignment to centers is exact: JAX's randint names the same one
    key = jax.random.fold_in(jax.random.key(0), blk)
    _, ka = jax.random.split(key)
    want_a = np.asarray(jax.random.randint(ka, (block_rows,), 0, n_centers))
    _, got_a = s.rows(blk, range(0, block_rows))
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    with jax.default_device(jax.devices("cpu")[0]):
        cj = np.asarray(sj._centers())
    np.testing.assert_allclose(s.centers().numpy(), cj, rtol=1e-6, atol=1e-7)


def test_tag_identity():
    assert _src().tag == _src_j().tag
    assert _src(seed=8).tag != _src().tag
    assert _src(block_rows=128).tag != _src().tag


def test_row_subsets_equal_the_whole_block():
    s = _src()
    whole, assign = s.rows(2, range(0, 256))
    offs = np.array([255, 0, 17, 17, 128])
    part, part_a = s.rows(2, offs)
    np.testing.assert_array_equal(part.numpy(), whole.numpy()[offs])
    np.testing.assert_array_equal(part_a.numpy(), assign.numpy()[offs])
    np.testing.assert_array_equal(s.device_block(2).numpy(), whole.numpy())


def test_mirror_assembles_blocks_with_tail():
    s = _src(block_rows=256)
    n_rows = 256 * 2 + 100  # ragged tail block
    mirror = s.mirror_bf16(n_rows)
    assert mirror.dtype == torch.bfloat16 and mirror.shape == (n_rows, DIM)
    want = np.concatenate([s.host_block(0), s.host_block(1),
                           s.host_block(2)[:100]])
    np.testing.assert_array_equal(
        mirror.view(torch.int16).numpy().view(np.uint16), _bf16_u16(want))
    # and it is the JAX package's mirror
    mj = np.asarray(_src_j(block_rows=256).mirror_bf16(n_rows))
    np.testing.assert_array_equal(mirror.float().numpy(),
                                  mj.astype(np.float32))


class TestSpotCheck:
    def test_accepts_own_rows(self):
        s = _src()
        data = np.concatenate([s.host_block(0), s.host_block(1)])
        assert s.spot_check(data, np.array([0, 5, 255, 256, 400, 511]))

    def test_accepts_the_jax_packages_rows(self):
        sj = _src_j()
        data = np.concatenate([sj.host_block(0), sj.host_block(1)])
        assert _src().spot_check(data, np.arange(512))

    def test_rejects_foreign_corpus(self):
        s = _src()
        data = np.concatenate([s.host_block(0), s.host_block(1)])
        data[300] += 0.5  # beyond any rounding skew
        assert not s.spot_check(data, np.array([1, 300]))

    def _nudged(self, s, frac_div, by, seed):
        u16 = _bf16_u16(s.host_block(0)).copy()
        flat = u16.reshape(-1)
        idx = np.random.default_rng(seed).integers(0, flat.size,
                                                   flat.size // frac_div)
        flat[idx] += by
        return _from_u16(u16)

    def test_tolerates_one_ulp_bf16_skew(self):
        s = _src()
        assert s.spot_check(self._nudged(s, 200, 1, 0), np.arange(256))

    def test_rejects_multi_ulp_near_miss(self):
        s = _src()
        assert not s.spot_check(self._nudged(s, 500, 3, 1), np.arange(256))

    def test_fraction_budget_enforced(self):
        s = _src()
        assert not s.spot_check(self._nudged(s, 10, 1, 2), np.arange(256),
                                ulp_frac=0.02)

    def test_empty_rows_pass(self):
        assert _src().spot_check(np.zeros((4, DIM), np.float32),
                                 np.zeros(0, np.int64))


class TestAutoDetach:
    """A change of row data or row count detaches the source; a soft
    delete keeps it."""

    def _store_with_source(self):
        s = _src()
        store = VectorStore(DIM, device="cpu")
        blk = s.host_block(0)
        store.add_batch([f"v{i}" for i in range(blk.shape[0])], blk, 1.0)
        store.attach_device_source(s)
        assert store.device_source is s
        return store, blk

    def test_add_batch_detaches(self):
        store, blk = self._store_with_source()
        store.add_batch(["new"], blk[:1], 1.0)
        assert store.device_source is None

    def test_add_blocks_detaches(self):
        store, blk = self._store_with_source()
        rows = store.add_blocks(["a", "b", "c"], [blk[:2], blk[2:3]], 1.0)
        assert store.device_source is None
        np.testing.assert_array_equal(store.data[rows], blk[:3])

    def test_fill_rows_detaches(self):
        store, blk = self._store_with_source()
        version = store._version
        store.fill_rows(0, blk[:2] + 1.0)
        assert store.device_source is None and store._version == version
        store.fill_rows(0, blk[:2], bump_version=True)
        assert store._version == version + 1

    def test_register_rows_detaches(self):
        store, _ = self._store_with_source()
        rows = store.register_rows(["r1", "r2"], 1.0)
        assert store.device_source is None
        assert (store.data[rows] == 0).all() and store.row_of("r2") == rows[1]

    def test_vacuum_detaches_soft_delete_keeps(self):
        store, _ = self._store_with_source()
        store.mark_deleted("v3")
        assert store.device_source is not None  # masks, not row data
        store.vacuum()  # zeroes the row's data
        assert store.device_source is None

    def test_a_source_on_another_device_is_refused(self, monkeypatch):
        store = VectorStore(DIM, device="cpu")
        s = _src()
        monkeypatch.setattr(s, "device", torch.device("meta"))
        with pytest.raises(ValueError):
            store.attach_device_source(s)


# ------------------------------------------- the 10M tier's construction
N_ROWS, BLOCK = 1200, 512
NOW = 1_700_000_000.0


def _build(pkg: str):
    """bench.py's 10M-tier construction at 1,200 rows: register, fill block
    by block with each block's IVF assignment, train on the first rows,
    bump the version, spot-check and attach the source."""
    if pkg == "jax":
        src = _src_j(BLOCK)
        h = HybridJ(DIM, HybridConfigJ(
            ivf=IVFConfigJ(n_clusters=8, n_probe=4, train_size=512, seed=0),
            auto_migrate=False))
    else:
        src = _src(BLOCK)
        h = HybridIndex(DIM, HybridConfig(
            ivf=IVFConfig(n_clusters=8, n_probe=4, train_size=512, seed=0),
            auto_migrate=False), device="cpu")
    store = h.store
    store.register_rows([f"v{i}" for i in range(N_ROWS)],
                        timestamps=NOW - 30 * 86_400)
    pending = []
    for lo in range(0, N_ROWS, BLOCK):
        hi = min(lo + BLOCK, N_ROWS)
        block = src.host_block(lo // BLOCK)[: hi - lo]
        store.fill_rows(lo, block)
        if lo == 0:
            h.initialize(block)
        if pkg == "jax":
            a, _ = km_j.assign_clusters(jnp.asarray(block),
                                        jnp.asarray(h.ivf.centroids))
        else:
            a, _ = km_t.assign_clusters(torch.from_numpy(block),
                                        torch.from_numpy(h.ivf.centroids))
        pending.append((lo, hi, np.asarray(a, np.int32)))
    h.ivf._ensure_capacity()
    for lo, hi, a in pending:
        h.ivf.assignments[lo:hi] = a
    store.bump_version()
    h.ivf._version += 1
    chk = np.random.default_rng(909).integers(0, N_ROWS, 8)
    assert src.spot_check(store.data, chk)
    store.attach_device_source(src)
    return h, src


@pytest.fixture(scope="module")
def built_pair():
    return _build("jax"), _build("torch")


@pytest.fixture()
def pinned(monkeypatch):
    for lim in (limits_j, limits_t):
        monkeypatch.setattr(lim, "FLAT_THRESHOLD", 0)
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "0")
    monkeypatch.setenv("FVDB_PCA_RANK", "16")
    monkeypatch.setenv("FVDB_PCA_OVERSAMPLE", "8")
    monkeypatch.delenv("FVDB_PCA_SERVE", raising=False)
    return monkeypatch


@pytest.mark.parametrize("mode", ["device", "host"])
def test_scale_tier_matches_reference(built_pair, pinned, mode):
    (hj, sj), (ht, s) = built_pair
    pinned.setenv("FVDB_PCA_RERANK", mode)
    # both stores hold the corpus within the value tolerance, and every row
    # is an IVF member in both
    np.testing.assert_allclose(ht.store.data[:N_ROWS], hj.store.data[:N_ROWS],
                               rtol=0, atol=VALUE_ATOL)
    assert (ht.ivf.assignments[:N_ROWS] >= 0).all()
    assert (np.asarray(hj.ivf.assignments[:N_ROWS]) >= 0).all()
    rng = np.random.default_rng(3)
    q = hj.store.data[rng.integers(0, N_ROWS, 16)] \
        + 0.01 * rng.standard_normal((16, DIM)).astype(np.float32)
    hj.fused._release_proj()
    hj.store.attach_device_source(sj)
    dj, rj = hj.search_rows(q, 5, config=SearchConfigJ(auto_migrate=False),
                            now=NOW)
    proj = hj.fused._proj
    assert (proj["rerank_x"] is not None) == (mode == "device")
    convert.install_projection(ht, {"mu": np.asarray(proj["mu"]),
                                    "p": np.asarray(proj["p"])})
    ht.store.attach_device_source(s)
    calls = []
    real = s.rows
    pinned.setattr(s, "rows", lambda *a, **kw: calls.append(a[0])
                   or real(*a, **kw))
    dt, rt = ht.search_rows(q, 5, config=SearchConfig(auto_migrate=False),
                            now=NOW)
    info = ht.fused.serving_info()
    assert info["regime"] == "reduced-rank" and info["pca_rerank"] == mode
    assert info["pca_rank"] == 16 and info["pca_oversample"] == 8
    # the mirror (device mode) or the projection's blocks (host mode) came
    # from the source, one generation block a step
    assert sorted(set(calls)) == [0, 1, 2, 3]
    assert ht.store._mirror is None and ht.fused._dev is None
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)
    assert (rt[:, 0] >= 0).all()


def test_source_built_mirror_serves_as_the_uploaded_one(built_pair, pinned):
    _, (ht, s) = built_pair
    pinned.setenv("FVDB_PCA_RERANK", "device")
    ht.fused.install_fit(None, None)
    ht.store.attach_device_source(s)
    rng = np.random.default_rng(4)
    q = ht.store.data[rng.integers(0, N_ROWS, 16)] + 0.01
    cfg = SearchConfig(auto_migrate=False)
    d_src, r_src = ht.search_rows(q, 5, config=cfg, now=NOW)
    mirror_src = ht.fused._proj["rerank_x"][:N_ROWS].clone()
    ht.store.attach_device_source(None)
    ht.fused._release_proj()
    d_up, r_up = ht.search_rows(q, 5, config=cfg, now=NOW)
    assert torch.equal(ht.fused._proj["rerank_x"][:N_ROWS], mirror_src)
    np.testing.assert_array_equal(r_src, r_up)
    np.testing.assert_array_equal(d_src, d_up)
    _, rows = ht.search_rows(ht.store.data[37], 3, config=cfg, now=NOW)
    assert rows[0, 0] == 37
