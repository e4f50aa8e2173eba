"""The port's k-means++ / k-means training (K7 rest) and quantization ops
(K16) against the JAX package's, on the CPU at small sizes.

Inputs are made with numpy from a seed and go through the JAX function and
the port's plain version (a wrapper takes its plain version for CPU
tensors). The RNGs differ (``jax.random`` against ``torch.Generator``), so
training is compared from the same initial centroids (JAX's own
``kmeans_pp_init`` draws, handed to the port's Lloyd), and k-means++ by its
properties and its converged error. The kernels are held against the same
plain versions on the card by ``test_torch_kernels.py`` and
``chip_smoke.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.ops import kmeans as km_j  # noqa: E402
from fabstir_vectordb_tpu.ops import quantization as qz_j  # noqa: E402
from fabstir_vectordb_tpu_torch import convert  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import kmeans as km_t  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import quantization as qz_t  # noqa: E402

from .test_torch_kernels import (  # noqa: E402
    D, _clustered, _codes_equal_up_to_ties, _data)


def _t(a):
    return torch.from_numpy(np.array(a))


def _half_way(x, mins, scales):
    """Elements whose (x - min) / scale lies within 1e-6 of a half-way
    value, where a rounding in another order may land on either side."""
    v = (x.astype(np.float64) - mins[:, None]) / scales[:, None]
    return np.abs(v - np.floor(v) - 0.5) <= 1e-6 * np.maximum(np.abs(v), 1.0)


@pytest.mark.parametrize("seed,n,scale", [(30, 4096, 1.0), (31, 257, 40.0)])
def test_quantize_u8_matches_reference(seed, n, scale):
    x = _data(seed, n) * scale
    x[7] = 0.25  # a constant row: scale 1, codes 0
    cj, mj, sj = (np.asarray(a) for a in qz_j.quantize_u8(jnp.asarray(x)))
    ct, mt, st = (a.numpy() for a in qz_t.quantize_u8(_t(x)))
    assert ct.dtype == np.uint8 and ct.shape == x.shape
    np.testing.assert_array_equal(mt, mj)
    ulp = np.spacing(np.abs(sj))
    assert (np.abs(st - sj) <= ulp).all()
    diff = ct.astype(np.int16) - cj.astype(np.int16)
    assert np.abs(diff).max() <= 1
    assert _half_way(x, mj, sj)[diff != 0].all()
    assert st[7] == 1.0 and (ct[7] == 0).all()
    dj = np.asarray(qz_j.dequantize_u8(jnp.asarray(cj), jnp.asarray(mj),
                                       jnp.asarray(sj)))
    dt = qz_t.dequantize_u8(_t(cj), _t(mj), _t(sj)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=1e-6 * scale)
    assert dt[7].tolist() == [0.25] * D


def test_quantize_u8_error_is_half_a_step():
    x = _data(32, 1000) * 3.0
    codes, mins, scales = qz_t.quantize_u8(_t(x))
    back = qz_t.dequantize_u8(codes, mins, scales).numpy()
    # half a step, plus the decode's f32 rounding, which scales with the
    # row's min as well as with the element
    bound = scales.numpy()[:, None] / 2 + 1e-6 * (
        np.abs(x) + np.abs(mins.numpy())[:, None])
    assert (np.abs(back - x) <= bound).all()


def _codebook(seed, m, k, d=D):
    ds = d // m
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k, ds)).astype(np.float32)


@pytest.mark.parametrize("m,k", [(1, 16), (4, 256), (8, 16), (32, 64)])
def test_pq_encode_decode_match_reference(m, k):
    """The same codebook in both packages (through convert): codes equal
    but at near-ties (1-dim subspaces meet a few), decoded rows equal."""
    cents = _codebook(40 + m, m, k)
    x = _data(41, 3000)
    cb = convert.pq_codebook_from_numpy(cents, D, device="cpu")
    assert cb.n_subspaces == m and cb.n_codes == k and cb.dim == D
    cj = np.asarray(qz_j.pq_encode(jnp.asarray(cents), jnp.asarray(x)))
    ct = qz_t.pq_encode(cb.centroids, _t(x)).numpy()
    assert ct.dtype == np.uint8 and ct.shape == (3000, m)
    _codes_equal_up_to_ties(_t(x), _t(cents), _t(ct), _t(cj))
    assert (ct != cj).mean() <= 1e-4
    dj = np.asarray(qz_j.pq_decode(jnp.asarray(cents), jnp.asarray(ct)))
    dt = qz_t.pq_decode(cb.centroids, _t(ct)).numpy()
    np.testing.assert_array_equal(dt, dj)
    # re-encoding the decoded rows gives their codes back, but where two
    # codes of a 1-dim subspace lie closer than the expansion's rounding
    re = qz_t.pq_encode(cb.centroids, _t(dt)).numpy()
    _codes_equal_up_to_ties(_t(dt), _t(cents), _t(re), _t(ct))
    if m <= 8:
        np.testing.assert_array_equal(re, ct)


@pytest.mark.parametrize("m,k", [(1, 16), (4, 256), (8, 16), (32, 64)])
def test_pq_adc_matches_reference(m, k):
    cents = _codebook(50 + m, m, k)
    x, q = _data(51, 2048), _data(52, 37)
    cb = convert.pq_codebook_from_numpy(cents, D, device="cpu")
    codes = qz_t.pq_encode(cb.centroids, _t(x))
    tj = np.asarray(qz_j.pq_adc_table(jnp.asarray(cents), jnp.asarray(q)))
    tt = qz_t.pq_adc_table(cb.centroids, _t(q))
    assert tuple(tt.shape) == (37, m, k)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-5, atol=1e-5)
    aj = np.asarray(qz_j.pq_adc_distances(jnp.asarray(tj),
                                          jnp.asarray(codes.numpy())))
    at = qz_t.pq_adc_distances(_t(tj), codes).numpy()
    np.testing.assert_allclose(at, aj, rtol=1e-5, atol=1e-5)
    # the reference's own contract: ADC = the exact distance to the decoded
    # rows (f32 sums of ~64 against |q|^2 - 2 q.c + |c|^2 terms)
    dec = qz_t.pq_decode(cb.centroids, codes).numpy().astype(np.float64)
    exact = ((q[:, None, :].astype(np.float64) - dec[None]) ** 2).sum(-1)
    np.testing.assert_allclose(at, exact, rtol=1e-5, atol=1e-4)


def test_pq_adc_code_past_k_adds_zero():
    """The reference's one-hot product gives a code >= K no term; the port
    adds 0 for it, and decodes it as code K - 1 (the clamped gather)."""
    cents = _codebook(55, 4, 16)
    q = _data(56, 3)
    codes = np.full((5, 4), 3, np.uint8)
    codes[2, 1] = 200
    tj = np.asarray(qz_j.pq_adc_table(jnp.asarray(cents), jnp.asarray(q)))
    aj = np.asarray(qz_j.pq_adc_distances(jnp.asarray(tj),
                                          jnp.asarray(codes)))
    at = qz_t.pq_adc_distances(_t(tj), _t(codes)).numpy()
    np.testing.assert_allclose(at, aj, rtol=1e-6, atol=1e-6)
    dj = np.asarray(qz_j.pq_decode(jnp.asarray(cents), jnp.asarray(codes)))
    dt = qz_t.pq_decode(_t(cents), _t(codes)).numpy()
    np.testing.assert_array_equal(dt, dj)


def _jax_pp(seed, x, mask, c):
    return np.asarray(km_j.kmeans_pp_init(jax.random.PRNGKey(seed),
                                          jnp.asarray(x), jnp.asarray(mask),
                                          c))


@pytest.mark.parametrize("case", ["clusters", "masked_padding"])
def test_kmeans_train_matches_reference(case):
    """JAX's kmeans_train(key) against the port's Lloyd from JAX's own
    k-means++ draw for that key: the same init, so the same iterations,
    stop and centroids."""
    if case == "clusters":
        x = _clustered(60, 1500, 12, spread=0.8)
        mask = np.arange(1500) < 1480
        c, key = 12, 3
    else:  # tests/unit/test_ops.py's padding rows at 1e6, masked out
        x = np.concatenate([np.zeros((20, D), np.float32),
                            np.ones((20, D), np.float32) * 5,
                            np.full((24, D), 1e6, np.float32)])
        x[:40] += 0.1 * _data(61, 40)
        mask = np.arange(64) < 40
        c, key = 2, 1
    rj = km_j.kmeans_train(jax.random.PRNGKey(key), jnp.asarray(x),
                           jnp.asarray(mask), c)
    init = _jax_pp(key, x, mask, c)
    rt = km_t._lloyd_until(_t(x), _t(mask), _t(init))
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    np.testing.assert_allclose(rt.centroids.numpy(), np.asarray(rj.centroids),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rt.final_error, float(rj.final_error),
                               rtol=1e-5, atol=1e-4)
    assert np.abs(rt.centroids.numpy()).max() < 10.0 or case == "clusters"


def test_pq_train_matches_reference_from_its_inits():
    """pq_train's per-subspace training from JAX's per-subspace k-means++
    draws (split(key, M), then kmeans_pp_init each): codebooks within
    1e-5."""
    m, k, n = 4, 16, 1200
    x = _clustered(70, n, 20, spread=0.6)
    ds = D // m
    keys = jax.random.split(jax.random.PRNGKey(7), m)
    init = np.stack([np.asarray(km_j.kmeans_pp_init(
        keys[j], jnp.asarray(x[:, j * ds:(j + 1) * ds]),
        jnp.ones((n,), bool), k)) for j in range(m)])
    cj = np.asarray(qz_j.pq_train(jax.random.PRNGKey(7), x, n_subspaces=m,
                                  n_codes=k).centroids)
    cb = qz_t._pq_train_from(_t(x), _t(init), 25, k)
    assert cb.dim == D and tuple(cb.centroids.shape) == (m, k, ds)
    np.testing.assert_allclose(cb.centroids.numpy(), cj, rtol=1e-5,
                               atol=1e-5)


def test_pq_train_pads_with_code_zero_when_rows_are_few():
    x = _data(71, 10)
    g = torch.Generator().manual_seed(0)
    cb = qz_t.pq_train(g, _t(x), n_subspaces=4, n_codes=16)
    c = cb.centroids.numpy()
    assert c.shape == (4, 16, D // 4)
    np.testing.assert_array_equal(c[:, 10:], np.repeat(c[:, :1], 6, axis=1))
    cj = np.asarray(qz_j.pq_train(jax.random.PRNGKey(0), x, n_subspaces=4,
                                  n_codes=16).centroids)
    assert cj.shape == c.shape
    # with a code for each row, each row is its own centroid in both
    np.testing.assert_allclose(np.sort(c[:, :10], axis=1),
                               np.sort(cj[:, :10], axis=1), atol=1e-6)


def test_pq_train_rejects_a_dim_not_divisible():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        qz_t.pq_train(g, _data(72, 64), n_subspaces=5, device="cpu")
    with pytest.raises(ValueError):
        qz_j.pq_train(jax.random.PRNGKey(0), _data(72, 64), n_subspaces=5)


def test_pq_train_numpy_input_and_quality():
    """Numpy rows go to the device asked for; the port's codebook
    reconstructs as well as the reference's (RNGs differ)."""
    x = _clustered(73, 2000, 30, spread=0.5)
    g = torch.Generator().manual_seed(1)
    cb = qz_t.pq_train(g, x, n_subspaces=8, n_codes=32, device="cpu")
    assert cb.centroids.device.type == "cpu"
    dec = qz_t.pq_decode(cb.centroids, qz_t.pq_encode(cb.centroids, _t(x)))
    mse_t = float(((dec.numpy() - x) ** 2).mean())
    cbj = qz_j.pq_train(jax.random.PRNGKey(1), x, n_subspaces=8, n_codes=32)
    dj = np.asarray(qz_j.pq_decode(cbj.centroids, qz_j.pq_encode(
        cbj.centroids, jnp.asarray(x))))
    mse_j = float(((dj - x) ** 2).mean())
    assert mse_t <= 1.1 * mse_j


def test_kmeans_pp_init_never_picks_masked_rows():
    x = _data(80, 600)
    x[500:] = 1e4  # poisoned rows, masked out: they would win every draw
    mask = np.arange(600) < 500
    g = torch.Generator().manual_seed(2)
    rows = km_t._pp_rows(g, _t(x), _t(mask), 64)
    assert rows.dtype == torch.int32 and (rows >= 0).all()
    assert (rows < 500).all()
    assert len(set(rows.tolist())) == 64
    c = km_t.kmeans_pp_init(torch.Generator().manual_seed(2), _t(x),
                            _t(mask), 64)
    np.testing.assert_array_equal(c.numpy(), x[rows.numpy()])


def test_kmeans_pp_init_falls_back_to_uniform_on_duplicates():
    """Every d2 is 0 after the first pick: the fallback draws uniformly
    over the mask and still returns C rows."""
    x = np.tile(_data(81, 1), (50, 1))
    mask = np.arange(50) < 30
    rows = km_t._pp_rows(torch.Generator().manual_seed(3), _t(x), _t(mask), 8)
    assert ((rows >= 0) & (rows < 30)).all()
    assert len(set(rows.tolist())) > 1  # uniform, not always one row
    c = km_t.kmeans_pp_init(torch.Generator().manual_seed(3), _t(x),
                            _t(mask), 8)
    assert tuple(c.shape) == (8, D)
    np.testing.assert_array_equal(c.numpy(), np.repeat(x[:1], 8, 0))


def test_kmeans_pp_init_gives_c_rows_with_more_clusters_than_rows():
    x = _data(82, 12)
    mask = np.arange(12) < 9
    rows = km_t._pp_rows(torch.Generator().manual_seed(4), _t(x), _t(mask),
                         20)
    assert rows.shape[0] == 20 and ((rows >= 0) & (rows < 9)).all()
    assert set(rows.tolist()) == set(range(9))
    cj = _jax_pp(4, x, mask, 20)
    assert cj.shape == (20, D)


def test_kmeans_pp_init_refuses_an_empty_mask():
    with pytest.raises(ValueError):
        km_t.kmeans_pp_init(torch.Generator().manual_seed(0), _t(_data(83, 8)),
                            torch.zeros(8, dtype=torch.bool), 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_train_reaches_the_reference_error(seed):
    """The RNGs differ, so k-means++ is judged by the error it converges
    to: the port's kmeans_train within 1.5x JAX's."""
    x = _clustered(90 + seed, 2000, 24, spread=0.7)
    mask = np.arange(2000) < 1950
    rj = km_j.kmeans_train(jax.random.PRNGKey(seed), jnp.asarray(x),
                           jnp.asarray(mask), 24)
    rt = km_t.kmeans_train(torch.Generator().manual_seed(seed), _t(x),
                           _t(mask), 24)
    assert rt.final_error <= 1.5 * float(rj.final_error)
    assert tuple(rt.centroids.shape) == (24, D)


def test_seed_pick_fallback_leaves_eligible_draws_alone():
    """With an eligible row, the flag changes nothing (the kmeans|| pick is
    the same); with none, it draws over the mask (k-means++'s plain
    version)."""
    rng = np.random.default_rng(95)
    mask = _t(rng.random(500) < 0.8)
    d2 = _t(rng.random(500).astype(np.float32))
    u = _t(rng.random(500).astype(np.float32))
    for l in (1, 7):
        np.testing.assert_array_equal(
            km_t.seed_pick(d2, mask, u, l).numpy(),
            km_t.seed_pick_plain(d2, mask, u, l,
                                 unweighted_if_empty=True).numpy())
    zero = torch.zeros(500)
    assert (km_t.seed_pick(zero, mask, u, 1) == -1).all()
    want = km_t.seed_pick(None, mask, u, 1, weighted=False)
    got = km_t.seed_pick_plain(zero, mask, u, 1, unweighted_if_empty=True)
    assert torch.equal(got, want) and bool(mask[int(got)])


def test_pq_codebook_from_numpy_checks_the_dim():
    with pytest.raises(ValueError):
        convert.pq_codebook_from_numpy(_codebook(96, 4, 16), D + 4,
                                       device="cpu")
