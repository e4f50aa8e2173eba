"""K14's exact bf16 split of P and its three-product arithmetic, and
``chunked_topk`` at k <= 256 and k > 256, the port against the JAX package
on the CPU.

The split's three bf16 parts sum to P within 2^-24 |p| over normal f32
values. The tensor-core kernel's arithmetic, stated in plain PyTorch by
``fused.project_rows_split_plain`` (bf16 rows times each part, f32 sums,
mu . P taken off after each 64-dim window), rounds to the reference's
``_project_chunk`` (f32 on the CPU) in at least 99.9% of the bf16 elements,
the rest within one bf16 ulp or, where the product cancels to near 0, 1e-6
of the block's scale (the f32 sums' own spread), also for a block whose
mean lies three times the rows' spread off the origin. ``chunked_topk``
over a precomputed distance matrix gives the reference's rows and values
exactly.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.index import fused as fused_j  # noqa: E402
from fabstir_vectordb_tpu.ops import topk as topk_j  # noqa: E402
from fabstir_vectordb_tpu_torch.index import fused as fused_t  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import topk as topk_t  # noqa: E402

CPU = "cpu"


@pytest.mark.parametrize("lo_exp,hi_exp", [(-2, 2), (-100, -60), (60, 100)])
def test_split_reconstructs_p(lo_exp, hi_exp):
    """P_hi + P_mid + P_lo is P within 2^-24 |p|, at every scale of normal
    f32 values (each part is the round to nearest of what the ones before
    leave, so together they carry P's 24-bit mantissa)."""
    rng = np.random.default_rng(70)
    p = rng.standard_normal((32, 48)) * 2.0 ** rng.uniform(lo_exp, hi_exp,
                                                           (32, 48))
    p = p.astype(np.float32)
    hi, mid, lo = fused_t.split_bf16x3(torch.from_numpy(p))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = sum(t.double() for t in (hi, mid, lo)).numpy()
    err = np.abs(back - p.astype(np.float64))
    assert (err <= 2.0 ** -24 * np.abs(p)).all()
    # each part is a round to nearest: a part is no larger than the last
    # one's rounding step
    assert (hi.double().abs() >= mid.double().abs()).all()
    assert (mid.double().abs() >= lo.double().abs()).all()


@pytest.mark.parametrize("d,r,off", [(32, 16, 0.0), (96, 40, 1.0),
                                     (160, 48, 3.0)])
def test_three_product_formula_matches_reference(d, r, off):
    """The kernel's arithmetic over bf16 rows (D of one and of several
    64-dim windows, a partial last window) against the reference's
    _project_chunk: >= 99.9% of bf16 elements equal, the rest within one
    ulp; ``off`` moves
    the block's mean that many times the rows' spread off the origin, where
    x . P and mu . P cancel."""
    rng = np.random.default_rng(71)
    n = 4096
    x = rng.standard_normal((n, d)).astype(np.float32)
    x += off * rng.standard_normal(d).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)
    mu = xb.astype(np.float32).mean(0)
    spread = np.linalg.norm(xb.astype(np.float32) - mu, axis=1).mean()
    assert np.linalg.norm(mu) >= 0.8 * off * spread
    p = np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
    want = np.asarray(fused_j._project_chunk(
        jnp.asarray(xb), jnp.asarray(mu), jnp.asarray(p))).astype(np.float32)
    src = torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16)
    got = fused_t.project_rows_split_plain(
        src, torch.from_numpy(mu), torch.from_numpy(p)).to(torch.bfloat16)
    got = got.float().numpy()
    same = got == want
    assert same.mean() >= 0.999
    big = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    ulp = np.exp2(np.floor(np.log2(big)) - 7)
    slack = np.maximum(ulp * 1.0001, 1e-6 * np.abs(want).max())
    assert (np.abs(got - want)[~same] <= slack[~same]).all()


def _distances(seed, b, n, chunk):
    """Negative dot distances [B, n]; chunk 2 repeats some of chunk 0's
    distances exactly (the lower row must win each tie)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((b, 16)).astype(np.float32)
    dist = -(q @ x.T)
    cols = np.arange(0, chunk, 3)
    dist[:, 2 * chunk + cols] = dist[:, cols]
    return dist


@pytest.mark.parametrize("k,mask_kind,chunk", [
    pytest.param(k, m, 100, id=f"{k}-{m}")
    for k, m in ((7, None), (7, "rows"), (7, "queries"), (300, None),
                 (300, "rows"), (300, "queries"))] + [
    pytest.param(300, "rows", 512, id="300-rows-512"),
    pytest.param(1100, "queries", 512, id="1100-queries-512")])
def test_chunked_topk_matches_reference(k, mask_kind, chunk):
    """chunked_topk over four chunks of 100 or 512 rows, the port's against
    the reference's fori_loop: negative distances, equal distances in two
    chunks, a chunk whose every entry is masked out ([C] and [B, C] masks,
    or none), a running list still padded after the first chunk (most of it
    masked at k = 7; k = 300 > C pads it at any mask), k <= 256 and
    k > 256; at chunk 512, the last chunk's every fifth entry ties the
    running k-th (k = 300) and k = 1,100 exceeds the chunk."""
    b = 5
    n = 4 * chunk
    dist = _distances(72, b, n, chunk)
    rng = np.random.default_rng(73)
    if mask_kind == "queries":
        keep = rng.random((b, n)) < 0.6
        keep[:, :chunk] &= rng.random((b, chunk)) < 0.05
        keep[:, chunk:2 * chunk] = False  # a chunk all masked out
        keep[:, 2 * chunk:] |= np.tile(keep[:, :chunk], (1, 2))
    else:
        keep = rng.random(n) < 0.6
        keep[:chunk] &= rng.random(chunk) < 0.05
        keep[chunk:2 * chunk] = False
        keep[2 * chunk:3 * chunk] |= keep[:chunk]
    if mask_kind is None:
        keep = np.ones(n, bool)
    if chunk == 512 and k < chunk:  # ties with the running k-th, last chunk
        kth = np.sort(np.where(keep, dist, np.inf)[:, :3 * chunk], 1)[:, k - 1]
        tie = np.isfinite(kth)
        assert tie.any()
        cols = 3 * chunk + np.arange(0, chunk, 5)
        dist[np.ix_(tie, cols)] = kth[tie, None]

    def fn_j(start):  # start is traced inside the reference's fori_loop
        d = jax.lax.dynamic_slice_in_dim(jnp.asarray(dist), start, chunk, 1)
        m = jax.lax.dynamic_slice_in_dim(jnp.asarray(keep), start, chunk,
                                         keep.ndim - 1)
        return d, m

    def fn_t(start):
        d = torch.from_numpy(dist[:, start: start + chunk])
        if mask_kind is None:
            return d, None
        return d, torch.from_numpy(keep[..., start: start + chunk].copy())

    vj, rj = topk_j.chunked_topk(fn_j, n, chunk, k, b)()
    vt, rt = topk_t.chunked_topk(fn_t, n, chunk, k, b, device=CPU)()
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert (vt[:, 0] < 0).all()
    # the tie between chunks 0 and 2 goes to chunk 0's row, and no row of
    # the masked-out chunk enters
    full = np.where(keep, dist, np.inf)
    np.testing.assert_array_equal(
        rt.numpy(), np.where(
            np.isfinite(np.sort(full, 1, kind="stable")[:, :k]),
            np.argsort(full, axis=1, kind="stable")[:, :k], -1))
    if mask_kind is not None:
        assert not ((rt.numpy() >= chunk) & (rt.numpy() < 2 * chunk)).any()
        if k > chunk:  # fewer rows kept than k
            assert (rt.numpy() == -1).any()
