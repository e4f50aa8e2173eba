"""k-means++ in the port (K7): its counter-based draw and its plain version,
batched over PQ subspaces, on the CPU at small sizes.

The kernel (one launch for every pick of every subspace) draws its
uniforms from Philox4x32-10 and is held to the plain version here pick for
pick on the card by ``test_torch_kernels.py`` and ``chip_smoke.py``. Here:
the generator against Random123's known answers and as a distribution, the
batched plain version against one subspace at a time, its picks' rules
(mask, fallback, more clusters than rows), and its min-distance table
against the JAX package's update replayed over the same picks.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy import stats  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.ops.distance import pairwise_sq_l2  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import kmeans as km_t  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import quantization as qz_t  # noqa: E402

from .test_torch_kmeans_checks import pp_key_gaps  # noqa: E402
from .test_torch_kernels import _clustered, _data  # noqa: E402

SEED = 0x2F1E_0D3C_4B5A  # a 62-bit Philox key with both words set


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ctr,key,want", [
    # Random123's known-answer vectors for philox4x32-10
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_matches_known_answers(ctr, key, want):
    words = km_t.philox4x32_10(*(torch.tensor(c, dtype=torch.int64)
                                 for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_uniforms_depend_on_seed_subspace_step_and_row_alone():
    """The same (seed, subspace, step, row) gives the same u whatever the
    rows or the subspaces of the call."""
    u = km_t.pp_uniforms(SEED, range(8), 5, 1001)
    assert u.shape == (8, 1001) and u.dtype == torch.float32
    assert torch.equal(km_t.pp_uniforms(SEED, [3], 5, 37)[0], u[3, :37])
    assert torch.equal(km_t.pp_uniforms(SEED, [6, 2], 5, 4000)[:, :1001],
                       u[[6, 2]])
    # another step, subspace or seed draws anew
    assert not torch.equal(km_t.pp_uniforms(SEED, [3], 6, 1001)[0], u[3])
    assert not torch.equal(u[2], u[3])
    assert not torch.equal(km_t.pp_uniforms(SEED + 1, [3], 5, 1001)[0],
                           u[3])


def test_uniforms_lie_in_the_open_interval_on_the_grid():
    u = km_t.pp_uniforms(SEED, range(4), 0, 50_000).double()
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    # odd multiples of 2^-24, exact in f32
    k = u * 2.0 ** 24
    assert torch.equal(k, k.round()) and bool((k.long() % 2 == 1).all())


def test_uniforms_pass_a_chi_square_test():
    """10^6 draws (four subspaces of 250,000 rows) in 64 equal bins."""
    u = km_t.pp_uniforms(SEED, range(4), 9, 250_000).flatten()
    counts = torch.bincount((u * 64).long(), minlength=64).numpy()
    assert counts.sum() == 1_000_000 and counts.shape == (64,)
    assert stats.chisquare(counts).pvalue > 1e-3


@pytest.mark.parametrize("n_sub,ds,n,c", [(4, 12, 1500, 32), (8, 6, 701, 16),
                                          (3, 16, 257, 24)])
def test_batched_plain_equals_one_subspace_at_a_time(n_sub, ds, n, c):
    """M subspaces in one call pick what M calls of one subspace pick under
    the same seed (each with its subspace's draw)."""
    x = _t(_clustered(40 + n_sub, n, 10, d=n_sub * ds, spread=0.6))
    mask = torch.arange(n) < n - 9
    rows = km_t.kmeans_pp_rows_plain(SEED, x, mask, c, n_sub)
    assert rows.shape == (n_sub, c) and rows.dtype == torch.int32
    for m in range(n_sub):  # subspace m alone, on its slice of the draws
        xm = x[:, m * ds:(m + 1) * ds].contiguous()
        d2 = torch.full((n,), float("inf"))
        for i in range(c):
            if i > 0:
                d2 = km_t.seed_min_update_plain(xm, mask, d2,
                                                rows[m, i - 1:i])
            u = km_t.pp_uniforms(SEED, range(n_sub), i, n)[m]
            one = km_t.seed_pick_plain(d2, mask, u, 1, i > 0,
                                       unweighted_if_empty=True)
            assert int(one[0]) == int(rows[m, i])
    # the entry point is the plain version on CPU tensors
    assert torch.equal(km_t.kmeans_pp_rows(SEED, x, mask, c, n_sub), rows)


def test_batched_plain_never_picks_masked_rows():
    x = _data(41, 900, d=32)
    x[800:] = 1e4  # poisoned rows, masked out: they would win every draw
    mask = _t(np.arange(900) < 800)
    rows = km_t.kmeans_pp_rows_plain(SEED, _t(x), mask, 48, 4)
    assert ((rows >= 0) & (rows < 800)).all()
    for m in range(4):
        assert len(set(rows[m].tolist())) == 48


def test_batched_plain_takes_the_uniform_fallback_on_duplicates():
    """Every d2 is 0 after the first pick in each subspace: each later pick
    is uniform over the mask, drawn from that step's uniforms."""
    x = _t(np.tile(_data(42, 1, d=24), (60, 1)))
    mask = torch.arange(60) < 45
    rows = km_t.kmeans_pp_rows_plain(SEED, x, mask, 10, 3)
    assert ((rows >= 0) & (rows < 45)).all()
    for m in range(3):
        assert len(set(rows[m].tolist())) > 1
        for i in range(10):
            u = km_t.pp_uniforms(SEED, [m], i, 60)[0]
            want = int(torch.argmin(torch.where(
                mask, -torch.log(u.clamp(1e-20, 1.0 - 1e-7)),
                torch.tensor(float("inf")))))
            assert int(rows[m, i]) == want


def test_batched_plain_with_more_clusters_than_rows():
    x = _t(_data(43, 14, d=16))
    mask = torch.arange(14) < 11
    rows = km_t.kmeans_pp_rows_plain(SEED, x, mask, 25, 2)
    assert rows.shape == (2, 25) and ((rows >= 0) & (rows < 11)).all()
    for m in range(2):  # each row in the mask once, then repeats
        assert set(rows[m, :11].tolist()) == set(range(11))


@pytest.mark.parametrize("n_sub,ds", [(1, 48), (4, 8)])
def test_table_matches_the_reference_update_over_the_same_picks(n_sub, ds):
    """The port's picks replayed through the JAX package's update
    (pairwise_sq_l2 under jnp.where(mask, jnp.minimum(d2, new), 0)): the
    port's plain table equals it at every step within 1e-5 relative to the
    expansion's terms |x|^2 + |c|^2 (f32 products summed in another order
    carry their rounding; a row near a pick has d2 far below them), and
    every pick is a least key E / d2 of that table (a tie within 1e-5)."""
    n, c = 4096, 24
    x = _clustered(44, n, 30, d=n_sub * ds, spread=0.7)
    mask = np.arange(n) % 13 != 0
    xt, mt = _t(x), _t(mask)
    rows = km_t.kmeans_pp_rows_plain(SEED, xt, mt, c, n_sub)
    for m in range(n_sub):
        xm = x[:, m * ds:(m + 1) * ds]
        xj, mj = jnp.asarray(xm), jnp.asarray(mask)
        x_sq = (xj * xj).sum(-1)
        terms = np.asarray(x_sq) + float(np.asarray(x_sq)[mask].max())
        dj = jnp.full((n,), jnp.inf)
        dt = torch.full((n,), float("inf"))
        for i in range(1, c):
            p = int(rows[m, i - 1])
            new = pairwise_sq_l2(xj[p][None, :], xj, x_sq)[0]
            dj = jnp.where(mj, jnp.minimum(dj, new), 0.0)
            dt = km_t.seed_min_update_plain(_t(xm), mt, dt, rows[m, i - 1:i])
            assert (np.abs(dt.numpy() - np.asarray(dj)) <= 1e-5 * terms).all()
            assert (dt.numpy()[~mask] == 0).all()
            u = km_t.pp_uniforms(SEED, [m], i, n)[0].numpy().astype(np.float64)
            e = -np.log(np.clip(u, 1e-20, 1.0 - 1e-7))
            d = np.asarray(dj, np.float64)
            ok = mask & (d > 0)
            key = np.where(ok, e / np.maximum(d, 1e-30), np.inf)
            got = key[int(rows[m, i])]
            assert ok[int(rows[m, i])]
            assert got <= key.min() * (1 + 1e-5)


def test_key_gaps_name_the_first_pick_apart():
    n = 1200
    x = _t(_clustered(45, n, 12, d=16, spread=0.5))
    mask = torch.ones(n, dtype=torch.bool)
    rows = km_t.kmeans_pp_rows_plain(SEED, x, mask, 12, 2)
    assert pp_key_gaps(SEED, x, mask, rows, rows, 2) == []
    other = rows.clone()
    other[1, 5] = (int(rows[1, 5]) + 1) % n
    (m, i, gap), = pp_key_gaps(SEED, x, mask, other, rows, 2)
    assert (m, i) == (1, 5) and gap > 1e-6


def test_pq_seeds_are_rows_of_each_subspace():
    x = _t(_data(46, 500, d=32))
    g = torch.Generator().manual_seed(9)
    init = qz_t.pq_seeds(g, x, 4, 16)
    assert init.shape == (4, 16, 8)
    seed = km_t.pp_seed(torch.Generator().manual_seed(9))
    rows = km_t.kmeans_pp_rows(seed, x, torch.ones(500, dtype=torch.bool),
                               16, 4)
    for m in range(4):
        assert torch.equal(init[m], x[rows[m].long(), m * 8:(m + 1) * 8])


def test_kmeans_pp_rows_checks_its_arguments():
    x = _t(_data(47, 40, d=12))
    mask = torch.ones(40, dtype=torch.bool)
    with pytest.raises(ValueError):
        km_t.kmeans_pp_rows(SEED, x, mask, 4, 5)  # 12 dims, 5 subspaces
    with pytest.raises(ValueError):
        km_t.kmeans_pp_rows(SEED, x, mask, 0)
    with pytest.raises(ValueError):
        km_t.kmeans_pp_rows(SEED, x, torch.zeros(40, dtype=torch.bool), 4)
