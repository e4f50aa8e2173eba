"""The tensor-core pass over bf16 rows with the query rounded
(``csrc/bf16_tile.cuh``): its launch plan and its route, on the CPU, and
the serving mirror's K1 and K9 against the JAX package at the shapes its
route decides by (one query, a D that is not a multiple of 8).

The plan and the route are host code that every launch on the card reads;
the kernel itself is held against its plain version on the card by
``test_torch_kernels.py`` and ``chip_smoke.py``.
"""
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.index import fused as fused_j  # noqa: E402
from fabstir_vectordb_tpu.ops import distance as dist_j  # noqa: E402
from fabstir_vectordb_tpu.ops import topk as topk_j  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import topk as topk_t  # noqa: E402

from .test_torch_kernels import _assert_topk_equal  # noqa: E402

SMEM_PER_BLOCK = 232_448  # an H100 block's shared memory, static included
STATIC_BARRIERS = 1024  # the kernel's full and empty barriers, padded to
# the 1,024-byte alignment of its dynamic array


@pytest.mark.parametrize("mode", topk_t.TILE_MODES)
@pytest.mark.parametrize("d", [32, 36, 384, 768])
@pytest.mark.parametrize("k", [1, 16, 128, 256])
@pytest.mark.parametrize("b", [1, 7, 8, 9, 128, 129, 65_535])
def test_tile_plan_fits_and_covers_every_query(b, k, d, mode):
    """Every plan fits a block's shared memory with its ring, staged
    queries and lists; its query width is a multiple of 8 up to 256 (the
    wgmma's N); its tiles take every query once; D that TMA cannot read
    (not a multiple of 8) has no plan."""
    plan = topk_t.tile_plan(b, k, d, mode)
    if d % 8:
        assert plan is None
        return
    assert plan is not None
    assert plan.smem + STATIC_BARRIERS <= SMEM_PER_BLOCK
    assert plan.smem == topk_t._tc_smem(plan.width, d, mode,
                                        k if mode == "lists" else 0,
                                        plan.stages)
    assert plan.width % 8 == 0 and 8 <= plan.width <= 256
    assert 2 <= plan.stages <= 8
    assert plan.width <= (64 if mode == "bins" else 128)
    starts = range(0, plan.tiles * plan.width, plan.width)
    covered = np.zeros(b, np.int64)
    for lo in starts:
        covered[lo:lo + plan.width] += 1
    assert (covered == 1).all() and plan.tiles == math.ceil(b / plan.width)
    # no wider than the batch needs: one query pads to 8, not to 32
    cap = 64 if mode == "bins" else 128
    assert plan.width <= next(w for w in (8, 32, 64, 128) if w >= min(b, cap))


def test_tile_plan_widths_at_the_serving_shapes():
    """At D = 384 the lists and the staged queries share the block: 128
    queries a block at small k, 64 at k = 128, 32 at k = 256; one query
    pads to 8."""
    assert topk_t.tile_plan(128, 16, 384, "lists").width == 128
    assert topk_t.tile_plan(128, 128, 384, "lists").width == 64
    assert topk_t.tile_plan(128, 256, 384, "lists").width == 32
    assert topk_t.tile_plan(1, 128, 384, "lists").width == 8
    assert topk_t.tile_plan(128, 1024, 384, "dump").width == 128
    assert topk_t.tile_plan(128, 128, 384, "bins").width == 64
    with pytest.raises(ValueError):
        topk_t.tile_plan(8, 257, 384, "lists")


@pytest.mark.parametrize("d", [8, 36, 100, 384, 768, 2048, 2052, 8192,
                               8200])
@pytest.mark.parametrize("dtype,round_query", [
    (torch.bfloat16, True), (torch.bfloat16, False), (torch.float32, False)])
def test_tile_route_is_the_one_the_kernel_note_states(dtype, round_query, d):
    """csrc/bf16_tile.cuh's note: bf16 rows with the query rounded at
    D % 8 == 0 up to 8,192 take one bf16 product ("wgmma"); f32 rows at
    D % 4 == 0 and bf16 rows with an f32 query at D % 8 == 0, up to 2,048,
    take the split routes ("tf32x3", "bf16x3"); every other D the FMA pass
    (l2_tile.cuh). A route has a plan exactly where it takes D."""
    if dtype == torch.bfloat16 and round_query:
        want = "wgmma" if d % 8 == 0 and d <= 8192 else "fma"
    elif dtype == torch.float32:
        want = "tf32x3" if d % 4 == 0 and d <= 2048 else "fma"
    else:
        want = "bf16x3" if d % 8 == 0 and d <= 2048 else "fma"
    assert topk_t.tile_route(dtype, round_query, d) == want
    assert (topk_t.tile_plan(4, 16, d, "lists") is None) == \
        (topk_t.tile_route(torch.bfloat16, True, d) == "fma")
    for route in ("tf32x3", "bf16x3"):
        rdt = torch.float32 if route == "tf32x3" else torch.bfloat16
        assert (topk_t.tile_plan(4, 16, d, "lists", route) is None) == \
            (topk_t.tile_route(rdt, False, d) != route)


@pytest.mark.parametrize("route", ["tf32x3", "bf16x3"])
@pytest.mark.parametrize("mode", ["lists", "dump", "filter"])
@pytest.mark.parametrize("d", [4, 32, 36, 384, 2048])
@pytest.mark.parametrize("k,b", [(1, 1), (16, 128), (200, 1024),
                                 (256, 129)])
def test_split_route_plans_fit_their_parts(route, mode, d, k, b):
    """The split routes stage two (TF32) or three (bf16) parts of each
    query, 128 bytes a step a part (32 f32 or 64 bf16 dims): every plan
    fits a block with at least two ring stages, at most 64 queries wide
    (32 for TF32), and its bytes are the kernel's; the TF32 route takes
    the filter mode besides lists and dump (its staging: 64 keys a query
    and their counts) and the bins mode (K9 on f32 rows, at most 32
    queries wide), the bf16 one neither."""
    if mode == "filter" and route == "bf16x3":
        with pytest.raises(ValueError):
            topk_t.tile_plan(b, k, d, mode, route)
        return
    plan = topk_t.tile_plan(b, k, d, mode, route)
    rdt = torch.float32 if route == "tf32x3" else torch.bfloat16
    if topk_t.tile_route(rdt, False, d) != route:
        assert plan is None
        return
    parts, step = (2, 32) if route == "tf32x3" else (3, 64)
    kk = k if mode == "lists" else 0
    assert plan.width <= (32 if route == "tf32x3" else 64)
    assert plan.stages >= 2
    assert plan.smem + STATIC_BARRIERS <= SMEM_PER_BLOCK
    assert plan.smem == (1024 + plan.stages * 16384
                         + math.ceil(d / step) * plan.width * 128 * parts
                         + plan.width * 4
                         + (plan.width * (8 * kk + 8 * 32 + 16)
                            if mode == "lists" else 0)
                         + (plan.width * (8 * 64 + 16)
                            if mode == "filter" else 0))
    assert plan.tiles == math.ceil(b / plan.width)
    if route == "bf16x3":  # the TF32 route takes BINS (K9 on f32 rows)
        with pytest.raises(ValueError):
            topk_t.tile_plan(b, k, d, "bins", route)
    else:
        bins = topk_t.tile_plan(b, k, d, "bins", route)
        assert bins.width <= 32 and bins.stages >= 2
        assert bins.smem == topk_t._tc_smem(bins.width, d, "bins", 0,
                                            bins.stages, route)


@pytest.mark.parametrize("d", [4, 36, 100, 384, 768, 2048, 2052])
@pytest.mark.parametrize("ov_k", [16, 128, 1024])
@pytest.mark.parametrize("b", [1, 7, 8, 9, 33, 128, 129])
def test_tf32_bins_plan_fits_and_covers_every_query(b, ov_k, d):
    """K9 on f32 rows (bf16_tile.cuh's BINS mode on the TF32 route): a plan
    exactly where f32 rows take the route (D % 4 == 0 up to 2,048), at
    most 32 queries wide (the running minima and the big products' four
    accumulators take registers a query), no wider than the batch needs,
    at least two ring stages; its bytes are the kernel's (the ring, the two
    staged parts of each query, |q|^2; nothing by ov_k) and fit a block;
    its tiles take every query once."""
    plan = topk_t.tile_plan(b, ov_k, d, "bins", "tf32x3")
    if topk_t.tile_route(torch.float32, False, d) != "tf32x3":
        assert plan is None
        return
    assert plan.width in (8, 32)
    assert plan.width <= next(w for w in (8, 32) if w >= min(b, 32))
    assert 2 <= plan.stages <= 8
    assert plan.smem == (1024 + plan.stages * 16384
                         + math.ceil(d / 32) * plan.width * 128 * 2
                         + plan.width * 4)
    assert plan.smem + STATIC_BARRIERS <= SMEM_PER_BLOCK
    assert plan.tiles == math.ceil(b / plan.width)


def test_tf32_bins_widths_at_the_turbo_shapes():
    """The turbo pool over 384-d f32 rows: one query pads to 8 columns, a
    batch of 128 takes 32 a block; both keep the ring's eight stages."""
    one = topk_t.tile_plan(1, 128, 384, "bins", "tf32x3")
    batch = topk_t.tile_plan(128, 128, 384, "bins", "tf32x3")
    assert (one.width, one.stages, one.tiles) == (8, 8, 1)
    assert (batch.width, batch.stages, batch.tiles) == (32, 8, 4)


@pytest.mark.parametrize("rounds,tiles", [(424, 20), (424, 80), (424, 40),
                                          (1, 20), (5, 80), (4096, 7),
                                          (2000, 133)])
def test_round_waves_fill_the_last_wave(rounds, tiles):
    """K9's round ranges on the TF32 route, 132 SMs: the ranges cover the
    rounds once, each of the rounds a range takes but the last; the blocks
    (tiles x ranges) fill their last wave to within 2% of the best that
    any count of ranges of >= 8 rounds reaches, with the fewest such
    ranges; at the turbo shape (424 rounds, 80 or 20 tiles) >= 98%."""
    z, i_per = topk_t._round_waves(rounds, tiles, 132)
    assert (z - 1) * i_per < rounds <= z * i_per

    def fill(zz):
        ip = math.ceil(rounds / zz)
        blocks = tiles * math.ceil(rounds / ip)
        return blocks / (math.ceil(blocks / 132) * 132)

    zs = range(1, max(1, rounds // 8) + 1)
    best = max(fill(zz) for zz in zs)
    assert fill(z) >= best - 0.02
    assert all(fill(zz) < best - 0.02 for zz in zs if zz < z)
    if rounds == 424 and tiles in (20, 80):
        assert fill(z) >= 0.98


def test_split_route_widths_at_k3_and_k1_shapes():
    """f32 rows at D = 384 stage 3 KB a query: K3's link candidates (k =
    200) and K1's search (k = 16) take 32 queries a block, as every f32
    plan at most does (four accumulators of big products a query); bf16
    rows with an f32 query at D = 32 take 64."""
    assert topk_t.tile_plan(1024, 200, 384, "lists", "tf32x3").width == 32
    assert topk_t.tile_plan(128, 16, 384, "lists", "tf32x3").width == 32
    assert topk_t.tile_plan(128, 16, 32, "lists", "tf32x3").width == 32
    assert topk_t.tile_plan(128, 16, 32, "lists", "bf16x3").width == 64
    assert topk_t.tile_plan(1024, 200, 384, "lists", "bf16x3").width == 32
    assert topk_t.tile_plan(1, 16, 384, "lists", "tf32x3").width == 8


def _mirror(seed, n, d, b):
    """Rows rounded to bf16 with the f32 rows' norms, a query batch and a
    90% row mask, made with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(n) < 0.9
    xb = torch.from_numpy(x).to(torch.bfloat16)
    return x, xb, (x * x).sum(1), q, mask


@pytest.mark.parametrize("b,d,k", [(1, 36, 16), (1, 48, 128), (3, 36, 300),
                                   (1, 64, 1)])
def test_rounded_query_search_matches_flat_search_kernel(b, d, k):
    """K1 on a bf16 mirror (the query rounded in the product, f32 host
    norms) against the reference's flat_search_kernel on bf16 rows, at one
    query and at a D that is not a multiple of 8 (the FMA route on the
    card) as at one that is (the tensor cores)."""
    x, xb, x_sq, q, mask = _mirror(31, 2000, d, b)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    vj, rj = fused_j.flat_search_kernel(xj, jnp.asarray(x_sq),
                                        jnp.asarray(mask), jnp.asarray(q), k)
    vt, rt = topk_t.l2_topk(xb, torch.from_numpy(x_sq),
                            torch.from_numpy(mask), torch.from_numpy(q), k,
                            round_query=True)
    _assert_topk_equal(vj, rj, vt.numpy(), rt.numpy())


@pytest.mark.parametrize("b,d,n,ov_k", [(1, 36, 2000, 256),
                                        (1, 48, 2000, 128),
                                        (2, 36, 1000, 64)])
def test_rounded_query_pool_matches_masked_approx_topk_where_exact(b, d, n,
                                                                   ov_k):
    """K9 on a bf16 mirror where its bins M reach N (the pool is exact):
    the reference's masked_approx_topk over its bf16 distances
    (approx_min_k is exact on the CPU), at one query and at D = 36."""
    x, xb, x_sq, q, mask = _mirror(32, n, d, b)
    assert topk_t.approx_bins(n, ov_k) >= n
    dj = dist_j.pairwise_sq_l2(jnp.asarray(q),
                               jnp.asarray(x).astype(jnp.bfloat16),
                               x_sq=jnp.asarray(x_sq),
                               compute_dtype=jnp.bfloat16)
    vj, rj = topk_j.masked_approx_topk(dj, jnp.asarray(mask), ov_k)
    vt, rt = topk_t.approx_topk(xb, torch.from_numpy(x_sq),
                                torch.from_numpy(mask), torch.from_numpy(q),
                                ov_k, round_query=True)
    _assert_topk_equal(vj, rj, vt.numpy(), rt.numpy())
    assert (rt.numpy()[:, int(mask.sum()):] == -1).all()

