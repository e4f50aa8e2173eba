"""K14's stage 1 on the tensor cores, its host side on the CPU: the filter
route's plan (``ops.topk.filter_plan``: the sample's tile stride, the
survivor capacity, the scratch a query; K1 on f32 rows takes it too),
the selection that the filter route makes (a bar from a sample of the
mirror's tiles, the survivors under it, their ov_k smallest) stated in
plain PyTorch and held to the reference's stage1_select_kernel and to the
port's plain version, and the launch sizes that the wrapper and the
reduced-rank dispatch take from the plan.

The kernel itself is held against its plain version on the card by
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
from fabstir_vectordb_tpu_torch.index import fused as fused_t  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import topk as topk_t  # noqa: E402

from .test_torch_kernels import _assert_topk_equal  # noqa: E402


@pytest.mark.parametrize("n,ov_k", [(1, 1), (4096, 64), (4096, 4096),
                                    (200_003, 256), (1_048_576, 1024),
                                    (10_485_760, 2048), (10_485_760, 64),
                                    (50_000, 8192)])
def test_filter_plan_balances_the_sample_and_the_survivors(n, ov_k):
    """The stride is the power of two at most sqrt(N / ov_k), none below
    4; the sample holds every taken tile's 128 rows; the buffer holds 4
    stride ov_k survivors (every row without a sample) and the expected
    survivors, stride ov_k, with room, and besides them a reservation of
    128 slots a row slice (132 slices unless told); a query's bytes are
    both buffers, its pool and counts, and past 4,096 the finishing
    lists."""
    p = topk_t.filter_plan(n, ov_k)
    tiles = math.ceil(n / 128)
    s = 2 ** math.floor(math.log2(max(1.0, math.sqrt(n / ov_k))))
    assert p.chunk == 128
    if s < 4:
        assert (p.tstride, p.cap_s, p.cap) == (0, 0, tiles * 128)
    else:
        assert p.tstride == s and p.cap_s == math.ceil(tiles / s) * 128
        assert p.cap == min(tiles * 128, 4 * s * ov_k) + 132 * 128
        assert p.cap - 132 * 128 >= min(tiles * 128, 2 * s * ov_k)
        assert topk_t.filter_plan(n, ov_k, 7).cap == p.cap - 125 * 128
    kc = min(ov_k, p.cap)
    lists = 8 * 2 ** math.ceil(math.log2(kc)) if kc > 4096 else 0
    assert p.query_bytes == 8 * (p.cap_s + p.cap) + 8 * ov_k + 8 + lists


def test_filter_plan_at_stage1s_serving_shapes():
    """At bench.py's 10M tier a query takes 5.7 MB, so 128 of them fit the
    2 GiB the dispatch passes there in one launch (the [B, N] buffer took
    41.9 MB a query: 25 a launch under 1 GiB); at 1M and ov_k = 1,024,
    1.5 MB."""
    p = topk_t.filter_plan(10_485_760, 2048)
    assert (p.tstride, p.cap_s, p.cap) == (64, 163_840, 524_288 + 16_896)
    assert 128 * p.query_bytes <= 2 << 30 < 128 * 4 * 10_485_760
    assert fused_t.stage1_query_bytes(10_485_760, 192, 2048, "cuda") \
        == p.query_bytes
    # the FMA route (r % 8 != 0) and the plain version hold [B, N] f32
    assert fused_t.stage1_query_bytes(10_485_760, 36, 2048, "cuda") \
        == 4 * 10_485_760
    assert fused_t.stage1_query_bytes(10_485_760, 192, 2048, "cpu") \
        == 4 * 10_485_760
    p1 = topk_t.filter_plan(1_048_576, 1024)
    assert (p1.tstride, p1.cap) == (32, 131_072 + 16_896)
    assert p1.query_bytes < 1.5e6


def _mirror(seed, n, r, b, keep, dup=0):
    """A bf16 mirror with its norms, projected queries and a row mask
    keeping about ``keep`` of the rows (None: every row), from numpy;
    with ``dup`` the first dup rows appear again at the end (ties)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n - dup, r)).astype(np.float32)
    if dup:
        x = np.concatenate([x, x[:dup]])
    xb = torch.from_numpy(x).to(torch.bfloat16)
    x_sq = (xb.float() ** 2).sum(1)
    q = torch.from_numpy(rng.standard_normal((b, r)).astype(np.float32))
    mask = None if keep is None else torch.from_numpy(rng.random(n) < keep)
    return xb, x_sq, q, mask


@pytest.mark.parametrize("keep", [None, 0.9, 0.001])
@pytest.mark.parametrize("ov_k", [1, 16, 64, 300])
def test_filtered_selection_equals_the_plain_one(keep, ov_k):
    """The route's selection (a bar from every tstride-th tile, the
    survivors at or below it, their ov_k smallest) equals the plain
    version's exact top-ov_k, for every mask and for ov_k past the
    unmasked rows (the bar is +inf, the tail pads); the survivors hold the
    answer and stay within the plan's buffer."""
    n = 4096
    xb, x_sq, q, mask = _mirror(40, n, 32, 5, keep)
    plan = topk_t.filter_plan(n, ov_k)
    vf, rf, surv = fused_t.stage1_filter_plain(xb, x_sq, mask, q, ov_k)
    vp, rp = fused_t.stage1_select_plain(xb, x_sq, mask, q, ov_k)
    assert torch.equal(rf, rp) and torch.equal(vf, vp)
    n_in = n if mask is None else int(mask.sum())
    assert (surv >= min(ov_k, n_in)).all() and (surv <= plan.cap).all()
    if plan.tstride and keep is None:
        assert (surv < n).all()  # the bar did filter


def test_filtered_selection_keeps_every_row_tied_at_the_bar():
    """Duplicated rows tie at the bar: all of them survive, and the
    answer takes the lower rows first, as the plain version does."""
    n, ov_k = 4096, 16
    xb, x_sq, q, _ = _mirror(41, n, 32, 4, None, dup=2048)
    q = xb[:4].float() + 0.01  # near duplicated rows
    vf, rf, surv = fused_t.stage1_filter_plain(xb, x_sq, None, q, ov_k)
    vp, rp = fused_t.stage1_select_plain(xb, x_sq, None, q, ov_k)
    assert torch.equal(rf, rp)
    same = vf[:, 1:] == vf[:, :-1]
    assert same.any() and (rf[:, 1:][same] > rf[:, :-1][same]).all()


def test_filtered_selection_counts_an_overflow():
    """A buffer smaller than the survivors: the count passes the plan's
    cap, which the route reports as an overflow (the wrapper then runs the
    launch on the FMA route)."""
    n, ov_k = 4096, 64
    xb, x_sq, q, _ = _mirror(42, n, 32, 3, None)
    plan = topk_t.filter_plan(n, ov_k)._replace(cap=ov_k)
    _, _, surv = fused_t.stage1_filter_plain(xb, x_sq, None, q, ov_k, plan)
    assert (surv > plan.cap).all()


@pytest.mark.parametrize("keep,ov_k", [(0.8, 64), (None, 300)])
def test_filtered_selection_matches_the_reference(keep, ov_k):
    """The route's selection against the reference's stage1_select_kernel
    (approx_min_k, exact on the CPU) on the same bf16 mirror: the same
    rows up to ties, distances within f32 summation order."""
    n, r, b = 3000, 24, 6
    xb, x_sq, q, mask = _mirror(43, n, r, b, keep)
    vj, rj = fused_j.stage1_select_kernel(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(x_sq.numpy()),
        jnp.ones(n, bool) if mask is None else jnp.asarray(mask.numpy()),
        jnp.asarray(q.numpy()), ov_k)
    vt, rt, _ = fused_t.stage1_filter_plain(xb, x_sq, mask, q, ov_k)
    _assert_topk_equal(np.asarray(vj), np.asarray(rj), vt.numpy(),
                       rt.numpy())


def test_dispatch_sub_batches_follow_the_route_transient():
    """The reduced-rank dispatch sizes its sub-batches by what a query of
    stage 1 takes on its route: the tensor-core plan's bytes on the card
    (not the [B, N] buffer), the [B, N] distances of the plain version on
    the CPU."""
    n, ov_k = 10_485_760, 2048
    per = fused_t.stage1_query_bytes(n, 192, ov_k, "cuda")
    budget = 2 << 30
    assert budget // per >= 128  # one launch for a batch of 128
    assert budget // fused_t.stage1_query_bytes(n, 192, ov_k, "cpu") == 51
