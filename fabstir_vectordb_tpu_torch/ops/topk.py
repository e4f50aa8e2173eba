"""Masked top-k selection (exact and binned, over a given distance
matrix), top-k merges, the fused distance top-k kernel
(K1, by metric), the approximate binned pool (K9), the streaming top-k
over row chunks (``chunked_topk``, K8's last program) and the merge of
shards' partial top-k lists (``shard_merge``, K15's).

Smaller distance = better everywhere, negative distances included (dot and
cosine, or a caller's ``dist_fn``); entries that are masked out or not
finite surface as (+inf, -1). Ties go to the lower index, in the plain
versions (stable sorts) and in the kernels alike.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from ..utils import native
from ..utils.device import resolve_device
from .distance import (METRIC_CODE, check_metric, pairwise_distance,
                       pairwise_sq_l2)

INF = float("inf")


def masked_topk_plain(dists: torch.Tensor, mask, k: int):
    """Plain version of :func:`masked_topk`: a stable sort of each row with
    masked-out and non-finite entries at +inf."""
    masked = torch.where(torch.isfinite(dists), dists,
                         torch.full_like(dists, INF))
    if mask is not None:
        if mask.dim() == 1:
            mask = mask[None, :]
        masked = torch.where(mask, masked, torch.full_like(masked, INF))
    vals, idx = torch.sort(masked, dim=1, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=INF)
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    valid = torch.isfinite(vals)
    return (torch.where(valid, vals, torch.full_like(vals, INF)),
            torch.where(valid, idx, torch.full_like(idx, -1)))


def masked_topk(dists: torch.Tensor, mask, k: int):
    """Exact top-k smallest distances where mask is True (the reference's
    masked_topk, ``ops/topk.py:20``).

    dists [B, N] f32; mask [N] or [B, N] bool, or None for every entry; any
    k >= 1. Returns (vals [B, k] f32, idx [B, k] int32) by (distance,
    index), padded with +inf / -1 (also when k > N); a non-finite distance
    is never selected. The plain version on CPU tensors; on CUDA tensors
    csrc/merge_topk.cu's fvdb_masked_topk, the mask read in place (rows of
    at most 4,096 sorted whole by one block, k <= 256 the fused chunk
    kernel, larger k the filtered select), or it raises."""
    if dists.device.type == "cpu":
        return masked_topk_plain(dists, mask, k)
    if dists.device.type != "cuda":
        raise ValueError(f"masked_topk: unsupported device {dists.device}")
    dev = dists.device
    native.check(dists, "dists", torch.float32, 2, dev)
    b, n = dists.shape
    _check_mask(mask, b, n, dev)
    if k < 1:
        raise ValueError(f"masked_topk takes k >= 1, got {k}")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return out_d.fill_(INF), out_r.fill_(-1)
    m_stride = n if mask is not None and mask.dim() == 2 else 0
    P, I, L = native.P, native.I, native.L
    fn = native.fn("merge_topk", "fvdb_masked_topk",
                   [P, P, L, I, I, I, P, L, P, P, P])
    d_ptr, o_d, o_r = dists.data_ptr(), out_d.data_ptr(), out_r.data_ptr()
    m_ptr = 0 if mask is None else mask.data_ptr()
    stream = native.stream_of(dists)
    # the filtered select holds [queries, N] 64-bit survivor keys
    filtered = n > _SORT_SMEM and k > _FUSED_KC
    qb = min(_MAX_GRID_Q, max(1, _DUMP_BYTES // (8 * n))) if filtered \
        else _MAX_GRID_Q
    for lo in range(0, b, qb):
        rows = min(b, lo + qb) - lo
        nbytes = 0 if n <= _SORT_SMEM else native.query(
            "merge_topk", "fvdb_masked_topk_scratch_bytes", [I, I, I], rows,
            n, k)
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev) \
            if nbytes else None
        err = fn(d_ptr + lo * n * 4, m_ptr + lo * m_stride, m_stride, rows,
                 n, k, 0 if work is None else work.data_ptr(), nbytes,
                 o_d + lo * k * 4, o_r + lo * k * 4, stream)
        native.raise_on(err, "merge_topk", "fvdb_masked_topk")
        native.launches["masked_topk"] += 1
    return out_d, out_r


def merge_topk_plain(vals_a, idx_a, vals_b, idx_b, k: int):
    """Plain version of K8's merge: the k first of both lists' entries by
    (value, row), ties of both by position (a's first); an entry whose value
    is not finite comes out as (+inf, -1), and so does the padding when
    there are fewer than k entries."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    vals = torch.where(torch.isfinite(vals), vals, torch.full_like(vals, INF))
    by_row = torch.sort(idx, dim=-1, stable=True).indices
    pos = torch.gather(by_row, -1, torch.sort(
        torch.gather(vals, -1, by_row), dim=-1, stable=True).indices)
    pos = pos[..., :k]
    out_vals = torch.gather(vals, -1, pos)
    out_idx = torch.gather(idx, -1, pos)
    if out_vals.shape[-1] < k:
        pad = k - out_vals.shape[-1]
        out_vals = torch.nn.functional.pad(out_vals, (0, pad), value=INF)
        out_idx = torch.nn.functional.pad(out_idx, (0, pad), value=-1)
    valid = torch.isfinite(out_vals)
    return (torch.where(valid, out_vals, torch.full_like(out_vals, INF)),
            torch.where(valid, out_idx, torch.full_like(out_idx, -1)))


def merge_topk(vals_a, idx_a, vals_b, idx_b, k: int, out=None):
    """K8's merge (the reference's merge_topk): two top-k lists of each of
    B queries, (vals [B, ka] f32, rows [B, ka] int32) and [B, kb], into the
    k first by (value, row), padded with (+inf, -1); written to ``out`` (a
    pair of [B, k] tensors that are not the inputs) when given. The plain
    version on CPU tensors, csrc/merge_topk.cu on CUDA tensors."""
    if vals_a.device.type == "cpu":
        v, r = merge_topk_plain(vals_a, idx_a, vals_b, idx_b, k)
        if out is None:
            return v, r
        out[0].copy_(v)
        out[1].copy_(r)
        return out
    dev = vals_a.device
    native.check(vals_a, "vals_a", torch.float32, 2, dev)
    native.check(idx_a, "idx_a", torch.int32, 2, dev)
    native.check(vals_b, "vals_b", torch.float32, 2, dev)
    native.check(idx_b, "idx_b", torch.int32, 2, dev)
    b, ka = vals_a.shape
    kb = vals_b.shape[1]
    if idx_a.shape != (b, ka) or vals_b.shape[0] != b \
            or idx_b.shape != (b, kb) or k < 1:
        raise ValueError("shape mismatch in merge_topk")
    if out is None:
        out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
        out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    else:
        out_v, out_r = out
        native.check(out_v, "out vals", torch.float32, 2, dev)
        native.check(out_r, "out rows", torch.int32, 2, dev)
        if out_v.shape != (b, k) or out_r.shape != (b, k) or any(
                o.data_ptr() in (t.data_ptr() for t in (vals_a, idx_a, vals_b,
                                                        idx_b))
                for o in (out_v, out_r)):
            raise ValueError("merge_topk: out must be two fresh [B, k] "
                             "tensors")
    if b == 0:
        return out_v, out_r
    P, I = native.P, native.I
    native.call("merge_topk", "fvdb_merge_topk", [P, P, I, P, P, I, I, I, P, P,
                                                  P],
                vals_a.data_ptr(), idx_a.data_ptr(), ka, vals_b.data_ptr(),
                idx_b.data_ptr(), kb, b, k, out_v.data_ptr(), out_r.data_ptr(),
                native.stream_of(vals_a))
    native.launches["merge_topk"] += 1
    return out_v, out_r


def shard_merge_plain(vals, rows, k: int, base=None, row_map=None):
    """Plain version of K15's shard merge (see :func:`shard_merge`)."""
    s, b, ks = vals.shape
    if base is None:
        base = torch.zeros(s, dtype=torch.int32, device=vals.device)
    g = rows.long() + base.long()[:, None, None]
    ok = (rows >= 0) & torch.isfinite(vals)
    if row_map is not None:
        g = row_map[torch.where(ok, g, torch.zeros_like(g))].long()
        ok &= g >= 0
    v = torch.where(ok, vals, torch.full_like(vals, INF))
    g = torch.where(ok, g, torch.full_like(g, -1)).to(torch.int32)
    v = v.permute(1, 0, 2).reshape(b, s * ks)
    g = g.permute(1, 0, 2).reshape(b, s * ks)
    return merge_topk_plain(v, g, v[:, :0], g[:, :0], k)


# candidates a query the shard merge sorts in one launch
# (csrc/shard_merge.cu's MERGE_REG); past it a buffer and a radix select
_MERGE_REG = 16384
# the zero shard bases of a merge without ``base``, by (S, device)
_zero_base: dict = {}
# each thread's packed argument words of fvdb_shard_merge_packed
_merge_words = threading.local()


def shard_merge(vals, rows, k: int, base=None, row_map=None):
    """K15's shard merge (the all_gather + top_k that ends each of the
    reference's sharded searches): vals [S, B, k_s] f32 and rows [S, B, k_s]
    int32, each shard's partial top-k with shard-local rows (-1: none).
    Shard s maps a row r >= 0 to base[s] + r (base [S] int32, None: zeros)
    or, with row_map (int32), to row_map[base[s] + r]. Returns the k
    smallest (vals [B, k], rows [B, k] global) by (distance, row), padded
    with (+inf, -1); rows < 0 and distances that are not finite never
    enter, wherever they sit in a list. The plain version on CPU tensors;
    on CUDA tensors csrc/shard_merge.cu (a bitonic sort of 64-bit keys: in
    a warp's registers up to S * k_s = 64, in a block's registers up to
    16,384, past it a buffer and topk_select.cuh's radix select), or it
    raises."""
    dev = vals.device
    if dev.type == "cpu":
        return shard_merge_plain(vals, rows, k, base, row_map)
    if dev.type != "cuda":
        raise ValueError(f"shard_merge: unsupported device {dev}")
    if vals.dtype != torch.float32 or rows.dtype != torch.int32 \
            or vals.dim() != 3 or rows.shape != vals.shape \
            or rows.device != dev or not vals.is_contiguous() \
            or not rows.is_contiguous() or k < 1 or vals.shape[2] < 1:
        raise ValueError(f"shard_merge: vals {vals.dtype} "
                         f"{tuple(vals.shape)}, rows {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}, k={k} "
                         "(contiguous [S, B, k_s] f32 / int32, k_s, k >= 1)")
    s, b, ks = vals.shape
    if base is None:
        base = _zero_base.get((s, dev))
        if base is None:
            base = _zero_base[(s, dev)] = torch.zeros(
                s, dtype=torch.int32, device=dev)
    elif base.dtype != torch.int32 or base.device != dev \
            or base.shape != (s,) or not base.is_contiguous():
        raise ValueError(f"shard_merge: base {base.dtype} "
                         f"{tuple(base.shape)} on {base.device} for {s} "
                         "shards (contiguous int32)")
    if row_map is not None and (
            row_map.dtype != torch.int32 or row_map.device != dev
            or row_map.dim() != 1 or not row_map.is_contiguous()):
        raise ValueError(f"shard_merge: row_map {row_map.dtype} "
                         f"{tuple(row_map.shape)} on {row_map.device} "
                         "(contiguous 1-D int32)")
    # new_empty takes the dtype and device of the checked inputs: two such
    # calls cost the host less than one allocation and the two views
    out_d, out_r = vals.new_empty((b, k)), rows.new_empty((b, k))
    if b == 0:
        return out_d, out_r
    scratch = (0, 0, 0)
    if s * ks > _MERGE_REG:
        if b > _MAX_GRID_Q:
            raise ValueError(f"shard_merge takes at most {_MAX_GRID_Q} "
                             f"queries past {_MERGE_REG} candidates")
        bufs = (torch.empty((b, s * ks), dtype=torch.float32, device=dev),
                torch.empty((b, s * ks), dtype=torch.int32, device=dev),
                select_scratch("shard_merge", b, k, dev))  # held to the end
        scratch = tuple(t.data_ptr() for t in bufs)
    words = getattr(_merge_words, "w", None)
    if words is None:  # this thread's words, and the function once
        words = _merge_words.w = (ctypes.c_longlong * 14)()
        _merge_words.fn = native.fn("shard_merge", "fvdb_shard_merge_packed",
                                    [ctypes.POINTER(ctypes.c_longlong)])
    words[:] = (vals.data_ptr(), rows.data_ptr(), base.data_ptr(),
                0 if row_map is None else row_map.data_ptr(), s, b, ks, k,
                *scratch, out_d.data_ptr(), out_r.data_ptr(),
                native.stream_of(vals))
    err = _merge_words.fn(words)
    if err:
        native.raise_on(err, "shard_merge", "fvdb_shard_merge_packed")
    native.launches["shard_merge"] += 1
    return out_d, out_r


def chunk_step_plain(d, mask, start: int, vals, idx, k: int):
    """Plain version of chunked_topk's step: the masked top-min(k, C) of a
    chunk's distances d [B, C] (rows offset by ``start``) merged into the
    running (vals, idx) [B, k]."""
    cvals, cidx = masked_topk_plain(d, mask, min(k, d.shape[1]))
    cidx = torch.where(cidx >= 0, cidx + start, cidx)
    return merge_topk_plain(vals, idx, cvals, cidx, k)


def chunk_step(d, mask, start: int, vals, idx, k: int, out=None,
               work=None):
    """chunked_topk's step: d [B, C] f32 distances of rows start .. start
    + C - 1, mask [C] or [B, C] bool or None; the chunk's masked top-min(k,
    C) by (distance, row), rows offset by ``start``, merged into the running
    (vals [B, k], idx [B, k] int32), which is sorted by (distance, row)
    with its (+inf, -1) padding last, as every step leaves it. Returns the
    new running pair, written to ``out`` (a pair of [B, k] tensors that are
    not the running ones) when given. The plain version on CPU tensors; on
    CUDA tensors one call of csrc/merge_topk.cu's chunk step (at min(k, C)
    <= 256 and k <= 2,048 the fused kernel, above it the filtered select),
    the mask read in place, or it raises. ``work`` is its scratch
    (:func:`chunk_scratch`, reused from step to step, which leave it as
    they found it), allocated when not given."""
    if d.device.type == "cpu":
        return chunk_step_plain(d, mask, start, vals, idx, k)
    dev = d.device
    native.check(vals, "vals", torch.float32, 2, dev)
    native.check(idx, "idx", torch.int32, 2, dev)
    b, c = d.shape
    if vals.shape != (b, k) or idx.shape != (b, k) or c < 1 or k < 1:
        raise ValueError(f"chunk_step: d {tuple(d.shape)}, running "
                         f"{tuple(vals.shape)}, k={k}")
    if out is None:
        out = (torch.empty((b, k), dtype=torch.float32, device=dev),
               torch.empty((b, k), dtype=torch.int32, device=dev))
    else:
        native.check(out[0], "out vals", torch.float32, 2, dev)
        native.check(out[1], "out rows", torch.int32, 2, dev)
        if out[0].shape != (b, k) or out[1].shape != (b, k) \
                or out[0].data_ptr() == vals.data_ptr() \
                or out[1].data_ptr() == idx.data_ptr():
            raise ValueError("chunk_step: out must be a new [B, k] pair")
    if work is None:
        work = chunk_scratch(b, c, min(k, c), dev, k)
    return _step(_step_fn(), native.stream_of(d), d, mask, start, vals, idx,
                 k, out, work)


def _step_fn():
    P, I, L = native.P, native.I, native.L
    return native.fn("merge_topk", "fvdb_chunk_step",
                     [P, P, L, I, I, I, I, P, P, I, P, L, P, P, P])


def _step(fn, stream: int, d, mask, start: int, vals, idx, k: int, out,
          work):
    """The chunk step's launch, its running and output pairs and scratch
    checked by the caller: d and the mask are checked here."""
    b, c = d.shape
    native.check(d, "d", torch.float32, 2, vals.device)
    _check_mask(mask, b, c, vals.device)
    err = fn(d.data_ptr(), 0 if mask is None else mask.data_ptr(),
             c if mask is not None and mask.dim() == 2 else 0, b, c,
             min(k, c), int(start), vals.data_ptr(), idx.data_ptr(), k,
             work.data_ptr(), work.numel(), out[0].data_ptr(),
             out[1].data_ptr(), stream)
    native.raise_on(err, "merge_topk", "fvdb_chunk_step")
    native.launches["chunk_step"] += 1
    return out


def chunk_scratch(b: int, c: int, kc: int, device, k: int | None = None
                  ) -> torch.Tensor:
    """The chunk step's scratch for b queries of c distances at kc =
    min(k, c) (k None: kc), its head zeroed (each step leaves it so). At
    kc <= 256 and k <= 2,048 the fused kernel's, else the filtered
    select's, whose survivor buffer holds [b, c] 64-bit keys."""
    k = kc if k is None else k
    args = ([native.I] * 4, b, c, kc, k)
    n = native.query("merge_topk", "fvdb_chunk_scratch_bytes", *args)
    head = native.query("merge_topk", "fvdb_chunk_scratch_head", *args)
    work = torch.empty(n, dtype=torch.uint8, device=device)
    work[:head].zero_()
    return work


def chunked_topk(dist_fn, n_total: int, chunk: int, k: int, batch: int,
                 device=None):
    """The reference's chunked_topk (ops/topk.py:73): returns a callable
    that scans rows [0, n_total) in chunks, ``dist_fn(start)`` giving
    ([B, chunk] distances, [B, chunk] or [chunk] mask or None) for rows
    [start, start + chunk), and keeps a running [B, k] top-k (vals f32,
    rows int32, (+inf, -1) padded) through :func:`chunk_step`: the
    device-side analog of a streaming min-heap. The running list lives on
    ``device`` (None: the card); dist_fn's tensors must be there too.
    Distances may be negative. On the card a run allocates two running
    pairs, which the steps write in turn; the step's scratch is allocated
    at a stream's first run (one for each chunk width) and kept (each step
    leaves it as it found it), and a chunk costs one C call with only the
    chunk's own tensors checked."""
    n_chunks = (n_total + chunk - 1) // chunk
    scratch = {}

    def run():
        dev = resolve_device(device)
        vals = torch.full((batch, k), INF, device=dev)
        idx = torch.full((batch, k), -1, dtype=torch.int32, device=dev)
        if dev.type != "cuda":
            for i in range(n_chunks):
                d, m = dist_fn(i * chunk)
                vals, idx = chunk_step(d, m, i * chunk, vals, idx, k)
            return vals, idx
        bufs = ((vals, idx), (torch.empty_like(vals), torch.empty_like(idx)))
        stream, fn = native.stream_of(vals), _step_fn()
        for i in range(n_chunks):
            d, m = dist_fn(i * chunk)
            # runs on one stream take turns; a short last chunk has its own
            key = (dev, stream, d.shape[-1])
            if key not in scratch:
                scratch[key] = chunk_scratch(batch, key[2], min(k, key[2]),
                                             dev, k)
            vals, idx = _step(fn, stream, d, m, i * chunk, vals, idx, k,
                              bufs[(i + 1) % 2], scratch[key])
        return vals, idx

    return run


def l2_topk_plain(x, x_sq, mask, q, k: int, row_base: int = 0,
                  round_query: bool = False, metric: str = "euclidean"):
    """Plain version of K1: the [B, N] distance matrix of ``metric``, then
    masked_topk. bf16 rows are upcast; x_sq None takes their norms;
    ``round_query`` as in :func:`l2_topk`."""
    vals, rows = masked_topk_plain(pairwise_distance(q, x, metric, x_sq,
                                               round_query), mask, k)
    if row_base:
        rows = torch.where(rows >= 0, rows + row_base, rows)
    return vals, rows


def approx_bins(n: int, k: int, recall_target: float = 0.95) -> int:
    """K9's bin count M for a pool of k out of n: a true top-k row is lost
    only when a better row shares its bin, so the expected recall is
    ((M - 1) / M)^(k - 1); M = ceil(1 / (1 - r^(1 / (k - 1)))), clamped to
    [1, n] (M = n is the exact pool)."""
    if k <= 1 or n <= k:
        return max(n, 1)
    m = math.ceil(1.0 / (1.0 - recall_target ** (1.0 / (k - 1))))
    return max(1, min(m, n))


def masked_approx_topk_plain(dists: torch.Tensor, mask, k: int,
                             recall_target: float = 0.95):
    """Plain version of :func:`masked_approx_topk` and of K9's selection:
    entry j of each row goes to bin j mod M (:func:`approx_bins`), each bin
    keeps its smallest (distance, row), and the k smallest minima come out
    by (distance, row), padded with (+inf, -1). A bin with no unmasked
    finite entry holds nothing."""
    b, n = dists.shape
    masked = dists
    if mask is not None:
        if mask.dim() == 1:
            mask = mask[None, :]
        masked = torch.where(mask, dists, torch.full_like(dists, INF))
    masked = torch.where(torch.isfinite(masked), masked,
                         torch.full_like(masked, INF))
    m = approx_bins(n, k, recall_target)
    if m >= n:
        return masked_topk_plain(masked, None, k)
    v = torch.nn.functional.pad(masked, (0, (-n) % m), value=INF)
    v = v.view(b, -1, m)  # [b, i, j] is row i * m + j
    mins = v.min(dim=1).values
    first = (v == mins[:, None, :]).to(torch.int32).argmax(dim=1)
    rows = (first * m + torch.arange(m, device=dists.device)).to(torch.int32)
    rows = torch.where(torch.isfinite(mins), rows, torch.full_like(rows, -1))
    return merge_topk_plain(mins, rows, mins[:, :0], rows[:, :0], k)


def masked_approx_topk(dists: torch.Tensor, mask, k: int,
                       recall_target: float = 0.95):
    """The reference's masked_approx_topk (``ops/topk.py:44``, over
    lax.approx_min_k) as K9 bins it: dists [B, N] f32, mask [N] or [B, N]
    bool or None; entry j goes to bin j mod M (M from :func:`approx_bins`
    at ``recall_target``), each bin keeps its smallest (distance, row) among
    its unmasked finite entries, and the k smallest minima come out by
    (distance, row), padded with (+inf, -1). Where M >= N that is the
    exact :func:`masked_topk`. The plain version on CPU tensors; on CUDA
    tensors csrc/approx_topk.cu's fvdb_approx_select (the bin minima, then
    topk_select.cuh's radix select) or it raises."""
    if dists.device.type == "cpu":
        return masked_approx_topk_plain(dists, mask, k, recall_target)
    if dists.device.type != "cuda":
        raise ValueError(f"masked_approx_topk: unsupported device "
                         f"{dists.device}")
    dev = dists.device
    native.check(dists, "dists", torch.float32, 2, dev)
    b, n = dists.shape
    _check_mask(mask, b, n, dev)
    if k < 1:
        raise ValueError(f"masked_approx_topk takes k >= 1, got {k}")
    m = approx_bins(n, k, recall_target)
    if m >= n:
        return masked_topk(dists, mask, k)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_r
    m_stride = n if mask is not None and mask.dim() == 2 else 0
    P, I, L = native.P, native.I, native.L
    for lo in range(0, b, _MAX_GRID_Q):  # the select's grid caps a launch
        hi = min(b, lo + _MAX_GRID_Q)
        cand_d = torch.empty((hi - lo, m), dtype=torch.float32, device=dev)
        cand_r = torch.empty((hi - lo, m), dtype=torch.int32, device=dev)
        work = select_scratch("approx_topk", hi - lo, k, dev)
        m_ptr = 0 if mask is None else (mask[lo:hi].data_ptr() if m_stride
                                        else mask.data_ptr())
        native.call(
            "approx_topk", "fvdb_approx_select",
            [P, P, L, I, I, I, I, P, P, P, P, P, P],
            dists[lo:hi].data_ptr(), m_ptr, m_stride, hi - lo, n, m, k,
            cand_d.data_ptr(), cand_r.data_ptr(), work.data_ptr(),
            out_d[lo:hi].data_ptr(), out_r[lo:hi].data_ptr(),
            native.stream_of(dists))
        native.launches["masked_approx_topk"] += 1
    return out_d, out_r


def approx_topk_plain(x, x_sq, mask, q, ov_k: int,
                      round_query: bool = False):
    """Plain version of K9: the [B, N] distance matrix, then
    :func:`masked_approx_topk_plain`."""
    return masked_approx_topk_plain(pairwise_sq_l2(q, x, x_sq, round_query), mask,
                              ov_k)


def approx_topk(x, x_sq, mask, q, ov_k: int, round_query: bool = False):
    """K9 (the reference's masked_approx_topk over the flat scan's
    distances, ``index/fused.py:114``): a pool of ov_k rows of x [N, D] (f32
    or bf16) for each query of q [B, D] f32, the ov_k smallest of the
    (distance, row) minima of M bins (row r in bin r mod M; M from
    :func:`approx_bins` at recall target 0.95). x_sq [N] f32 norms; mask [N]
    or [B, N] bool, or None for every row; ``round_query`` (bf16 rows only)
    as in :func:`l2_topk`. Returns (vals [B, ov_k] f32, rows [B, ov_k]
    int32) by (distance, row), padded with (+inf, -1). The plain version on
    CPU tensors, csrc/approx_topk.cu on CUDA tensors: bf16 rows with the
    query rounded and f32 rows on the tensor cores where :func:`tile_route`
    says so and the rows and queries are 16-byte aligned
    (csrc/bf16_tile.cuh, counted as "approx_topk" and "approx_topk_tf32"),
    the rest on the FMA pass ("approx_topk_f32", "approx_topk_bf16",
    "approx_topk_bf16_rq_fma")."""
    bf16 = x.dtype == torch.bfloat16
    if round_query and not bf16:
        raise ValueError("approx_topk: round_query takes bf16 rows")
    if x.device.type == "cpu":
        return approx_topk_plain(x, x_sq, mask, q, ov_k, round_query)
    dev = x.device
    native.check(x, "x", torch.bfloat16 if bf16 else torch.float32, 2, dev)
    native.check(q, "q", torch.float32, 2, dev)
    native.check(x_sq, "x_sq", torch.float32, 1, dev)
    n, d = x.shape
    b = q.shape[0]
    _check_mask(mask, b, n, dev)
    if q.shape[1] != d or x_sq.shape[0] != n or ov_k < 1:
        raise ValueError(f"approx_topk: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, x_sq {tuple(x_sq.shape)}, "
                         f"ov_k={ov_k}")
    out_d = torch.empty((b, ov_k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, ov_k), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return out_d.fill_(INF), out_r.fill_(-1)
    m = approx_bins(n, ov_k)
    rounds = math.ceil(n / m)
    P, I, L = native.P, native.I, native.L
    m_stride = n if mask is not None and mask.dim() == 2 else 0
    # the tensor-core pass takes bf16 rows with the query rounded and f32
    # rows (three TF32 products); bf16 rows with an f32 query stay on the
    # FMA pass, as does every shape TMA cannot read in place
    route = tile_route(x.dtype, round_query, d)
    if route not in ("wgmma", "tf32x3") or x.data_ptr() % 16 \
            or q.data_ptr() % 16 or math.ceil(m / _TC_ROWS) > _MAX_GRID_Q:
        route = "fma"
    tc = route != "fma"
    counter = {"wgmma": "approx_topk", "tf32x3": "approx_topk_tf32"}[route] \
        if tc else native.counter("approx_topk", bf16, rq=round_query,
                                  fma=round_query) \
        if bf16 else "approx_topk_f32"
    for lo in range(0, b, _MAX_GRID_Q):  # the select's grid caps a launch
        hi = min(b, lo + _MAX_GRID_Q)
        bb = hi - lo
        keys = torch.empty((bb, m), dtype=torch.int64, device=dev)
        cand_d = torch.empty((bb, m), dtype=torch.float32, device=dev)
        cand_r = torch.empty((bb, m), dtype=torch.int32, device=dev)
        work = select_scratch("approx_topk", bb, ov_k, dev)
        m_ptr = 0 if mask is None else (mask[lo:hi].data_ptr() if m_stride
                                        else mask.data_ptr())
        if tc:  # csrc/bf16_tile.cuh: 128 bins a block
            plan = tile_plan(bb, ov_k, d, "bins", route)
            tiles = plan.tiles * math.ceil(m / _TC_ROWS)
            # round ranges that fill the last wave: taken on f32 rows; on
            # bf16 rows they were 1-3% slower than one wave of longer
            # ranges (scripts/time_tile_routes.py --only k9bf16 on an H100)
            z, i_per = _round_waves(rounds, tiles, _num_sms(dev)) \
                if route == "tf32x3" else _round_ranges(rounds, tiles, dev, 1)
            native.call(
                "approx_topk", "fvdb_approx_pool_tc",
                [P, I, P, P, L, P, I, I, I, I, I, I, I, I, I, I, P, P, P, P,
                 P, P, P],
                x.data_ptr(), TILE_ROUTES[route], x_sq.data_ptr(), m_ptr,
                m_stride,
                q[lo:hi].data_ptr(), bb, n, d, m, ov_k, z, i_per, plan.width,
                plan.stages, plan.smem, keys.data_ptr(), cand_d.data_ptr(),
                cand_r.data_ptr(), work.data_ptr(), out_d[lo:hi].data_ptr(),
                out_r[lo:hi].data_ptr(), native.stream_of(x))
        else:  # l2_tile.cuh: 32 queries and 256 bins a block
            z, i_per = _round_ranges(rounds, math.ceil(bb / 32)
                                     * math.ceil(m / 256), dev, 2)
            native.call(
                "approx_topk", "fvdb_approx_pool",
                [P, I, I, P, P, L, P, I, I, I, I, I, I, I, P, P, P, P, P, P,
                 P],
                x.data_ptr(), int(bf16), int(round_query), x_sq.data_ptr(),
                m_ptr, m_stride, q[lo:hi].data_ptr(), bb, n, d, m, ov_k, z,
                i_per, keys.data_ptr(), cand_d.data_ptr(), cand_r.data_ptr(),
                work.data_ptr(), out_d[lo:hi].data_ptr(),
                out_r[lo:hi].data_ptr(), native.stream_of(x))
        native.launches[counter] += 1
    return out_d, out_r


def _round_ranges(rounds: int, tiles: int, dev, per_sm: int):
    """K9's round ranges: z ranges of i_per rounds each, so that ``tiles``
    blocks a range make one wave at ``per_sm`` blocks an SM (a few blocks
    past it would run as a second wave of their own)."""
    z = max(1, min(rounds, per_sm * _num_sms(dev) // tiles))
    i_per = math.ceil(rounds / z)
    return math.ceil(rounds / i_per), i_per


# the fewest rounds a range of the TF32 route takes (a range reads its
# query tile and writes its bins' minima once)
_LEAST_ROUNDS = 8


@functools.lru_cache(maxsize=256)
def _round_waves(rounds: int, tiles: int, sms: int):
    """K9's round ranges on the TF32 route (one block an SM, each as long
    as the next) on a card of ``sms`` SMs: the fewest ranges whose blocks
    fill their last wave to within 2% of the best fill that any count of
    ranges of at least _LEAST_ROUNDS rounds reaches, so that a tile count
    such as 80 (B = 128 at 32 queries a block, 20 bin tiles) does not leave
    52 of 132 SMs idle. Returns (ranges, rounds a range)."""

    def plan(z):
        i_per = math.ceil(rounds / z)
        blocks = tiles * math.ceil(rounds / i_per)
        return blocks / (math.ceil(blocks / sms) * sms), i_per

    zs = range(1, max(1, rounds // _LEAST_ROUNDS) + 1)
    best = max(plan(z)[0] for z in zs)
    z = next(z for z in zs if plan(z)[0] >= best - 0.02)
    i_per = plan(z)[1]
    return math.ceil(rounds / i_per), i_per


_SMS: dict = {}


def _num_sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device) \
            .multi_processor_count
    return _SMS[device]


# K1 keeps its lists in shared memory up to this k (csrc/l2_topk.cu)
_SMALL_K = 256
# the fused chunk step's reach (csrc/merge_topk.cu): min(k, C)
_FUSED_KC = 256
# rows masked_topk sorts whole in shared memory (topk_select.cuh's
# SORT_SMEM)
_SORT_SMEM = 4096
# bytes of [B, N] distances the k > _SMALL_K path holds at once
_DUMP_BYTES = 1 << 30
# queries a launch takes (a grid's y and z extents)
_MAX_GRID_Q = 65_535


def select_scratch(source: str, b: int, k: int, device) -> torch.Tensor:
    """The scratch bytes of csrc/topk_select.cuh's radix select for b rows
    at k, as compiled into ``source``'s library."""
    n = native.query(source, "fvdb_select_scratch_bytes",
                     [native.I, native.I], b, k)
    return torch.empty(n, dtype=torch.uint8, device=device)


def l2_topk(x: torch.Tensor, x_sq: torch.Tensor | None, mask: torch.Tensor,
            q: torch.Tensor, k: int, row_base: int = 0,
            round_query: bool = False, metric: str = "euclidean"):
    """K1: masked exact top-k of q [B, D] over x [N, D] by ``metric``:
    squared L2 (the default), cosine distance or negative dot
    (``ops.distance``), whose values may be negative.

    x [N, D] f32 or bf16 (upcast exactly); x_sq [N] f32 row norms, or None
    to take them in the kernel; mask [N] or [B, N] bool, or None for every
    row; any k >= 1; ``row_base`` is added to every result row;
    ``round_query`` (bf16 rows only) rounds q to bf16 in the product, with
    |q|^2 from the f32 q: the bf16 serving mirror's distance, whose x_sq are
    the f32 norms of the f32 host rows. Returns (vals [B, k] f32, rows
    [B, k] int32) sorted by (distance, row), padded with +inf / -1 (also
    when fewer than k rows are unmasked). On CPU tensors it runs the plain
    version; on CUDA tensors it launches csrc/l2_topk.cu (k <= 256:
    per-query lists in shared memory; larger k: the masked distances of a
    query chunk to a buffer, then a radix select) or raises. The
    tensor-core pass (csrc/bf16_tile.cuh) takes the shapes
    :func:`tile_route` sends it (bf16 rows with the query rounded, f32 rows
    by three TF32 products, bf16 rows with an f32 query split in three
    bf16 parts), rows and queries 16-byte aligned; l2_tile.cuh's FMA pass
    takes the rest, each under its own counter ("..._fma"). f32 rows by
    euclidean distance at k >= 128 take the tensor-core pass's filter route
    (csrc/tile_filter.cuh: a bar from a sample of the rows' tiles, the
    survivors under it, no lists and no [B, N] buffer), which reads one
    int back from the card a launch; a launch whose survivors pass their
    buffer runs again on the lists or the buffer ("l2_topk_overflow").

    bf16 rows without rounding (euclidean only): the HNSW link candidates
    on a bf16 mirror and the reduced-rank calibration oracle's streamed
    blocks (x_sq None takes the norms of the upcast rows); the tiered exact
    search streams f32 tiles without norms. Cosine and dot run on f32 rows
    and on bf16 rows with the query rounded (a bf16 serving mirror)."""
    bf16 = x.dtype == torch.bfloat16
    check_metric(metric)
    if round_query and not bf16:
        raise ValueError("l2_topk: round_query takes bf16 rows")
    if bf16 and not round_query and metric != "euclidean":
        raise ValueError("l2_topk: cosine and dot on bf16 rows take "
                         "round_query")
    if x.device.type == "cpu":
        return l2_topk_plain(x, x_sq, mask, q, k, row_base, round_query,
                             metric)
    if x.device.type != "cuda":
        raise ValueError(f"l2_topk: unsupported device {x.device}")
    dev = x.device
    native.check(x, "x", torch.bfloat16 if bf16 else torch.float32, 2, dev)
    native.check(q, "q", torch.float32, 2, dev)
    n, d = x.shape
    b = q.shape[0]
    _check_mask(mask, b, n, dev)
    if x_sq is not None:
        native.check(x_sq, "x_sq", torch.float32, 1, dev)
    if q.shape[1] != d or (x_sq is not None and x_sq.shape[0] != n):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, q {tuple(q.shape)}, x_sq "
            f"{None if x_sq is None else tuple(x_sq.shape)}")
    if k < 1:
        raise ValueError(f"l2_topk takes k >= 1, got {k}")
    return _l2_topk_card(x, x_sq, mask, q, k, row_base, round_query, metric,
                         True)


def _l2_topk_card(x, x_sq, mask, q, k: int, row_base: int,
                  round_query: bool, metric: str, filter_route: bool):
    """:func:`l2_topk` on the card, its arguments checked; ``filter_route``
    lets f32 rows by euclidean distance at k >= 128 take the filter route
    (the reruns of a launch that overflowed it do not)."""
    bf16 = x.dtype == torch.bfloat16
    dev = x.device
    n, d = x.shape
    b = q.shape[0]
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return out_d.fill_(INF), out_r.fill_(-1)
    P, I, L = native.P, native.I, native.L
    m_stride = n if mask is not None and mask.dim() == 2 else 0
    m_ptr = 0 if mask is None else mask.data_ptr()
    sq_ptr = 0 if x_sq is None else x_sq.data_ptr()
    scratch = torch.empty(n, dtype=torch.float32, device=dev) \
        if x_sq is None else None
    scratch_ptr = 0 if scratch is None else scratch.data_ptr()
    # the tensor-core pass where tile_route says so (and TMA can read the
    # rows and queries in place), else the FMA pass, counted apart
    route = tile_route(x.dtype, round_query, d)
    if route != "fma" and (x.data_ptr() % 16 or q.data_ptr() % 16
                           or (route == "bf16x3" and metric != "euclidean")):
        route = "fma"
    if route == "tf32x3" and metric == "euclidean" and filter_route \
            and k >= _FILTER_MIN_K:
        return _filter_topk(x, x_sq, mask, q, k, row_base)
    plan = None
    if route != "fma":
        qc = b if k <= _SMALL_K else max(1, min(b, _DUMP_BYTES // (4 * n),
                                               _MAX_GRID_Q))
        plan = tile_plan(qc, k, d, "lists" if k <= _SMALL_K else "dump",
                         route)
        if plan is None:
            route = "fma"
    tc = route != "fma"
    # one counter a kernel: f32 rows, bf16 rows, bf16 rows with the query
    # rounded; the tensor-core routes count under these names, the FMA pass
    # under "..._fma"; the k > 256 path of f32 rows counts apart; cosine and
    # dot add their name
    counter = native.counter(
        "l2_topk_large" if k > _SMALL_K and not bf16 else "l2_topk", bf16,
        metric, rq=round_query, fma=not tc)
    code = METRIC_CODE[metric]
    kind = TILE_ROUTES.get(route, 0)
    # bf16 entry points take round_q after their last int, then the metric
    rq = ([int(round_query)] if bf16 else []) + [code]
    rq_t = ([I] if bf16 else []) + [I]
    if k > _SMALL_K:
        qc = max(1, min(b, _DUMP_BYTES // (4 * n), _MAX_GRID_Q))
        for lo in range(0, b, qc):
            hi = min(b, lo + qc)
            dump = torch.empty((hi - lo, n), dtype=torch.float32, device=dev)
            work = select_scratch("l2_topk", hi - lo, k, dev)
            mq = mask[lo:hi].data_ptr() if m_stride else m_ptr
            if tc:
                native.call(
                    "l2_topk", "fvdb_l2_topk_large_tc",
                    [P, I, P, P, L, P, I, I, I, I, I, I, I, I, I, P, P, P, P,
                     P, P],
                    x.data_ptr(), kind, sq_ptr, mq, m_stride,
                    q[lo:hi].data_ptr(), hi - lo, n, d, k,
                    _tc_splits(math.ceil((hi - lo) / plan.width), n, dev),
                    code, plan.width, plan.stages, plan.smem, scratch_ptr,
                    dump.data_ptr(), work.data_ptr(), out_d[lo:hi].data_ptr(),
                    out_r[lo:hi].data_ptr(), native.stream_of(x))
            else:
                native.call(
                    "l2_topk", "fvdb_l2_topk_large_bf16" if bf16
                    else "fvdb_l2_topk_large",
                    [P, P, P, L, P, I, I, I, I, I, *rq_t, P, P, P, P, P, P],
                    x.data_ptr(), sq_ptr, mq, m_stride, q[lo:hi].data_ptr(),
                    hi - lo, n, d, k, _splits(hi - lo, n, dev), *rq,
                    scratch_ptr, dump.data_ptr(), work.data_ptr(),
                    out_d[lo:hi].data_ptr(), out_r[lo:hi].data_ptr(),
                    native.stream_of(x))
            native.launches[counter] += 1
            # the norms of this x are in scratch now: later chunks reuse them
            sq_ptr = sq_ptr or scratch_ptr
        if row_base:
            out_r = torch.where(out_r >= 0, out_r + row_base, out_r)
        return out_d, out_r
    splits = _tc_splits(plan.tiles, n, dev) if tc else _splits(b, n, dev)
    part_d = torch.empty((splits, b, k), dtype=torch.float32, device=dev)
    part_r = torch.empty((splits, b, k), dtype=torch.int32, device=dev)
    if tc:
        # each query's k-th bound (8 bytes), then its slices' j-th keys (4)
        bars = torch.empty(b + (b * splits + 1) // 2, dtype=torch.int64,
                           device=dev)
        native.call(
            "l2_topk", "fvdb_l2_topk_tc",
            [P, I, P, P, L, P, I, I, I, I, I, I, I, I, I, I, P, P, P, P, P,
             P, P],
            x.data_ptr(), kind, sq_ptr, m_ptr, m_stride, q.data_ptr(), b, n,
            d, k, splits, row_base, code, plan.width, plan.stages, plan.smem,
            scratch_ptr, bars.data_ptr(), part_d.data_ptr(),
            part_r.data_ptr(), out_d.data_ptr(), out_r.data_ptr(),
            native.stream_of(x))
    else:
        native.call(
            "l2_topk", "fvdb_l2_topk_bf16" if bf16 else "fvdb_l2_topk",
            [P, P, P, L, P, I, I, I, I, I, I, *rq_t, P, P, P, P, P, P],
            x.data_ptr(), sq_ptr, m_ptr, m_stride,
            q.data_ptr(), b, n, d, k, splits, row_base, *rq, scratch_ptr,
            part_d.data_ptr(), part_r.data_ptr(), out_d.data_ptr(),
            out_r.data_ptr(), native.stream_of(x))
    native.launches[counter] += 1
    return out_d, out_r


class FilterPlan(NamedTuple):
    tstride: int      # the sample takes every tstride-th tile (0: none)
    cap_s: int        # the sample's rows a query (its keys' buffer)
    cap: int          # survivors a query, with a reservation a slice spare
    chunk: int        # slots a block reserves for a query at a time
    query_bytes: int  # device scratch a query


# the filter route (csrc/tile_filter.cuh): tiles of 128 rows; a sample
# that would take more than a quarter of them saves nothing; survivors a
# query the buffer holds, in expected survivors (tstride k), and besides
# them room for a reservation of _FILTER_CHUNK slots a row slice (a block
# pads what it does not fill): up to _FILTER_SLICES slices, one a
# streaming multiprocessor of an H100
_FILTER_MIN_STRIDE = 4
# K1 on f32 rows takes the filter route from this k: below it the lists'
# merges cost less than the route's sample pass, two finishing launches
# and the count it reads back (K1 at B=128 k=16 over 131,072 rows: 0.59 ms
# on the lists, 0.66 on the filter route; K3 at k=200: 4.62 / 4.11 ms,
# scripts/time_tile_routes.py on an H100)
_FILTER_MIN_K = 128
_FILTER_CAP_FACTOR = 4
_FILTER_CHUNK = 128
_FILTER_SLICES = 132


def filter_plan(n: int, k: int, slices: int = _FILTER_SLICES) -> FilterPlan:
    """The filter route's plan (csrc/tile_filter.cuh; K14's stage 1, K1 on
    f32 rows by euclidean distance) over n rows at k with ``slices`` row
    slices: the sample's tile stride, the power of two at most sqrt(n / k)
    (the sample, about n / tstride rows, and the survivors under its bar,
    about tstride k, then cost about the same), none below 4 (no bar:
    every row is a slot); the survivor capacity, 4 tstride k (at most
    every row) and a reservation of 128 slots a slice; and the device bytes
    a query takes: the sample's keys, the survivors' keys, the sample's
    pool and counts, and past 4,096 the finishing lists."""
    tiles = math.ceil(n / _TC_ROWS)
    rows = tiles * _TC_ROWS
    stride = 1 << int(math.floor(math.log2(max(1.0, math.sqrt(n / k)))))
    if stride < _FILTER_MIN_STRIDE:
        tstride, cap_s, cap = 0, 0, rows
    else:
        tstride = stride
        cap_s = math.ceil(tiles / stride) * _TC_ROWS
        cap = min(rows, _FILTER_CAP_FACTOR * stride * k) \
            + slices * _FILTER_CHUNK
    kc = min(k, cap)
    lists = 8 * (1 << (kc - 1).bit_length()) if kc > _SORT_SMEM else 0
    return FilterPlan(tstride, cap_s, cap, _FILTER_CHUNK,
                      8 * (cap_s + cap) + 8 * k + 8 + lists)


class FilterLaunch(NamedTuple):
    tile: TilePlan    # the pass's plan
    sample_slices: int  # row slices of the sample pass
    slices: int       # row slices of the whole pass
    plan: FilterPlan
    work_bytes: int   # the launch's scratch


def filter_launch(b: int, n: int, d: int, k: int, route: str, device,
                  capacity: int | None = None) -> FilterLaunch:
    """The arguments of one launch of the filter route for b queries over
    n rows of d dims at k on ``route`` ("wgmma": K14's stage 1; "tf32x3":
    K1 on f32 rows), with at most ``capacity`` survivors a query (None: the
    plan's); kept per shape, since a search repeats its shapes."""
    return _filter_launch(b, n, d, k, route, _num_sms(device), capacity)


@functools.lru_cache(maxsize=256)
def _filter_launch(b: int, n: int, d: int, k: int, route: str, sms: int,
                   capacity: int | None) -> FilterLaunch:
    tp = tile_plan(b, 0, d, "filter", route)
    slices = _slices(tp.tiles, n, sms)
    plan = filter_plan(n, k, slices)
    if capacity is not None:
        plan = plan._replace(cap=max(1, min(plan.cap, int(capacity))))
    nbytes = native.query("l2_topk", "fvdb_l2_topk_filter_bytes",
                          [native.I] * 4, b, k, plan.cap_s, plan.cap)
    return FilterLaunch(tp, _slices(tp.tiles, max(plan.cap_s, 1), sms),
                        slices, plan, nbytes)


def filter_topk(x, x_sq, mask, q, k: int, out_d, out_r, counter: str,
                capacity: int | None = None, xsq_scratch=None) -> bool:
    """One launch of the filter route (csrc/l2_topk.cu
    fvdb_l2_topk_filter_tc) by euclidean distance: bf16 rows x [N, D] with
    the query rounded (route "wgmma", K14's stage 1) or f32 rows (route
    "tf32x3", K1 at k >= 128), checked by the caller; x_sq [N] or None
    (then the rows' norms go to ``xsq_scratch`` [N] first); mask [N],
    [B, N] or None; the k smallest of each query of q [B, D] into out_d /
    out_r [B, k] (rows without a base), counted as ``counter``; at most
    ``capacity`` survivors a query (None: the plan's). Reads the overflow
    count back from the card: False when a query's survivors passed their
    buffer (out_* then hold no answer)."""
    dev = x.device
    n, d = x.shape
    b = q.shape[0]
    route = "wgmma" if x.dtype == torch.bfloat16 else "tf32x3"
    fl = filter_launch(b, n, d, k, route, dev, capacity)
    tp, plan = fl.tile, fl.plan
    work = torch.empty(fl.work_bytes, dtype=torch.uint8, device=dev)
    overflow = torch.empty(1, dtype=torch.int32, device=dev)
    P, I, L = native.P, native.I, native.L
    native.call(
        "l2_topk", "fvdb_l2_topk_filter_tc",
        [P, I, P, P, L, P, I, I, I, I, I, I, I, I, I, I, I, I, I, P, P, P, P,
         P, P],
        x.data_ptr(), TILE_ROUTES[route],
        0 if x_sq is None else x_sq.data_ptr(),
        0 if mask is None else mask.data_ptr(),
        n if mask is not None and mask.dim() == 2 else 0, q.data_ptr(), b,
        n, d, k, tp.width, tp.stages, tp.smem, fl.sample_slices, fl.slices,
        plan.tstride, plan.cap_s, plan.cap, plan.chunk,
        0 if xsq_scratch is None else xsq_scratch.data_ptr(),
        work.data_ptr(), out_d.data_ptr(), out_r.data_ptr(),
        overflow.data_ptr(), native.stream_of(x))
    native.launches[counter] += 1
    return int(overflow.item()) == 0


def _filter_topk(x, x_sq, mask, q, k: int, row_base: int):
    """K1 on f32 rows by euclidean distance on the filter route
    (:func:`filter_topk`), in query chunks whose scratch stays within
    _DUMP_BYTES; a chunk whose survivors passed their buffer runs again on
    the lists or the buffer ("l2_topk_overflow" counts those chunks)."""
    dev = x.device
    n = x.shape[0]
    b = q.shape[0]
    counter = "l2_topk_large" if k > _SMALL_K else "l2_topk"
    qc = max(1, min(b, _DUMP_BYTES // filter_plan(n, k).query_bytes,
                    _MAX_GRID_Q))
    scratch = torch.empty(n, dtype=torch.float32, device=dev) \
        if x_sq is None else None
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    for lo in range(0, b, qc):
        hi = min(b, lo + qc)
        qq = q[lo:hi]
        mq = mask[lo:hi] if mask is not None and mask.dim() == 2 else mask
        # the first chunk writes the rows' norms to scratch, the rest read
        sq = x_sq if x_sq is not None or lo == 0 else scratch
        if not filter_topk(x, sq, mq, qq, k, out_d[lo:hi], out_r[lo:hi],
                           counter, xsq_scratch=scratch):
            out_d[lo:hi], out_r[lo:hi] = _l2_topk_card(
                x, scratch if x_sq is None else x_sq, mq, qq, k, 0, False,
                "euclidean", False)
            native.launches["l2_topk_overflow"] += 1
    if row_base:
        out_r = torch.where(out_r >= 0, out_r + row_base, out_r)
    return out_d, out_r


def _check_mask(mask, b: int, n: int, dev) -> None:
    if mask is None:
        return
    if mask.dim() not in (1, 2):
        raise ValueError("mask must be [N] or [B, N]")
    native.check(mask, "mask", torch.bool, mask.dim(), dev)
    if mask.shape[-1] != n or (mask.dim() == 2 and mask.shape[0] != b):
        raise ValueError(f"mask {tuple(mask.shape)} does not fit B={b}, "
                         f"N={n}")


def _splits(b: int, n: int, dev) -> int:
    """Slices of N for pass 1, so the grid is one wave: pass 1 holds 128
    registers a thread, so 2 blocks of 256 fit an SM; a second, partial
    wave would cost as much as the first. Slices keep at least two 256-row
    tiles."""
    q_tiles = math.ceil(b / 32)
    return max(1, min(math.ceil(n / 512), 2 * _num_sms(dev) // q_tiles))


def _tc_splits(tiles: int, n: int, dev) -> int:
    """Row slices of the tensor-core pass: ``tiles`` query tiles x slices
    make one wave at one block an SM (its shared memory holds the queries,
    the ring and the lists); slices keep at least two 128-row tiles."""
    return _slices(tiles, n, _num_sms(dev))


def _slices(tiles: int, n: int, sms: int) -> int:
    return max(1, min(math.ceil(n / 256), sms // tiles, _MAX_GRID_Q))


# csrc/bf16_tile.cuh, the tensor-core pass: its query widths (the wgmma's
# N), tile rows, ring slot bytes (128 rows x 128 bytes), staged keys a
# query, ring stages at most, the dynamic shared memory a launch may take
# (232,448 bytes a block less 1 KB of static barriers, padded to the
# dynamic array's alignment), and the widest D of the rounded route and of
# the split ones (whose staged parts take two or three times the room)
_TC_WIDTHS = (8, 32, 64, 128)
_TC_ROWS = 128
_TC_STEP = 128 * 64 * 2
_TC_CAP = 32
_TC_FCAP = 64  # the filter's staged keys a query
_TC_MAX_STAGES = 8
_TC_SMEM_LIMIT = 232_448 - 1024
_TC_MAX_D = 8192
_TC_MAX_D_SPLIT = 2048
TILE_MODES = ("lists", "dump", "bins", "filter")
# the routes of the tensor-core pass and their codes in csrc/bf16_tile.cuh
# (KIND): bf16 rows with the query rounded; f32 rows by three TF32
# products; bf16 rows with an f32 query split in three bf16 parts
TILE_ROUTES = {"wgmma": 0, "tf32x3": 1, "bf16x3": 2}


class TilePlan(NamedTuple):
    width: int   # queries a block (the wgmma's N): 8, 32, 64 or 128
    stages: int  # ring slots of 16 KB
    smem: int    # dynamic shared-memory bytes of a block
    tiles: int   # query tiles: ceil(B / width)


def tile_route(dtype, round_query: bool, d: int) -> str:
    """Which pass K1 (and, for "wgmma" and "tf32x3", K9; for "wgmma", K14's
    stage 1) runs on the card: "wgmma" (csrc/bf16_tile.cuh, one bf16
    product) for bf16 rows with the query rounded at D % 8 == 0 up to D =
    8,192; "tf32x3" (three TF32 products, f32 accuracy) for f32 rows at D
    % 4 == 0 up to 2,048; "bf16x3" (the f32 query split in three bf16
    parts, products exact) for bf16 rows with an f32 query at D % 8 == 0 up
    to 2,048; else "fma" (csrc/l2_tile.cuh). TMA reads 16-byte rows, hence
    the D it takes."""
    if dtype == torch.bfloat16 and round_query:
        return "wgmma" if d % 8 == 0 and 8 <= d <= _TC_MAX_D else "fma"
    if dtype == torch.float32:
        return "tf32x3" if d % 4 == 0 and 4 <= d <= _TC_MAX_D_SPLIT else "fma"
    return "bf16x3" if (dtype == torch.bfloat16 and d % 8 == 0
                        and 8 <= d <= _TC_MAX_D_SPLIT) else "fma"


def _tc_smem(width: int, d: int, mode: str, k: int, stages: int,
             route: str = "wgmma") -> int:
    """csrc/bf16_tile.cuh's tc_smem_bytes: alignment slack, the ring, the
    staged queries (D in steps of 128 bytes, 128 bytes a query a step a
    part), |q|^2, for "lists" the lists, the staging, bars, counts and
    fills, and for "filter" the bars, the staging, its counts and the
    reservations."""
    step = 32 if route == "tf32x3" else 64
    parts = {"wgmma": 1, "tf32x3": 2, "bf16x3": 3}[route]
    b = (1024 + stages * _TC_STEP + math.ceil(d / step) * width * 128 * parts
         + width * 4)
    if mode == "lists":
        b += width * (8 * k + 8 * _TC_CAP + 16)
    if mode == "filter":
        b += width * (8 * _TC_FCAP + 16)
    return b


def tile_plan(b: int, k: int, d: int, mode: str,
              route: str = "wgmma") -> TilePlan | None:
    """The tensor-core pass's launch plan for B queries at k over D dims in
    ``mode`` ("lists": K1 at k <= 256, "dump": K1 past it, "bins": K9,
    "filter": K14's stage 1 and K1 on f32 rows by euclidean distance) on
    ``route`` (:func:`tile_route`'s name; "bf16x3" takes "lists" and
    "dump", "wgmma" and "tf32x3" every mode), or None where the route does
    not take D.

    The query width is the narrowest of 8 / 32 / 64 / 128 that holds B (at
    most 64 for "bins", whose running minima take registers a query, and
    for "bf16x3"; 32 for "tf32x3", whose big products take four
    accumulators a query), made narrower while the ring would have fewer
    than 4 stages of 16 KB (the lists take width x k x 8 bytes, the staged
    queries width x 128 bytes a step a part), and at worst the widest
    with 2."""
    if mode not in TILE_MODES:
        raise ValueError(f"tile_plan: mode {mode!r}, expected one of "
                         f"{TILE_MODES}")
    if route not in TILE_ROUTES:
        raise ValueError(f"tile_plan: route {route!r}, expected one of "
                         f"{tuple(TILE_ROUTES)}")
    if route == "bf16x3" and mode not in ("lists", "dump"):
        raise ValueError(f"tile_plan: route {route!r} does not take "
                         f"{mode!r}")
    dtype = torch.float32 if route == "tf32x3" else torch.bfloat16
    if tile_route(dtype, route == "wgmma", d) != route:
        return None
    kk = k if mode == "lists" else 0
    if mode == "lists" and not 1 <= k <= _SMALL_K:
        raise ValueError(f"tile_plan: lists take 1 <= k <= {_SMALL_K}, "
                         f"got {k}")
    widest = 128 if route == "wgmma" and mode != "bins" else \
        32 if route == "tf32x3" else 64
    need = next(w for w in _TC_WIDTHS if w >= min(max(b, 1), widest))
    widths = [w for w in _TC_WIDTHS if w <= need][::-1]
    for least in (4, 2):
        for w in widths:
            stages = min(_TC_MAX_STAGES,
                         (_TC_SMEM_LIMIT - _tc_smem(w, d, mode, kk, 0, route))
                         // _TC_STEP)
            if stages >= least:
                return TilePlan(w, stages,
                                _tc_smem(w, d, mode, kk, stages, route),
                                math.ceil(b / w))
    return None


class StreamingTopK:
    """Host-side streaming top-k accumulator over result chunks (a copy of
    the JAX package's): push (distance, item) pairs and read back the k
    best seen so far."""

    def __init__(self, k: int):
        if k <= 0:
            raise ValueError("k must be positive")
        self.k = k
        self._heap: list = []  # max-heap via negated distance
        self._counter = 0  # tiebreak: insertion order, avoids comparing ids

    def push(self, distance: float, item) -> None:
        import heapq

        entry = (-float(distance), self._counter, item)
        self._counter += 1
        if len(self._heap) < self.k:
            heapq.heappush(self._heap, entry)
        elif entry[0] > self._heap[0][0]:  # smaller distance than current worst
            heapq.heapreplace(self._heap, entry)

    def push_many(self, distances, items) -> None:
        for d, it in zip(distances, items):
            self.push(float(d), it)

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def worst(self) -> float:
        """Largest distance currently kept (+inf when not yet full)."""
        if len(self._heap) < self.k:
            return float("inf")
        return -self._heap[0][0]

    def results(self) -> list:
        """[(distance, item)] ascending by distance."""
        out = sorted(self._heap, key=lambda e: (-e[0], e[1]))
        return [(-d, item) for d, _, item in out]
