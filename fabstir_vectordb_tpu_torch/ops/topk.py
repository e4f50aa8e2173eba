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

import math

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
    csrc/merge_topk.cu's fvdb_masked_topk (a mask pass, then
    topk_select.cuh's radix select) or it raises."""
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
    for lo in range(0, b, _MAX_GRID_Q):  # the select's grid caps a launch
        hi = min(b, lo + _MAX_GRID_Q)
        masked = torch.empty((hi - lo, n), dtype=torch.float32, device=dev) \
            if mask is not None else None
        work = select_scratch("merge_topk", hi - lo, k, dev)
        m_ptr = 0 if mask is None else (mask[lo:hi].data_ptr() if m_stride
                                        else mask.data_ptr())
        native.call(
            "merge_topk", "fvdb_masked_topk", [P, P, L, I, I, I, P, P, P, P, P],
            dists[lo:hi].data_ptr(), m_ptr, m_stride, hi - lo, n, k,
            0 if masked is None else masked.data_ptr(), work.data_ptr(),
            out_d[lo:hi].data_ptr(), out_r[lo:hi].data_ptr(),
            native.stream_of(dists))
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


# candidates a query the shard merge sorts in shared memory
# (csrc/shard_merge.cu's MERGE_SMEM)
_MERGE_SMEM = 2048


def shard_merge(vals, rows, k: int, base=None, row_map=None):
    """K15's shard merge (the all_gather + top_k that ends each of the
    reference's sharded searches): vals [S, B, k_s] f32 and rows [S, B, k_s]
    int32, each shard's partial top-k with shard-local rows (-1: none).
    Shard s maps a row r >= 0 to base[s] + r (base [S] int32, None: zeros)
    or, with row_map (int32), to row_map[base[s] + r]. Returns the k
    smallest (vals [B, k], rows [B, k] global) by (distance, row), padded
    with (+inf, -1); rows < 0 and distances that are not finite never
    enter. The plain version on CPU tensors; on CUDA tensors
    csrc/shard_merge.cu (a bitonic sort in shared memory up to S * k_s =
    2,048, past it a buffer and topk_select.cuh's radix select), or it
    raises."""
    if vals.device.type == "cpu":
        return shard_merge_plain(vals, rows, k, base, row_map)
    if vals.device.type != "cuda":
        raise ValueError(f"shard_merge: unsupported device {vals.device}")
    dev = vals.device
    native.check(vals, "vals", torch.float32, 3, dev)
    native.check(rows, "rows", torch.int32, 3, dev)
    s, b, ks = vals.shape
    if base is None:
        base = torch.zeros(s, dtype=torch.int32, device=dev)
    native.check(base, "base", torch.int32, 1, dev)
    if row_map is not None:
        native.check(row_map, "row_map", torch.int32, 1, dev)
    if rows.shape != vals.shape or base.shape[0] != s or k < 1 or ks < 1:
        raise ValueError(f"shard_merge: vals {tuple(vals.shape)}, rows "
                         f"{tuple(rows.shape)}, base {tuple(base.shape)}, "
                         f"k={k}")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_r
    cand_d = cand_r = work = None
    if s * ks > _MERGE_SMEM:
        if b > _MAX_GRID_Q:
            raise ValueError(f"shard_merge takes at most {_MAX_GRID_Q} "
                             f"queries past {_MERGE_SMEM} candidates")
        cand_d = torch.empty((b, s * ks), dtype=torch.float32, device=dev)
        cand_r = torch.empty((b, s * ks), dtype=torch.int32, device=dev)
        work = select_scratch("shard_merge", b, k, dev)
    P, I = native.P, native.I
    native.call(
        "shard_merge", "fvdb_shard_merge",
        [P, P, P, P, I, I, I, I, P, P, P, P, P, P],
        vals.data_ptr(), rows.data_ptr(), base.data_ptr(),
        0 if row_map is None else row_map.data_ptr(), s, b, ks, k,
        0 if cand_d is None else cand_d.data_ptr(),
        0 if cand_r is None else cand_r.data_ptr(),
        0 if work is None else work.data_ptr(), out_d.data_ptr(),
        out_r.data_ptr(), native.stream_of(vals))
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
    (vals [B, k], idx [B, k] int32). Returns the new running pair, written
    to ``out`` (a pair of [B, k] tensors that are not the running ones)
    when given. The plain version on CPU tensors; on CUDA tensors
    csrc/merge_topk.cu's chunk step or it raises: at min(k, C) <= 256 and k
    <= 2,048 one launch, whose scratch ``work`` (:func:`chunk_scratch`,
    reused from step to step) is allocated when not given; above, the mask
    pass, the radix select of topk_select.cuh and K8's merge."""
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
    kc = min(k, c)
    if kc <= _FUSED_KC and k <= _FUSED_K:
        if work is None:
            work = chunk_scratch(b, c, kc, dev)
        return _fused_step(_fused_fn(), native.stream_of(d), d, mask, start,
                           vals, idx, k, out, work)
    native.check(d, "d", torch.float32, 2, dev)
    _check_mask(mask, b, c, dev)
    m_stride = c if mask is not None and mask.dim() == 2 else 0
    masked = torch.empty_like(d) if mask is not None else None
    cand_v = torch.empty((b, kc), dtype=torch.float32, device=dev)
    cand_r = torch.empty((b, kc), dtype=torch.int32, device=dev)
    work = select_scratch("merge_topk", b, kc, dev)
    P, I, L = native.P, native.I, native.L
    native.call(
        "merge_topk", "fvdb_chunk_step",
        [P, P, L, I, I, I, I, P, P, P, P, P, P, I, P, P, P],
        d.data_ptr(), 0 if mask is None else mask.data_ptr(), m_stride, b, c,
        kc, int(start), 0 if masked is None else masked.data_ptr(),
        work.data_ptr(), cand_v.data_ptr(), cand_r.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), k, out[0].data_ptr(),
        out[1].data_ptr(), native.stream_of(d))
    native.launches["chunk_step"] += 1
    return out


def _fused_fn():
    P, I, L = native.P, native.I, native.L
    return native.fn("merge_topk", "fvdb_chunk_step_fused",
                     [P, P, L, I, I, I, I, P, P, I, P, L, P, P, P])


def _fused_step(fn, stream: int, d, mask, start: int, vals, idx, k: int,
                out, work):
    """The fused chunk step's launch, its running and output pairs and
    scratch checked by the caller: d and the mask are checked here."""
    b, c = d.shape
    native.check(d, "d", torch.float32, 2, vals.device)
    _check_mask(mask, b, c, vals.device)
    err = fn(d.data_ptr(), 0 if mask is None else mask.data_ptr(),
             c if mask is not None and mask.dim() == 2 else 0, b, c,
             min(k, c), int(start), vals.data_ptr(), idx.data_ptr(), k,
             work.data_ptr(), work.numel(), out[0].data_ptr(),
             out[1].data_ptr(), stream)
    native.raise_on(err, "merge_topk", "fvdb_chunk_step_fused")
    native.launches["chunk_step"] += 1
    return out


def chunk_scratch(b: int, c: int, kc: int, device) -> torch.Tensor:
    """The fused chunk step's scratch for b queries of c distances at kc,
    zeroed (its arrival counts start at 0, and each step leaves them so)."""
    n = native.query("merge_topk", "fvdb_chunk_scratch_bytes",
                     [native.I, native.I, native.I], b, c, kc)
    return torch.zeros(n, dtype=torch.uint8, device=device)


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
    pairs, which the steps write in turn; at min(k, chunk) <= 256 the
    fused step's scratch is allocated at a stream's first run and kept
    (each step leaves it as it found it), and a chunk costs one C call with
    only the chunk's own tensors checked."""
    n_chunks = (n_total + chunk - 1) // chunk
    kc = min(k, chunk)
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
        if kc > _FUSED_KC or k > _FUSED_K:
            for i in range(n_chunks):
                d, m = dist_fn(i * chunk)
                vals, idx = chunk_step(d, m, i * chunk, vals, idx, k,
                                       bufs[(i + 1) % 2])
            return vals, idx
        stream = native.stream_of(vals)
        if (dev, stream) not in scratch:  # runs on one stream take turns
            scratch[dev, stream] = chunk_scratch(batch, chunk, kc, dev)
        work, fn = scratch[dev, stream], _fused_fn()
        for i in range(n_chunks):
            d, m = dist_fn(i * chunk)
            vals, idx = _fused_step(fn, stream, d, m, i * chunk, vals, idx,
                                    k, bufs[(i + 1) % 2], work)
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
    CPU tensors, csrc/approx_topk.cu on CUDA tensors."""
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
    for lo in range(0, b, _MAX_GRID_Q):  # the select's grid caps a launch
        hi = min(b, lo + _MAX_GRID_Q)
        bb = hi - lo
        # round ranges so that the grid fits one wave at 2 blocks an SM: a
        # few blocks past it would run as a second wave of their own
        tiles = math.ceil(bb / 32) * math.ceil(m / 256)
        z = max(1, min(rounds, 2 * _num_sms(dev) // tiles))
        i_per = math.ceil(rounds / z)
        z = math.ceil(rounds / i_per)
        keys = torch.empty((bb, m), dtype=torch.int64, device=dev)
        cand_d = torch.empty((bb, m), dtype=torch.float32, device=dev)
        cand_r = torch.empty((bb, m), dtype=torch.int32, device=dev)
        work = select_scratch("approx_topk", bb, ov_k, dev)
        m_ptr = 0 if mask is None else (mask[lo:hi].data_ptr() if m_stride
                                        else mask.data_ptr())
        native.call(
            "approx_topk", "fvdb_approx_pool",
            [P, I, I, P, P, L, P, I, I, I, I, I, I, I, P, P, P, P, P, P, P],
            x.data_ptr(), int(bf16), int(round_query), x_sq.data_ptr(),
            m_ptr, m_stride, q[lo:hi].data_ptr(), bb, n, d, m, ov_k, z,
            i_per, keys.data_ptr(), cand_d.data_ptr(), cand_r.data_ptr(),
            work.data_ptr(), out_d[lo:hi].data_ptr(), out_r[lo:hi].data_ptr(),
            native.stream_of(x))
        native.launches["approx_topk"] += 1
    return out_d, out_r


_SMS: dict = {}


def _num_sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device) \
            .multi_processor_count
    return _SMS[device]


# K1 keeps its lists in shared memory up to this k (csrc/l2_topk.cu)
_SMALL_K = 256
# the fused chunk step's reach (csrc/merge_topk.cu): min(k, C) and k
_FUSED_KC = 256
_FUSED_K = 2048
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
    query chunk to a buffer, then a radix select) or raises.

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
    # one counter a kernel: f32 rows, bf16 rows, bf16 rows with the query
    # rounded; the k > 256 path of f32 rows counts apart; cosine and dot
    # add their name
    counter = native.counter(
        "l2_topk_large" if k > _SMALL_K and not bf16 else "l2_topk", bf16,
        metric, rq=round_query)
    # bf16 entry points take round_q after their last int, then the metric
    rq = ([int(round_query)] if bf16 else []) + [METRIC_CODE[metric]]
    rq_t = ([I] if bf16 else []) + [I]
    if k > _SMALL_K:
        qc = max(1, min(b, _DUMP_BYTES // (4 * n), _MAX_GRID_Q))
        for lo in range(0, b, qc):
            hi = min(b, lo + qc)
            dump = torch.empty((hi - lo, n), dtype=torch.float32, device=dev)
            work = select_scratch("l2_topk", hi - lo, k, dev)
            native.call(
                "l2_topk", "fvdb_l2_topk_large_bf16" if bf16
                else "fvdb_l2_topk_large",
                [P, P, P, L, P, I, I, I, I, I, *rq_t, P, P, P, P, P, P],
                x.data_ptr(), sq_ptr, mask[lo:hi].data_ptr()
                if m_stride else m_ptr, m_stride,
                q[lo:hi].data_ptr(), hi - lo, n, d, k,
                _splits(hi - lo, n, dev), *rq, scratch_ptr, dump.data_ptr(),
                work.data_ptr(), out_d[lo:hi].data_ptr(),
                out_r[lo:hi].data_ptr(), native.stream_of(x))
            native.launches[counter] += 1
            # the norms of this x are in scratch now: later chunks reuse them
            sq_ptr = sq_ptr or scratch_ptr
        if row_base:
            out_r = torch.where(out_r >= 0, out_r + row_base, out_r)
        return out_d, out_r
    splits = _splits(b, n, dev)
    part_d = torch.empty((splits, b, k), dtype=torch.float32, device=dev)
    part_r = torch.empty((splits, b, k), dtype=torch.int32, device=dev)
    native.call(
        "l2_topk", "fvdb_l2_topk_bf16" if bf16 else "fvdb_l2_topk",
        [P, P, P, L, P, I, I, I, I, I, I, *rq_t, P, P, P, P, P, P],
        x.data_ptr(), sq_ptr, m_ptr, m_stride,
        q.data_ptr(), b, n, d, k, splits, row_base, *rq, scratch_ptr,
        part_d.data_ptr(), part_r.data_ptr(), out_d.data_ptr(),
        out_r.data_ptr(), native.stream_of(x))
    native.launches[counter] += 1
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
