"""Masked top-k selection, top-k merges, and the fused L2 top-k kernel (K1).

Smaller distance = better everywhere; entries that are masked out or not
finite surface as (+inf, -1). Ties go to the lower index, in the plain
versions (stable sorts) and in the kernel alike.
"""
from __future__ import annotations

import math

import torch

from ..utils import native
from .distance import pairwise_sq_l2

INF = float("inf")


def masked_topk(dists: torch.Tensor, mask: torch.Tensor, k: int):
    """Exact top-k smallest distances where mask is True.

    dists [B, N] f32; mask [N] or [B, N] bool. Returns (vals [B, k] f32,
    idx [B, k] int32), padded with +inf / -1 (also when k > N)."""
    if mask.dim() == 1:
        mask = mask[None, :]
    masked = torch.where(mask, dists, torch.full_like(dists, INF))
    vals, idx = torch.sort(masked, dim=1, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=INF)
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    valid = torch.isfinite(vals)
    return (torch.where(valid, vals, torch.full_like(vals, INF)),
            torch.where(valid, idx, torch.full_like(idx, -1)))


def merge_topk(vals_a, idx_a, vals_b, idx_b, k: int):
    """Merge two top-k result sets (same convention as masked_topk); ties
    keep the earlier position, as ``lax.top_k`` does."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    out_vals, pos = torch.sort(vals, dim=-1, stable=True)
    out_vals, pos = out_vals[..., :k], pos[..., :k]
    out_idx = torch.gather(idx, -1, pos)
    valid = torch.isfinite(out_vals)
    return (torch.where(valid, out_vals, torch.full_like(out_vals, INF)),
            torch.where(valid, out_idx, torch.full_like(out_idx, -1)))


def l2_topk_plain(x, x_sq, mask, q, k: int):
    """Plain version of K1: the [B, N] distance matrix, then masked_topk."""
    return masked_topk(pairwise_sq_l2(q, x, x_sq), mask, k)


_SMS: dict = {}


def _num_sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device) \
            .multi_processor_count
    return _SMS[device]


def l2_topk(x: torch.Tensor, x_sq: torch.Tensor, mask: torch.Tensor,
            q: torch.Tensor, k: int):
    """K1: masked squared-L2 exact top-k of q [B, D] over x [N, D].

    x_sq [N] f32 row norms; mask [N] or [B, N] bool; 1 <= k <= 256 on the
    card. Returns (vals [B, k] f32, rows [B, k] int32) sorted by (distance,
    row), padded with +inf / -1. On CPU tensors it runs the plain version;
    on CUDA tensors it launches the kernel (csrc/l2_topk.cu) or raises."""
    if x.device.type == "cpu":
        return l2_topk_plain(x, x_sq, mask, q, k)
    if x.device.type != "cuda":
        raise ValueError(f"l2_topk: unsupported device {x.device}")
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
    native.check(x_sq, "x_sq", torch.float32, 1, dev)
    native.check(q, "q", torch.float32, 2, dev)
    if mask.dim() not in (1, 2):
        raise ValueError("mask must be [N] or [B, N]")
    native.check(mask, "mask", torch.bool, mask.dim(), dev)
    n, d = x.shape
    b = q.shape[0]
    if q.shape[1] != d or x_sq.shape[0] != n or mask.shape[-1] != n:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, x_sq {tuple(x_sq.shape)}, "
            f"mask {tuple(mask.shape)}, q {tuple(q.shape)}")
    if mask.dim() == 2 and mask.shape[0] != b:
        raise ValueError("a [B, N] mask needs one row per query")
    if not 1 <= k <= 256:
        raise ValueError(f"l2_topk takes 1 <= k <= 256 on the card, got {k}")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return out_d.fill_(INF), out_r.fill_(-1)
    # split N so the grid is one wave: pass 1 holds 128 registers a thread,
    # so 2 blocks of 256 fit an SM; a second, partial wave would cost as
    # much as the first. Slices keep at least two 256-row tiles.
    q_tiles = math.ceil(b / 32)
    splits = max(1, min(math.ceil(n / 512),
                        2 * _num_sms(dev) // q_tiles))
    part_d = torch.empty((splits, b, k), dtype=torch.float32, device=dev)
    part_r = torch.empty((splits, b, k), dtype=torch.int32, device=dev)
    P, I = native.P, native.I
    native.call(
        "l2_topk", "fvdb_l2_topk",
        [P, P, P, native.ctypes.c_longlong, P, I, I, I, I, I, P, P, P, P, P],
        x.data_ptr(), x_sq.data_ptr(), mask.data_ptr(),
        n if mask.dim() == 2 else 0, q.data_ptr(), b, n, d, k, splits,
        part_d.data_ptr(), part_r.data_ptr(), out_d.data_ptr(),
        out_r.data_ptr(), native.stream_of(x))
    native.launches["l2_topk"] += 1
    return out_d, out_r


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
