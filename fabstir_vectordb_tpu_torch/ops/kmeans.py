"""k-means: k-means++ and kmeans|| seeding (K7) + Lloyd (K6).

The JAX package's ``ops/kmeans.py`` with PyTorch inside. The Lloyd
iterations and the nearest-centroid assignment are a hand-written kernel on
the card (csrc/lloyd.cu: its distances on the tensor cores by three TF32
products, or on an FMA tile at the shapes that route does not take, as
:func:`lloyd_route` picks), which also runs an iteration in two halves for
the sharded Lloyd step (``lloyd_partial`` on each shard, ``lloyd_finish``
on the sums summed across the shards). The seeding is csrc/kmeans_seed.cu:
k-means++ is one launch for all its picks, and for every subspace of PQ's
training at once (:func:`kmeans_pp_rows`), drawing its uniforms from a
counter-based generator (Philox4x32-10, :func:`pp_uniforms`) keyed by one
draw from the caller's ``torch.Generator``; kmeans||'s device steps (the
weighted pick, the min-distance table, the candidates' populations) are a
kernel each: the pick one launch of one block where its keys fit shared
memory (:func:`seed_pick_route`), the other two on K6's tile pass where
:func:`lloyd_route` sends their shape. Each has a plain version here,
which the wrappers take on CPU tensors. The draws differ from the
reference's ``jax.random`` ones; kmeans||'s weighted k-means++ over the
candidates runs on the host, as there. Lloyd stops by the reference's
rule, decided on the host after each block of iterations.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import native
from .distance import pairwise_sq_l2, squared_norms
from .topk import INF, select_scratch


class TrainResult(NamedTuple):
    centroids: torch.Tensor  # [C, D] f32
    iterations: int
    converged: bool
    final_error: float  # mean squared assignment distance


# centroids below which K6 keeps its FMA tile: the tensor-core route takes
# them 128 a pass
LLOYD_TC_MIN_C = 64


def lloyd_route(n: int, c: int, d: int, aligned: bool = True) -> str:
    """K6's route for n rows of d dims against c centroids: "tf32x3" (the
    tensor cores, three TF32 products; TMA copies 16-byte rows) at d % 4
    == 0, c >= LLOYD_TC_MIN_C and rows and centroids 16-byte aligned,
    else "fma" (csrc/lloyd.cu's FMA tile)."""
    del n  # every row count takes either route
    return "tf32x3" if d % 4 == 0 and c >= LLOYD_TC_MIN_C and aligned \
        else "fma"


def _lloyd_args(x, cents, base: str):
    """(tc flag, the parts' scratch [2, C, D] or None, the launch
    counter) of a K6 call on CUDA tensors."""
    aligned = x.data_ptr() % 16 == 0 and cents.data_ptr() % 16 == 0
    c, d = cents.shape
    tc = lloyd_route(x.shape[0], c, d, aligned) == "tf32x3"
    parts = (torch.empty(2 * c * d, dtype=torch.float32, device=x.device)
             if tc else None)
    return int(tc), parts, base if tc else f"{base}_fma"


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _lloyd_scratch(n: int, c: int, d: int, dev):
    """One f32 scratch of a Lloyd call and the pointers to its parts: sums
    [C, D] first (the tensor-core route adds rows into them 16 bytes at a
    time), then x_sq [N], c_sq [C], counts [C], stats [2]."""
    scratch = torch.empty(c * d + n + c + c + 2, dtype=torch.float32,
                          device=dev)
    offs = np.cumsum([0, c * d, n, c, c])
    return scratch, [scratch[int(o):].data_ptr() for o in offs]


def assign_clusters_plain(x, centroids, mask=None, c_sq=None):
    d = pairwise_sq_l2(x, centroids, c_sq)  # [N, C]
    assign = torch.argmin(d, dim=1).to(torch.int32)  # first minimum
    d2 = torch.gather(d, 1, assign[:, None].long())[:, 0]
    if mask is not None:
        assign = torch.where(mask, assign, torch.full_like(assign, -1))
        d2 = torch.where(mask, d2, torch.zeros_like(d2))
    return assign, d2


def assign_clusters(x, centroids, mask=None):
    """Nearest-centroid assignment: (assign [N] int32, d2 [N] f32); rows
    outside ``mask`` get -1 and 0. The plain version on CPU tensors, the
    assignment kernel of csrc/lloyd.cu on CUDA tensors (its route by
    :func:`lloyd_route`)."""
    if x.device.type == "cpu":
        return assign_clusters_plain(x, centroids, mask)
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
    native.check(centroids, "centroids", torch.float32, 2, dev)
    if mask is not None:
        native.check(mask, "mask", torch.bool, 1, dev)
    n, d = x.shape
    c = centroids.shape[0]
    if centroids.shape[1] != d or (mask is not None and mask.shape[0] != n):
        raise ValueError("shape mismatch in assign_clusters")
    assign = torch.empty(n, dtype=torch.int32, device=dev)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return assign, d2
    scratch = torch.empty(n + c, dtype=torch.float32, device=dev)
    tc, parts, name = _lloyd_args(x, centroids, "assign_clusters")
    P, I = native.P, native.I
    native.call(
        "lloyd", "fvdb_assign", [P, P, P, I, I, I, I, P, P, P, P, P, P],
        x.data_ptr(), 0 if mask is None else mask.data_ptr(),
        centroids.data_ptr(), n, c, d, tc, scratch.data_ptr(),
        scratch[n:].data_ptr(), _ptr(parts), assign.data_ptr(),
        d2.data_ptr(), native.stream_of(x))
    native.launches[name] += 1
    native.count_shape(name, f"N={n} C={c} D={d}")
    return assign, d2


def lloyd_step_plain(x, mask, centroids):
    """Plain version of :func:`lloyd_step`."""
    c = centroids.shape[0]
    assign, d2 = assign_clusters_plain(x, centroids, mask)
    ok = assign >= 0
    a = assign[ok].long()
    counts = torch.bincount(a, minlength=c).to(torch.float32)
    sums = torch.zeros_like(centroids).index_add_(0, a, x[ok].float())
    new = torch.where(counts[:, None] > 0,
                      sums / counts.clamp_min(1.0)[:, None], centroids)
    n_valid = (x.new_tensor(float(x.shape[0])) if mask is None
               else mask.to(torch.float32).sum()).clamp_min(1.0)
    return new, d2.sum() / n_valid


def lloyd_step(x, mask, centroids):
    """One Lloyd iteration (the reference's lloyd_step, ``ops/kmeans.py:84``):
    assign each row of x [N, D] f32 in mask [N] bool (None: every row) to
    the nearest of centroids [C, D] f32; a cluster with rows moves to their
    mean, an empty one keeps its centroid. Returns (new centroids [C, D],
    the error sum(d2) / max(rows in the mask, 1) as a 0-dim tensor). The
    plain version on CPU tensors; on CUDA tensors csrc/lloyd.cu's
    fvdb_lloyd_step (K6's partial and finish, one iteration of a K6 block)
    or it raises."""
    if x.device.type == "cpu":
        return lloyd_step_plain(x, mask, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"lloyd_step: unsupported device {x.device}")
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
    native.check(centroids, "centroids", torch.float32, 2, dev)
    if mask is not None:
        native.check(mask, "mask", torch.bool, 1, dev)
    n, d = x.shape
    c = centroids.shape[0]
    if centroids.shape[1] != d or c < 1 or n < 1 \
            or (mask is not None and mask.shape[0] != n):
        raise ValueError("shape mismatch in lloyd_step")
    new = torch.empty_like(centroids)
    err = torch.empty(1, dtype=torch.float32, device=dev)
    scratch, (sums, x_sq, c_sq, counts, stats) = _lloyd_scratch(n, c, d,
                                                                dev)
    tc, parts, name = _lloyd_args(x, centroids, "lloyd_step")
    P, I = native.P, native.I
    native.call(
        "lloyd", "fvdb_lloyd_step",
        [P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P],
        x.data_ptr(), 0 if mask is None else mask.data_ptr(),
        centroids.data_ptr(), n, c, d, tc, x_sq, c_sq, _ptr(parts), sums,
        counts, stats, new.data_ptr(), err.data_ptr(), native.stream_of(x))
    native.launches[name] += 1
    native.count_shape(name, f"N={n} C={c} D={d}")
    return new, err[0]


def lloyd_block_plain(x, mask, cents, steps: int):
    all_c, errs = [], []
    for _ in range(steps):
        cents, err = lloyd_step_plain(x, mask, cents)
        all_c.append(cents)
        errs.append(err)
    return torch.stack(all_c), torch.stack(errs)


def lloyd_block(x, mask, cents, steps: int):
    """K6: ``steps`` Lloyd iterations with every intermediate stacked:
    (centroids [steps, C, D], errors [steps]), so the host can stop at the
    exact iteration a one-step loop would. x [N, D] f32, mask [N] bool,
    cents [C, D] f32. The plain version on CPU tensors, csrc/lloyd.cu on
    CUDA tensors."""
    if x.device.type == "cpu":
        return lloyd_block_plain(x, mask, cents, steps)
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
    native.check(mask, "mask", torch.bool, 1, dev)
    native.check(cents, "cents", torch.float32, 2, dev)
    n, d = x.shape
    c = cents.shape[0]
    if cents.shape[1] != d or mask.shape[0] != n or n == 0 or steps < 1:
        raise ValueError("shape mismatch in lloyd_block")
    all_c = torch.empty((steps, c, d), dtype=torch.float32, device=dev)
    errs = torch.empty(steps, dtype=torch.float32, device=dev)
    scratch, (sums, x_sq, c_sq, counts, stats) = _lloyd_scratch(n, c, d,
                                                                dev)
    tc, parts, name = _lloyd_args(x, cents, "lloyd_block")
    P, I = native.P, native.I
    native.call(
        "lloyd", "fvdb_lloyd_block",
        [P, P, P, I, I, I, I, I, P, P, P, P, P, P, P, P, P],
        x.data_ptr(), mask.data_ptr(), cents.data_ptr(), n, c, d, steps, tc,
        x_sq, c_sq, _ptr(parts), sums, counts, stats, all_c.data_ptr(),
        errs.data_ptr(), native.stream_of(x))
    native.launches[name] += 1
    native.count_shape(name, f"N={n} C={c} D={d} steps={steps}")
    return all_c, errs


def lloyd_partial_plain(x, mask, cents):
    """Plain version of K6's partial: (sums [C, D], counts [C], stats [2] =
    (sum of d2, rows in the mask)) of one shard's rows."""
    c = cents.shape[0]
    assign, d2 = assign_clusters_plain(x, cents, mask)
    ok = assign >= 0
    a = assign[ok].long()
    counts = torch.bincount(a, minlength=c).to(torch.float32)
    sums = torch.zeros_like(cents).index_add_(0, a, x[ok].float())
    stats = torch.stack([d2.sum(), mask.to(torch.float32).sum()])
    return sums, counts, stats


def lloyd_partial(x, mask, cents):
    """K6's first half, K15's per-shard Lloyd work (the reference's
    sharded_lloyd_step body before its psums): assign each row of x [N, D]
    f32 in mask [N] bool to the nearest of cents [C, D] and return (sums
    [C, D], counts [C], stats [2] = (sum of d2, rows in the mask)), to be
    summed across the shards and handed to :func:`lloyd_finish`. N may be
    0. The plain version on CPU tensors, csrc/lloyd.cu's fvdb_lloyd_partial
    on CUDA tensors."""
    if x.device.type == "cpu":
        return lloyd_partial_plain(x, mask, cents)
    if x.device.type != "cuda":
        raise ValueError(f"lloyd_partial: unsupported device {x.device}")
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
    native.check(mask, "mask", torch.bool, 1, dev)
    native.check(cents, "cents", torch.float32, 2, dev)
    n, d = x.shape
    c = cents.shape[0]
    if cents.shape[1] != d or mask.shape[0] != n or c < 1:
        raise ValueError("shape mismatch in lloyd_partial")
    sums = torch.empty((c, d), dtype=torch.float32, device=dev)
    counts = torch.empty(c, dtype=torch.float32, device=dev)
    stats = torch.empty(2, dtype=torch.float32, device=dev)
    scratch = torch.empty(n + c, dtype=torch.float32, device=dev)
    tc, parts, name = _lloyd_args(x, cents, "lloyd_partial")
    P, I = native.P, native.I
    native.call(
        "lloyd", "fvdb_lloyd_partial",
        [P, P, P, I, I, I, I, P, P, P, P, P, P, P],
        x.data_ptr(), mask.data_ptr(), cents.data_ptr(), n, c, d, tc,
        scratch.data_ptr(), scratch[n:].data_ptr(), _ptr(parts),
        sums.data_ptr(), counts.data_ptr(), stats.data_ptr(),
        native.stream_of(x))
    native.launches[name] += 1
    native.count_shape(name, f"N={n} C={c} D={d}")
    return sums, counts, stats


def lloyd_finish_plain(sums, counts, stats, cents):
    new = torch.where(counts[:, None] > 0,
                      sums / counts.clamp_min(1.0)[:, None], cents)
    return new, stats[0] / stats[1].clamp_min(1.0)


def lloyd_finish(sums, counts, stats, cents):
    """K6's second half: from the summed (sums [C, D], counts [C], stats
    [2]) of :func:`lloyd_partial`, the new centroids (a cluster with rows
    moves to their mean, an empty one keeps its row of cents [C, D]) and
    the error sum(d2) / max(rows, 1), a 0-dim tensor. The plain version on
    CPU tensors, csrc/lloyd.cu's fvdb_lloyd_finish on CUDA tensors."""
    if cents.device.type == "cpu":
        return lloyd_finish_plain(sums, counts, stats, cents)
    if cents.device.type != "cuda":
        raise ValueError(f"lloyd_finish: unsupported device {cents.device}")
    dev = cents.device
    native.check(sums, "sums", torch.float32, 2, dev)
    native.check(counts, "counts", torch.float32, 1, dev)
    native.check(stats, "stats", torch.float32, 1, dev)
    native.check(cents, "cents", torch.float32, 2, dev)
    c, d = cents.shape
    if sums.shape != (c, d) or counts.shape[0] != c or stats.shape[0] != 2:
        raise ValueError("shape mismatch in lloyd_finish")
    new = torch.empty_like(cents)
    err = torch.empty(1, dtype=torch.float32, device=dev)
    P, I = native.P, native.I
    native.call("lloyd", "fvdb_lloyd_finish", [P, P, P, P, I, I, P, P, P],
                sums.data_ptr(), counts.data_ptr(), stats.data_ptr(),
                cents.data_ptr(), c, d, new.data_ptr(), err.data_ptr(),
                native.stream_of(cents))
    native.launches["lloyd_finish"] += 1
    return new, err[0]


# ------------------------------------------------------------ kmeans||
def _seed_key(d2, mask, u, weighted: bool):
    """The pick's key: E / max(d2, 1e-30) (E / 1 unweighted) with E =
    -log(u), +inf outside the mask or where d2 is 0."""
    e = -torch.log(u.clamp(1e-20, 1.0 - 1e-7))
    if not weighted:
        return torch.where(mask, e, INF)
    return torch.where(mask & (d2 > 0), e / d2.clamp_min(1e-30), INF)


def seed_pick_plain(d2, mask, u, l: int, weighted: bool = True,
                    unweighted_if_empty: bool = False):
    """Plain version of the kmeans|| pick: the ``l`` rows of least key
    (ties to the lower row), -1 past the eligible rows. Picking the least
    E / w is the exponential race, the same draw as the reference's top-l
    of log w + Gumbel noise. Where l exceeds the rows it still gives l, -1
    past them: the port's own contract (its kernels write l rows), which
    the reference's top-l, asked for no more than its rows, has no case
    for.
    ``unweighted_if_empty``: where no row is eligible for a weighted pick,
    the unweighted keys over the mask (k-means++'s fallback)."""
    key = _seed_key(d2, mask, u, weighted)
    if weighted and unweighted_if_empty:
        key = torch.where(torch.isfinite(key).any(), key,
                          _seed_key(d2, mask, u, False))
    vals, rows = torch.sort(key, stable=True)
    vals, rows = vals[:l], rows[:l].to(torch.int32)
    rows = torch.where(torch.isfinite(vals), rows, torch.full_like(rows, -1))
    if rows.shape[0] < l:  # l past the rows: -1 past them too
        rows = torch.cat([rows, rows.new_full((l - rows.shape[0],), -1)])
    return rows


# csrc/kmeans_seed.cu's PICK_SMEM: the bytes of shared memory that the
# one-block pick's keys may take (N keys and its candidates, 8 bytes each)
PICK_SMEM_BYTES = 229_376


def seed_pick_route(n: int, l: int) -> str:
    """The pick's route for n rows at l: "block" (csrc/kmeans_seed.cu's
    one-block kernel: every key and its candidates, max(2 pow2(min(l, n)),
    1,024) of them, in one block's shared memory, one launch) where their 8
    bytes each fit PICK_SMEM_BYTES (27,648 rows at l = 409), else "radix"
    (the key kernel and topk_select.cuh's radix select over the grid)."""
    cand = max(2 << (min(l, n) - 1).bit_length(), 1024)
    return "block" if 8 * (n + cand) <= PICK_SMEM_BYTES else "radix"


def seed_pick(d2, mask, u, l: int, weighted: bool = True, out=None):
    """K7's kmeans|| pick (``_scalable_first`` / ``_scalable_round``): rows
    [l] int32, written into ``out`` when given. d2 [N] f32 (unused
    unweighted), mask [N] bool, u [N] uniform f32 from the caller's
    generator. On the card by the route :func:`seed_pick_route` picks
    (counted as "seed_pick" in one block, "seed_pick_radix" past it)."""
    if mask.device.type == "cpu":
        rows = seed_pick_plain(d2, mask, u, l, weighted)
        if out is None:
            return rows
        out.copy_(rows)
        return out
    dev = mask.device
    native.check(mask, "mask", torch.bool, 1, dev)
    native.check(u, "u", torch.float32, 1, dev)
    n = mask.shape[0]
    if weighted:
        native.check(d2, "d2", torch.float32, 1, dev)
    if u.shape[0] != n or (weighted and d2.shape[0] != n) or l < 1:
        raise ValueError("shape mismatch in seed_pick")
    if out is None:
        out = torch.empty(l, dtype=torch.int32, device=dev)
    native.check(out, "out", torch.int32, 1, dev)
    if out.shape[0] != l:
        raise ValueError(f"seed_pick: out holds {out.shape[0]} rows, not {l}")
    P, I = native.P, native.I
    d2_ptr = d2.data_ptr() if weighted else 0
    if seed_pick_route(n, l) == "block":
        native.call("kmeans_seed", "fvdb_seed_pick_block",
                    [P, P, P, I, I, I, P, P], d2_ptr, mask.data_ptr(),
                    u.data_ptr(), n, l, int(weighted), out.data_ptr(),
                    native.stream_of(mask))
        name = "seed_pick"
    else:
        scratch = torch.empty(n + l, dtype=torch.float32, device=dev)
        work = select_scratch("kmeans_seed", 1, l, dev)
        native.call("kmeans_seed", "fvdb_seed_pick",
                    [P, P, P, I, I, I, P, P, P, P, P], d2_ptr,
                    mask.data_ptr(), u.data_ptr(), n, l, int(weighted),
                    scratch.data_ptr(), work.data_ptr(),
                    scratch[n:].data_ptr(), out.data_ptr(),
                    native.stream_of(mask))
        name = "seed_pick_radix"
    native.launches[name] += 1
    native.count_shape(name, f"N={n} l={l}")
    return out


def seed_min_update_plain(x, mask, d2, cand):
    """Plain version of the min-distance table update: where mask, min(d2,
    min_j |c_j - x|^2) over the candidate rows ``cand`` (-1: skipped), else
    0."""
    ok = cand >= 0
    c = x[cand.clamp_min(0).long()]
    dc = pairwise_sq_l2(c, x, squared_norms(x))  # [C, N]
    dc = torch.where(ok[:, None], dc, INF)
    return torch.where(mask, torch.minimum(d2, dc.min(0).values),
                       torch.zeros_like(d2))


def _seed_args(x, mask, cand, base: str):
    """(n, d, c, tc, the launch counter) of a kmeans|| table update or
    count on CUDA tensors: the tile pass where :func:`lloyd_route` sends c
    candidates of d dims, else the FMA route ("<base>_fma")."""
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
    native.check(mask, "mask", torch.bool, 1, dev)
    native.check(cand, "cand", torch.int32, 1, dev)
    n, d = x.shape
    c = cand.shape[0]
    if mask.shape[0] != n or c < 1:
        raise ValueError("shape mismatch in the kmeans|| seeding")
    tc = lloyd_route(n, c, d, x.data_ptr() % 16 == 0) == "tf32x3"
    return n, d, c, tc, base if tc else f"{base}_fma"


def _tile_scratch(c: int, d: int, extra: int, dev):
    """The tile pass's scratch: the candidates' TF32 parts [2, C, D] (16-byte
    aligned at the start), their f32 rows [C, D] and norms [C], then
    ``extra`` floats."""
    return torch.empty(3 * c * d + c + extra, dtype=torch.float32,
                       device=dev)


def seed_min_update(x, mask, d2, cand):
    """K7's min-distance table update (the second half of
    ``_scalable_first`` / ``_scalable_round``): a new d2 [N]. On CUDA
    tensors K6's tile pass with its table epilogue, or the FMA route at
    the shapes :func:`lloyd_route` keeps off the tensor cores."""
    if x.device.type == "cpu":
        return seed_min_update_plain(x, mask, d2, cand)
    n, d, c, tc, name = _seed_args(x, mask, cand, "seed_min_update")
    native.check(d2, "d2", torch.float32, 1, x.device)
    out = torch.empty_like(d2)
    scratch = _tile_scratch(c, d, 0, x.device) if tc else None
    P, I = native.P, native.I
    native.call("kmeans_seed", "fvdb_seed_min_update",
                [P, P, P, I, I, I, P, P, I, P, P], x.data_ptr(),
                mask.data_ptr(), cand.data_ptr(), c, n, d, d2.data_ptr(),
                out.data_ptr(), int(tc), _ptr(scratch), native.stream_of(x))
    native.launches[name] += 1
    native.count_shape(name, f"N={n} C={c} D={d}")
    return out


def seed_counts_plain(x, mask, cand):
    """Plain version of ``_scalable_weights``: how many masked rows have
    each candidate (-1: none) as their nearest (the first of least
    distance)."""
    c = x[cand.clamp_min(0).long()]
    d = pairwise_sq_l2(x, c)  # [N, C]
    d = torch.where((cand >= 0)[None, :], d, INF)
    nearest = torch.argmin(d, dim=1)
    return torch.bincount(nearest[mask], minlength=cand.shape[0]) \
        .to(torch.int32)


def seed_counts(x, mask, cand):
    """K7's candidate weights (``_scalable_weights``): counts [C] int32. On
    CUDA tensors K6's tile pass with its nearest-candidate epilogue and a
    histogram, or the FMA route (as :func:`seed_min_update`)."""
    if x.device.type == "cpu":
        return seed_counts_plain(x, mask, cand)
    n, d, c, tc, name = _seed_args(x, mask, cand, "seed_counts")
    out = torch.empty(c, dtype=torch.int32, device=x.device)
    # then the rows' packed (distance, candidate) [N] int64, 8-byte aligned
    scratch = _tile_scratch(c, d, 2 * n + 1, x.device) if tc else None
    best = 0 if scratch is None else \
        scratch[3 * c * d + c + c % 2:].data_ptr()
    P, I = native.P, native.I
    native.call("kmeans_seed", "fvdb_seed_counts",
                [P, P, P, I, I, I, P, I, P, P, P], x.data_ptr(),
                mask.data_ptr(), cand.data_ptr(), c, n, d, out.data_ptr(),
                int(tc), _ptr(scratch), best, native.stream_of(x))
    native.launches[name] += 1
    native.count_shape(name, f"N={n} C={c} D={d}")
    return out


def _weighted_kmeanspp_host(cand: np.ndarray, w: np.ndarray, k: int,
                            rng: np.random.Generator) -> np.ndarray:
    """Classic k-means++ over a small weighted candidate set (host numpy)."""
    c_n = cand.shape[0]
    first = int(rng.choice(c_n, p=w / w.sum()))
    chosen = [first]
    d2 = ((cand - cand[first]) ** 2).sum(1)
    for _ in range(1, k):
        p = w * d2
        s = p.sum()
        if not np.isfinite(s) or s <= 0:
            nxt = int(rng.integers(0, c_n))
        else:
            nxt = int(rng.choice(c_n, p=p / s))
        chosen.append(nxt)
        nd = ((cand - cand[nxt]) ** 2).sum(1)
        np.minimum(d2, nd, out=d2)
    return cand[np.asarray(chosen)]


def kmeans_scalable_init(gen: torch.Generator, x, mask, n_clusters: int,
                         rounds: int = 5, oversample: int = 8) -> torch.Tensor:
    """kmeans|| seeding (Bahmani et al., VLDB'12): a uniform first pick,
    ``rounds`` picks of l rows weighted by d^2, each followed by the
    min-distance table update, the candidates weighted by the population
    they attract, then weighted k-means++ over the small candidate set on
    the host. The device steps are K7's kernels on the card."""
    dev = x.device
    n = x.shape[0]
    l = max(n_clusters * oversample // rounds, 1)
    cand = torch.empty(1 + rounds * l, dtype=torch.int32, device=dev)
    seed_pick(None, mask, torch.rand(n, generator=gen, device=dev), 1,
              weighted=False, out=cand[:1])
    d2 = seed_min_update(x, mask, torch.full((n,), INF, device=dev),
                         cand[:1])
    for r in range(rounds):
        part = cand[1 + r * l:1 + (r + 1) * l]
        seed_pick(d2, mask, torch.rand(n, generator=gen, device=dev), l,
                  out=part)
        d2 = seed_min_update(x, mask, d2, part)
    w = seed_counts(x, mask, cand)
    keep = cand.cpu().numpy() >= 0  # a pick short of eligible rows is -1
    if not keep.any():
        raise ValueError("kmeans|| seeding: no row to seed from")
    picked = x[cand.clamp_min(0).long()].cpu().numpy()[keep]
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=dev))
    out = _weighted_kmeanspp_host(
        picked.astype(np.float32),
        w.cpu().numpy()[keep].astype(np.float64) + 1e-9, n_clusters,
        np.random.default_rng(seed))
    return torch.from_numpy(out).to(dev)


# ------------------------------------------------------------ k-means++
_M32 = 0xFFFFFFFF


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of a * b for a < 2^32 and int64 b < 2^32,
    with b cut into 16-bit halves so that no product passes 2^48."""
    p_lo, p_hi = a * (b & 0xFFFF), a * (b >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) of the counter words (int64
    tensors < 2^32, broadcast together) under key (k0, k1): the four output
    words, as csrc/kmeans_seed.cu computes them."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _M32
        k1 = (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def pp_uniforms(seed: int, subs, step: int, n: int, device=None):
    """k-means++'s uniforms in (0, 1) for rows 0..n-1 at ``step`` of each
    subspace in ``subs``: [len(subs), n] f32. Row r's is word r % 4 of
    Philox4x32-10 of counter (r // 4, step, subspace, 0) under key (seed's
    low and high 32 bits), taken as (2 (w >> 9) + 1) / 2^24, so a draw
    depends on (seed, subspace, step, row) alone."""
    subs = torch.as_tensor(list(subs), dtype=torch.int64, device=device)
    quads = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10(quads[None, :], zero + step, subs[:, None], zero,
                          seed & _M32, (seed >> 32) & _M32)
    w = torch.stack(torch.broadcast_tensors(*words), -1)  # [S, n/4, 4]
    w = w.reshape(subs.shape[0], -1)[:, :n]
    return (((w >> 9) << 1) | 1).to(torch.float32) * 2.0 ** -24


def pp_seed(gen: torch.Generator) -> int:
    """The 62-bit Philox key of a k-means++ call: one draw from ``gen``."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))


def kmeans_pp_rows_plain(seed: int, x, mask, n_clusters: int,
                         n_sub: int = 1):
    """Plain version of :func:`kmeans_pp_rows`, a step at a time: each
    subspace's table lowered by its last pick (the kmeans|| min-update),
    then its pick by the exponential race over :func:`pp_uniforms` (the
    kmeans|| pick with k-means++'s fallback)."""
    n, d = x.shape
    ds = d // n_sub
    subs = [x[:, m * ds:(m + 1) * ds] for m in range(n_sub)]
    rows = torch.empty((n_sub, n_clusters), dtype=torch.int32,
                       device=x.device)
    d2 = [torch.full((n,), INF, device=x.device)] * n_sub
    for i in range(n_clusters):
        u = pp_uniforms(seed, range(n_sub), i, n, x.device)
        for m in range(n_sub):
            if i > 0:
                d2[m] = seed_min_update_plain(subs[m], mask, d2[m],
                                              rows[m, i - 1:i])
            rows[m, i:i + 1] = seed_pick_plain(d2[m], mask, u[m], 1, i > 0,
                                               unweighted_if_empty=True)
    return rows


def kmeans_pp_rows(seed: int, x, mask, n_clusters: int, n_sub: int = 1,
                   plain: bool = False):
    """The rows [n_sub, C] int32 that k-means++ picks in each of the
    ``n_sub`` subspaces of x [N, D] (equal column blocks), rows in mask [N]
    bool: the first uniform over the mask, each next one with probability
    proportional to d2 (uniform over the mask where every d2 is 0), d2 then
    lowered by the new centroid (the reference's kmeans_pp_init, vmapped
    over the subspaces as its pq_train does). ``seed`` keys the draws
    (:func:`pp_uniforms`). On CUDA tensors one launch of
    csrc/kmeans_seed.cu's fvdb_kmeans_pp for every pick of every subspace;
    ``plain`` or CPU tensors: :func:`kmeans_pp_rows_plain`."""
    if n_clusters < 1:
        raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
    if x.shape[1] % n_sub != 0:
        raise ValueError(f"dim {x.shape[1]} not divisible by {n_sub}")
    if not bool(mask.any()):
        raise ValueError("k-means++: no row in the mask")
    if plain or x.device.type == "cpu":
        return kmeans_pp_rows_plain(seed, x, mask, n_clusters, n_sub)
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
    native.check(mask, "mask", torch.bool, 1, dev)
    n, d = x.shape
    if mask.shape[0] != n:
        raise ValueError("shape mismatch in kmeans_pp_rows")
    rows = torch.empty((n_sub, n_clusters), dtype=torch.int32, device=dev)
    P, I, U = native.P, native.I, native.U
    nbytes = native.query("kmeans_seed", "fvdb_kmeans_pp_scratch_bytes",
                          [I, I], n, n_sub)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    native.call("kmeans_seed", "fvdb_kmeans_pp",
                [P, P, I, I, I, I, U, U, P, P, P], x.data_ptr(),
                mask.data_ptr(), n, d, n_sub, n_clusters, seed & _M32,
                (seed >> 32) & _M32, scratch.data_ptr(), rows.data_ptr(),
                native.stream_of(x))
    native.launches["kmeans_pp"] += 1
    native.count_shape("kmeans_pp",
                       f"M={n_sub} N={n} Ds={d // n_sub} C={n_clusters}")
    return rows


def _pp_rows(gen: torch.Generator, x, mask, n_clusters: int,
             plain: bool = False) -> torch.Tensor:
    """k-means++'s rows [C] int32 over x [N, D] (one subspace), keyed by
    one draw from ``gen`` (on x's device)."""
    return kmeans_pp_rows(pp_seed(gen), x, mask, n_clusters, 1, plain)[0]


def kmeans_pp_init(gen: torch.Generator, x, mask, n_clusters: int):
    """k-means++ seeding over the rows of x [N, D] f32 in mask [N] bool:
    centroids [C, D], each a row of x. With more clusters than rows that
    can be told apart, the uniform fallback repeats rows. One launch of
    K7's k-means++ kernel on the card."""
    return x[_pp_rows(gen, x, mask, n_clusters).long()]


def _lloyd_until(x, mask, init, max_iterations: int = 25,
                 tol: float = 1e-4, block=lloyd_block) -> TrainResult:
    """Lloyd from ``init`` until ``max_iterations`` or, past the first
    iteration, a relative error change below ``tol`` (the first previous
    error is f32's max), as the reference's while loop; ``block`` runs 5
    iterations a launch and the host stops at exactly the iteration a
    one-step loop would, with its centroids and count."""
    step = 5
    cents = init
    last_err = float(np.finfo(np.float32).max)
    i = 0
    converged = False
    err = 0.0
    while i < max_iterations and not converged:
        steps = min(step, max_iterations - i)
        all_c, errs = block(x, mask, cents, steps)
        errs_h = errs.cpu().numpy().astype(np.float64)
        stop = None
        for j in range(steps):
            err_f = float(errs_h[j])
            if (i + j > 0
                    and abs(last_err - err_f) / max(last_err, 1e-30) < tol):
                converged = True
                stop = j
                break
            last_err = err_f
        j = steps - 1 if stop is None else stop
        cents = all_c[j].contiguous()
        err = float(errs_h[j])
        i += j + 1
    return TrainResult(cents, i, converged, err)


def kmeans_train(gen: torch.Generator, x, mask, n_clusters: int,
                 max_iterations: int = 25, tol: float = 1e-4) -> TrainResult:
    """k-means++ seeding, then Lloyd until the relative error change is
    below ``tol`` or ``max_iterations`` (the reference's kmeans_train)."""
    init = kmeans_pp_init(gen, x, mask, n_clusters)
    return _lloyd_until(x, mask, init, max_iterations, tol)


def kmeans_train_stepped(seed: int, x, mask, n_clusters: int,
                         max_iterations: int = 25,
                         tol: float = 1e-4) -> TrainResult:
    """kmeans|| seeding, then Lloyd in blocks of 5 iterations a launch; the
    host stops at exactly the iteration a one-step loop would (relative
    error change < tol), with the same centroids and count."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    cents = kmeans_scalable_init(gen, x, mask, n_clusters)
    return _lloyd_until(x, mask, cents, max_iterations, tol)
