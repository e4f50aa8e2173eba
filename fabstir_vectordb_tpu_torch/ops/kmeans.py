"""k-means: k-means++ and kmeans|| seeding (K7) + Lloyd (K6).

The JAX package's ``ops/kmeans.py`` with PyTorch inside. The Lloyd
iterations and the nearest-centroid assignment are a hand-written kernel on
the card (csrc/lloyd.cu: its distances on the tensor cores by three TF32
products, or on an FMA tile at the shapes that route does not take, as
:func:`lloyd_route` picks), which also runs an iteration in two halves for
the sharded Lloyd step (``lloyd_partial`` on each shard, ``lloyd_finish``
on the sums summed across the shards); the seeding's device programs (the
weighted pick, the min-distance table, the candidates' populations) are
csrc/kmeans_seed.cu, and k-means++ is one pick and one min-update a
centroid. Each has a plain version here, which the wrappers take on CPU
tensors. The seeding draws from a ``torch.Generator``, so its picks differ
from the reference's ``jax.random`` ones; kmeans||'s weighted k-means++
over the candidates runs on the host, as there. Lloyd stops by the
reference's rule, decided on the host after each block of iterations.
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
    E / w is the exponential race, the same draw as the reference's top-l of
    log w + Gumbel noise. ``unweighted_if_empty``: where no row is eligible
    for a weighted pick, the unweighted keys over the mask (k-means++'s
    fallback)."""
    key = _seed_key(d2, mask, u, weighted)
    if weighted and unweighted_if_empty:
        key = torch.where(torch.isfinite(key).any(), key,
                          _seed_key(d2, mask, u, False))
    vals, rows = torch.sort(key, stable=True)
    vals, rows = vals[:l], rows[:l].to(torch.int32)
    return torch.where(torch.isfinite(vals), rows, torch.full_like(rows, -1))


def seed_pick(d2, mask, u, l: int, weighted: bool = True, out=None,
              unweighted_if_empty: bool = False):
    """K7's pick (``_scalable_first`` / ``_scalable_round``): rows [l]
    int32, written into ``out`` when given. d2 [N] f32 (unused unweighted),
    mask [N] bool, u [N] uniform f32 from the caller's generator.
    ``unweighted_if_empty`` (k-means++): a weighted pick with no row of
    mask and d2 > 0 draws uniformly over the mask instead, decided on the
    card."""
    if mask.device.type == "cpu":
        rows = seed_pick_plain(d2, mask, u, l, weighted, unweighted_if_empty)
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
    fallback = weighted and unweighted_if_empty
    # key [N] | out_d [l] | the fallback's flag
    scratch = torch.empty(n + l + 1, dtype=torch.float32, device=dev)
    work = select_scratch("kmeans_seed", 1, l, dev)
    P, I = native.P, native.I
    native.call("kmeans_seed", "fvdb_seed_pick",
                [P, P, P, I, I, I, I, P, P, P, P, P, P],
                d2.data_ptr() if weighted else 0, mask.data_ptr(),
                u.data_ptr(), n, l, int(weighted), int(fallback),
                scratch[n + l:].data_ptr() if fallback else 0,
                scratch.data_ptr(), work.data_ptr(), scratch[n:].data_ptr(),
                out.data_ptr(), native.stream_of(mask))
    native.launches["seed_pick"] += 1
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


def _seed_args(x, mask, cand):
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
    native.check(mask, "mask", torch.bool, 1, dev)
    native.check(cand, "cand", torch.int32, 1, dev)
    n, d = x.shape
    if mask.shape[0] != n or cand.shape[0] < 1:
        raise ValueError("shape mismatch in the kmeans|| seeding")
    return n, d, cand.shape[0]


def seed_min_update(x, mask, d2, cand):
    """K7's min-distance table update (the second half of
    ``_scalable_first`` / ``_scalable_round``): a new d2 [N]."""
    if x.device.type == "cpu":
        return seed_min_update_plain(x, mask, d2, cand)
    n, d, c = _seed_args(x, mask, cand)
    native.check(d2, "d2", torch.float32, 1, x.device)
    out = torch.empty_like(d2)
    P, I = native.P, native.I
    native.call("kmeans_seed", "fvdb_seed_min_update",
                [P, P, P, I, I, I, P, P, P], x.data_ptr(), mask.data_ptr(),
                cand.data_ptr(), c, n, d, d2.data_ptr(), out.data_ptr(),
                native.stream_of(x))
    native.launches["seed_min_update"] += 1
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
    """K7's candidate weights (``_scalable_weights``): counts [C] int32."""
    if x.device.type == "cpu":
        return seed_counts_plain(x, mask, cand)
    n, d, c = _seed_args(x, mask, cand)
    out = torch.empty(c, dtype=torch.int32, device=x.device)
    P, I = native.P, native.I
    native.call("kmeans_seed", "fvdb_seed_counts", [P, P, P, I, I, I, P, P],
                x.data_ptr(), mask.data_ptr(), cand.data_ptr(), c, n, d,
                out.data_ptr(), native.stream_of(x))
    native.launches["seed_counts"] += 1
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


def _pp_rows(gen: torch.Generator, x, mask, n_clusters: int,
             plain: bool = False) -> torch.Tensor:
    """The rows [C] int32 that k-means++ picks: the first uniform over the
    mask, each next one with probability proportional to d2 (uniform over
    the mask where every d2 is 0), d2 then lowered by the new centroid.
    One uniform draw of N a pick from ``gen`` (on x's device). ``plain``:
    the plain versions of the pick and the update, on any device."""
    if n_clusters < 1:
        raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
    if not bool(mask.any()):
        raise ValueError("k-means++: no row in the mask")
    pick = seed_pick_plain if plain else seed_pick
    update = seed_min_update_plain if plain else seed_min_update
    dev = x.device
    n = x.shape[0]
    rows = torch.empty(n_clusters, dtype=torch.int32, device=dev)
    first = pick(None, mask, torch.rand(n, generator=gen, device=dev), 1,
                 False)
    rows[:1] = first
    d2 = update(x, mask, torch.full((n,), INF, device=dev), rows[:1])
    for i in range(1, n_clusters):
        rows[i:i + 1] = pick(d2, mask, torch.rand(n, generator=gen,
                                                  device=dev), 1, True,
                             unweighted_if_empty=True)
        if i + 1 < n_clusters:
            d2 = update(x, mask, d2, rows[i:i + 1])
    return rows


def kmeans_pp_init(gen: torch.Generator, x, mask, n_clusters: int):
    """k-means++ seeding over the rows of x [N, D] f32 in mask [N] bool:
    centroids [C, D], each a row of x. With more clusters than rows that
    can be told apart, the uniform fallback repeats rows. K7's pick and
    min-update kernels on the card, one pair a centroid, with no host
    read between them."""
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
