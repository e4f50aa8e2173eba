"""k-means for the IVF coarse quantizer: kmeans|| seeding + Lloyd (K6).

The JAX package's ``ops/kmeans.py`` with PyTorch inside. The Lloyd
iterations and the nearest-centroid assignment are a hand-written kernel on
the card (csrc/lloyd.cu) with plain versions here; kmeans|| seeding is plain
PyTorch (GEMM + topk + bincount) drawing from a ``torch.Generator``, so its
picks differ from the reference's ``jax.random`` ones. The host stopping
rule of :func:`kmeans_train_stepped` is the reference's, line for line.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import native
from .distance import pairwise_sq_l2, squared_norms


class TrainResult(NamedTuple):
    centroids: torch.Tensor  # [C, D] f32
    iterations: int
    converged: bool
    final_error: float  # mean squared assignment distance


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
    assignment kernel of csrc/lloyd.cu on CUDA tensors."""
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
    P, I = native.P, native.I
    native.call(
        "lloyd", "fvdb_assign", [P, P, P, I, I, I, P, P, P, P, P],
        x.data_ptr(), 0 if mask is None else mask.data_ptr(),
        centroids.data_ptr(), n, c, d, scratch.data_ptr(),
        scratch[n:].data_ptr(), assign.data_ptr(), d2.data_ptr(),
        native.stream_of(x))
    native.launches["assign_clusters"] += 1
    return assign, d2


def lloyd_step(x, mask, centroids):
    """One Lloyd iteration (plain): assign, then each cluster with rows
    moves to their mean; an empty cluster keeps its centroid. Returns
    (new_centroids, mean squared error over the masked-in rows)."""
    c = centroids.shape[0]
    assign, d2 = assign_clusters_plain(x, centroids, mask)
    ok = assign >= 0
    a = assign[ok].long()
    counts = torch.bincount(a, minlength=c).to(torch.float32)
    sums = torch.zeros_like(centroids).index_add_(0, a, x[ok].float())
    new = torch.where(counts[:, None] > 0,
                      sums / counts.clamp_min(1.0)[:, None], centroids)
    n_valid = mask.to(torch.float32).sum().clamp_min(1.0)
    return new, d2.sum() / n_valid


def lloyd_block_plain(x, mask, cents, steps: int):
    all_c, errs = [], []
    for _ in range(steps):
        cents, err = lloyd_step(x, mask, cents)
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
    # x_sq [N] | c_sq [C] | sums [C, D] | counts [C] | stats [2]
    scratch = torch.empty(n + c + c * d + c + 2, dtype=torch.float32,
                          device=dev)
    offs = np.cumsum([0, n, c, c * d, c])
    ptr = [scratch[int(o):].data_ptr() for o in offs]
    P, I = native.P, native.I
    native.call(
        "lloyd", "fvdb_lloyd_block",
        [P, P, P, I, I, I, I, P, P, P, P, P, P, P, P],
        x.data_ptr(), mask.data_ptr(), cents.data_ptr(), n, c, d, steps,
        *ptr, all_c.data_ptr(), errs.data_ptr(), native.stream_of(x))
    native.launches["lloyd_block"] += 1
    return all_c, errs


# ------------------------------------------------------------ kmeans||
def _gumbel(gen: torch.Generator, n: int, device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))


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
    """kmeans|| seeding (Bahmani et al., VLDB'12): ``rounds`` Gumbel-top-l
    samples weighted by d^2, candidates weighted by the population they
    attract, then weighted k-means++ over the small candidate set on the
    host."""
    dev = x.device
    n = x.shape[0]
    neg_inf = torch.full((n,), -float("inf"), device=dev)
    l = max(n_clusters * oversample // rounds, 1)
    x_sq = squared_norms(x)
    first = int(torch.argmax(torch.where(mask, 0.0, neg_inf)
                             + _gumbel(gen, n, dev)))
    d2 = torch.where(mask, pairwise_sq_l2(x[first][None], x, x_sq)[0], 0.0)
    cands = [x[first][None]]
    for _ in range(rounds):
        logw = torch.where(mask & (d2 > 0), torch.log(d2.clamp_min(1e-30)),
                           neg_inf)
        rows = torch.topk(logw + _gumbel(gen, n, dev), l).indices
        cand = x[rows]
        dc = pairwise_sq_l2(cand, x, x_sq)  # [l, N]
        d2 = torch.where(mask, torch.minimum(d2, dc.min(0).values), 0.0)
        cands.append(cand)
    cand = torch.cat(cands)
    nearest = torch.argmin(pairwise_sq_l2(x, cand), dim=1)
    w = torch.bincount(nearest[mask], minlength=cand.shape[0])
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=dev))
    out = _weighted_kmeanspp_host(
        cand.cpu().numpy().astype(np.float32),
        w.cpu().numpy().astype(np.float64) + 1e-9, n_clusters,
        np.random.default_rng(seed))
    return torch.from_numpy(out).to(dev)


def kmeans_train_stepped(seed: int, x, mask, n_clusters: int,
                         max_iterations: int = 25,
                         tol: float = 1e-4) -> TrainResult:
    """kmeans|| seeding, then Lloyd in blocks of 5 iterations a launch; the
    host stops at exactly the iteration a one-step loop would (relative
    error change < tol), with the same centroids and count."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    block = 5
    cents = kmeans_scalable_init(gen, x, mask, n_clusters)
    last_err = float("inf")
    i = 0
    converged = False
    err = 0.0
    while i < max_iterations and not converged:
        steps = min(block, max_iterations - i)
        all_c, errs = lloyd_block(x, mask, cents, steps)
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
