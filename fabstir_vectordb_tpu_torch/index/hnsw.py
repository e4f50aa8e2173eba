"""HNSW graph index: fixed-degree adjacency, device candidates and search,
host linking.

The JAX package's ``index/hnsw.py``. The host side (level sampling from
``np.random.default_rng(seed)``, dense -1 padded adjacency ``nbrs0 [cap,
M0]`` / ``nbrs_up``, the vectorised linking and the reverse-link prune, the
dirty-row bookkeeping of the device adjacency) is a copy. The device side:

- link candidates, exact while the member-occupied prefix fits the flat
  threshold: the top-``ef_construction`` members of each new row from the
  fused L2 top-k kernel (K1, ``ops.topk.l2_topk``), with a device member
  mask updated in place per batch; above it (or with ``link_mode="layer0"``)
  a greedy descent (K10) and one layer-0 beam of ef_construction (K11);
  with ``link_mode="per_layer"`` a descent to each new row's level and one
  K11 beam a layer from there down to 0, each layer linked from its own
  pool, one row at a time (the reference's ``_link_batch``);
- the neighbour-selection heuristic (K4, :func:`heuristic_kept`);
- the row-pair distances of the reverse-link prune (K5, :func:`pair_sq_l2`);
- the pipelined build's device member mask, a link batch's rows set in
  place (:func:`set_member_rows`);
- search: greedy descent over the upper layers (K10,
  :func:`greedy_descent`) and a layer-0 beam (K11, :func:`beam_search`).

The mirror is the serving one (FVDB_SERVING_DTYPE). On a bf16 mirror every
kernel here reads bf16 rows upcast exactly, with the f32 query (K1 does not
round it here) and, for K1, K5, K10 and K11, the mirror's f32 norms of the
f32 host rows (K4 takes the norms of the upcast rows), as the reference's
f32-compute gathers do.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.topk import INF, l2_topk
from ..utils import limits, native
from ..utils.padding import bucket, fit_mask, grow_rows
from ..utils.transfer import to_device, to_host
from .store import VectorStore, serving_mirror


@dataclass
class HNSWConfig:
    m: int = 16
    m0: int = 32
    ef_construction: int = 200
    ef_search: int = 50
    level_p: float = 0.408
    max_level: int = 16
    seed: int | None = 42
    bootstrap_threshold: int = 1024  # below this, exact candidates (host)
    # link candidates: "auto" takes exact K1 candidates while the member
    # prefix fits the flat threshold and the "layer0" plan above it;
    # "layer0" is greedy descent + one layer-0 beam, every layer linked
    # from its pool; "per_layer" is a beam per layer from each new row's
    # level down, each layer linked from its own pool
    link_mode: str = "auto"


@dataclass
class GraphStats:
    num_nodes: int
    num_edges: int
    avg_degree: float
    max_layer: int


# ---------------------------------------------------------------------------
# Device kernels and their plain versions
# ---------------------------------------------------------------------------

def set_member_rows_plain(mask: torch.Tensor, rows: torch.Tensor):
    """Plain version of :func:`set_member_rows`."""
    rows = rows.long()
    mask[rows[(rows >= 0) & (rows < mask.shape[0])]] = True
    return mask


def set_member_rows(mask: torch.Tensor, rows: torch.Tensor,
                    counter: str = "set_member_rows"):
    """The reference's _set_member_rows (``index/hnsw.py:137``): mask[rows]
    = True in place on the device member mask [N] bool; rows [n] int32
    outside [0, N) are ignored. Returns mask. The plain version on CPU
    tensors; on CUDA tensors csrc/shard_merge.cu's fvdb_set_rows or it
    raises. A launch adds one to ``counter`` (K15's sharded build counts
    its own under "set_rows")."""
    if mask.device.type == "cpu":
        return set_member_rows_plain(mask, rows)
    if mask.device.type != "cuda":
        raise ValueError(f"set_member_rows: unsupported device {mask.device}")
    dev = mask.device
    native.check(mask, "mask", torch.bool, 1, dev)
    native.check(rows, "rows", torch.int32, 1, dev)
    if rows.shape[0] == 0:
        return mask
    native.call("shard_merge", "fvdb_set_rows",
                [native.P, native.L, native.P, native.I, native.P],
                mask.data_ptr(), mask.shape[0], rows.data_ptr(), rows.shape[0],
                native.stream_of(mask))
    native.launches[counter] += 1
    return mask


# Heuristic neighbour selection (Malkov & Yashunin; hnswlib
# getNeighborsByHeuristic2): keep candidate c only if dist(c, q) < dist(c,
# every kept neighbour). It runs on the closest slice of the candidate pool.
_HEUR_POOL = 128


def heuristic_kept_plain(x, cand_ids, cand_d, m: int) -> torch.Tensor:
    """Plain version of K4 (same arithmetic as the reference kernel)."""
    v = x[cand_ids.clamp_min(0).long()].float()  # [B, C, D]
    sq = (v * v).sum(-1)
    g = torch.bmm(v, v.transpose(1, 2))
    pd = sq[:, :, None] - 2.0 * g + sq[:, None, :]  # [B, C, C]
    valid = (cand_ids >= 0) & torch.isfinite(cand_d)
    b, c = cand_ids.shape
    kept = torch.zeros((b, c), dtype=torch.bool, device=x.device)
    cnt = torch.zeros(b, dtype=torch.int32, device=x.device)
    inf = torch.full_like(pd[:, 0, :], float("inf"))
    for i in range(c):
        dmin = torch.where(kept, pd[:, i, :], inf).min(dim=1).values
        keep_i = valid[:, i] & (cand_d[:, i] < dmin) & (cnt < m)
        kept[:, i] = keep_i
        cnt += keep_i.to(torch.int32)
    return kept


def heuristic_route(x) -> str:
    """The route K4 takes over the rows of x on the card: "tf32x3" (f32
    rows, three TF32 products on the tensor cores) or "bf16" (bf16 rows,
    one bf16 product, exact in f32) where cp.async copies every row 16
    bytes at a time (D % 4 == 0 for f32 rows, D % 8 == 0 for bf16, the
    rows 16-byte aligned), else "fma" (f32 FMA)."""
    per_copy = 16 // x.element_size()
    if x.shape[1] % per_copy or x.data_ptr() % 16:
        return "fma"
    return "bf16" if x.dtype == torch.bfloat16 else "tf32x3"


def heuristic_kept(x, cand_ids, cand_d, m: int) -> torch.Tensor:
    """K4: heuristic-selection mask over the rows of x [N, D] (f32, or bf16
    upcast exactly). cand_ids int32 / cand_d f32 [B, C], each row sorted
    ascending by distance to its query (-1 / +inf padded, C <= 128 on the
    card). Returns kept [B, C] bool with at most m True a row. A -1 id
    gathers row 0 but is never kept. The plain version on CPU tensors,
    csrc/heuristic_kept.cu on CUDA tensors: the tensor cores where
    :func:`heuristic_route` says so (counted as "heuristic_kept",
    "heuristic_kept_bf16"), else the FMA route ("heuristic_kept_fma",
    "heuristic_kept_bf16_fma")."""
    if x.device.type == "cpu":
        return heuristic_kept_plain(x, cand_ids, cand_d, m)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    native.check(x, "x", torch.bfloat16 if bf16 else torch.float32, 2, dev)
    native.check(cand_ids, "cand_ids", torch.int32, 2, dev)
    native.check(cand_d, "cand_d", torch.float32, 2, dev)
    b, c = cand_ids.shape
    if cand_d.shape != cand_ids.shape or not 1 <= c <= 128:
        raise ValueError(f"heuristic_kept takes [B, C<=128] candidates, "
                         f"got {tuple(cand_ids.shape)}")
    kept = torch.empty((b, c), dtype=torch.uint8, device=dev)
    if b == 0:
        return kept.bool()
    fma = heuristic_route(x) == "fma"
    P, I = native.P, native.I
    native.call(
        "heuristic_kept",
        "fvdb_heuristic_kept" + ("_bf16" if bf16 else "")
        + ("" if fma else "_tc"),
        [P, P, P, I, I, I, I, P, P],
        x.data_ptr(), cand_ids.data_ptr(), cand_d.data_ptr(), b, c,
        x.shape[1], m, kept.data_ptr(), native.stream_of(x))
    native.launches[native.counter("heuristic_kept", bf16, fma=fma)] += 1
    return kept.bool()


def pair_sq_l2_plain(x, x_sq, t_ids, c_ids) -> torch.Tensor:
    t, c = t_ids.long(), c_ids.long()
    dots = (x[t].float() * x[c].float()).sum(-1)
    return (x_sq[t] - 2.0 * dots + x_sq[c]).clamp_min(0.0)


def pair_sq_l2(x, x_sq, t_ids, c_ids) -> torch.Tensor:
    """K5: squared L2 between row pairs of the mirror x [N, D] (f32, or
    bf16 upcast exactly) with its norms x_sq [N]: int32 [P] x 2 -> f32 [P].
    The plain version on CPU tensors, csrc/pair_sq_l2.cu on CUDA tensors
    (ids must be in range there)."""
    if x.device.type == "cpu":
        return pair_sq_l2_plain(x, x_sq, t_ids, c_ids)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    native.check(x, "x", torch.bfloat16 if bf16 else torch.float32, 2, dev)
    native.check(x_sq, "x_sq", torch.float32, 1, dev)
    native.check(t_ids, "t_ids", torch.int32, 1, dev)
    native.check(c_ids, "c_ids", torch.int32, 1, dev)
    p = t_ids.shape[0]
    if c_ids.shape[0] != p:
        raise ValueError("t_ids and c_ids differ in length")
    out = torch.empty(p, dtype=torch.float32, device=dev)
    if p == 0:
        return out
    P, I = native.P, native.I
    native.call(
        "pair_sq_l2", "fvdb_pair_sq_l2_bf16" if bf16 else "fvdb_pair_sq_l2",
        [P, P, P, P, I, I, P, P],
        x.data_ptr(), x_sq.data_ptr(), t_ids.data_ptr(), c_ids.data_ptr(), p,
        x.shape[1], out.data_ptr(), native.stream_of(x))
    native.launches[native.counter("pair_sq_l2", bf16)] += 1
    return out


def _gather_dists(x, x_sq, q, q_sq, ids):
    """Distances from each query to its own ids: q [B, D], ids [B, M] ->
    [B, M], max(|q|^2 - 2 q.x + |x|^2, 0) with bf16 rows upcast (the f32
    query stays f32); a -1 id gathers row 0."""
    safe = ids.clamp_min(0).long()
    dots = torch.einsum("bd,bmd->bm", q, x[safe].float())
    return (q_sq[:, None] - 2.0 * dots + x_sq[safe]).clamp_min(0.0)


def _mark_seen(stats: dict, x, rows) -> None:
    """Mark ``rows`` in stats["seen"] ([N] bool: the rows scored at least
    once, whose bytes a bound counts once however often they are read)."""
    if "seen" not in stats:
        stats["seen"] = torch.zeros(x.shape[0], dtype=torch.bool,
                                    device=x.device)
    stats["seen"][rows.long()] = True


def greedy_descent_plain(x, x_sq, mask, nbrs_up, up_offset, q, entry: int,
                         entry_level: int, stop_layer=None,
                         max_hops: int = 512, stats: dict | None = None):
    """Plain version of K10 (the reference's while_loop, step for step).
    ``stats`` (a dict) gets "hops" (hop attempts of active queries),
    "rows" (unmasked neighbour rows they scored), "seen" (see _mark_seen):
    the work the kernel does on these inputs, and "longest" (the most hop
    attempts of any one query: the dependent chain that bounds a launch)."""
    b = q.shape[0]
    dev = q.device
    if stop_layer is None:
        stop_layer = torch.zeros(b, dtype=torch.int32, device=dev)
    q_sq = (q * q).sum(-1)
    cur = torch.full((b,), entry, dtype=torch.int32, device=dev)
    e_d = _gather_dists(x, x_sq, q, q_sq, cur[:, None])[:, 0]
    cur_d = torch.where(mask[cur.clamp_min(0).long()], e_d,
                        torch.full_like(e_d, INF))
    layer = torch.full((b,), entry_level, dtype=torch.int32, device=dev)
    rows_max = nbrs_up.shape[0] - 1
    hops = 0
    attempts = torch.zeros(b, dtype=torch.int64, device=dev)
    while hops < max_hops and bool((layer > stop_layer).any()):
        active = layer > stop_layer
        row = (up_offset[cur.clamp_min(0).long()] + layer - 1).clamp(
            0, rows_max)
        nbr = nbrs_up[row.long()]  # [B, M]
        d = _gather_dists(x, x_sq, q, q_sq, nbr)
        valid = (nbr >= 0) & mask[nbr.clamp_min(0).long()]
        if stats is not None:
            scored = valid & active[:, None]
            attempts = attempts + active
            stats["hops"] = stats.get("hops", 0) + int(active.sum())
            stats["rows"] = stats.get("rows", 0) + int(scored.sum())
            _mark_seen(stats, x, nbr[scored])
        d = torch.where(valid, d, torch.full_like(d, INF))
        j = torch.argmin(d, dim=1, keepdim=True)  # the first minimum
        best_d = torch.gather(d, 1, j)[:, 0]
        best_id = torch.gather(nbr, 1, j)[:, 0]
        improved = active & (best_d < cur_d)
        cur = torch.where(improved, best_id, cur)
        cur_d = torch.where(improved, best_d, cur_d)
        layer = torch.where(active & ~improved, layer - 1, layer)
        hops += 1
    if stats is not None:
        stats["longest"] = max(stats.get("longest", 0),
                               int(attempts.max()) if b else 0)
    return cur, cur_d


def greedy_descent(x, x_sq, mask, nbrs_up, up_offset, q, entry: int,
                   entry_level: int, stop_layer=None, max_hops: int = 512):
    """K10: batched greedy ef=1 descent from (entry, entry_level) down to
    stop_layer [B] int32 (None: layer 0). x [N, D] f32 or bf16 (upcast
    exactly; q [B, D] stays f32), x_sq [N] the mirror's f32 norms; mask [N]
    bool gates traversal. Returns (cur [B] int32, cur_d [B] f32). The plain
    version on CPU tensors, csrc/greedy_descent.cu on CUDA tensors
    (M <= 32)."""
    if x.device.type == "cpu":
        return greedy_descent_plain(x, x_sq, mask, nbrs_up, up_offset, q,
                                    entry, entry_level, stop_layer, max_hops)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    # the graph's state is the same tensors call after call: checked once
    native.check_once(x, "greedy_descent x",
                      torch.bfloat16 if bf16 else torch.float32, 2, dev)
    native.check_once(x_sq, "greedy_descent x_sq", torch.float32, 1, dev)
    native.check_once(mask, "greedy_descent mask", torch.bool, 1, dev)
    native.check_once(nbrs_up, "greedy_descent nbrs_up", torch.int32, 2,
                      dev)
    native.check_once(up_offset, "greedy_descent up_offset", torch.int32, 1,
                      dev)
    native.check(q, "q", torch.float32, 2, dev)
    if stop_layer is not None:
        native.check(stop_layer, "stop_layer", torch.int32, 1, dev)
    b, d = q.shape
    m = nbrs_up.shape[1]
    if not 1 <= m <= 32 or d != x.shape[1]:
        raise ValueError(f"greedy_descent takes [R, M<=32] lists and "
                         f"matching dims, got {tuple(nbrs_up.shape)}, "
                         f"q {tuple(q.shape)}, x {tuple(x.shape)}")
    cur = torch.empty(b, dtype=torch.int32, device=dev)
    cur_d = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return cur, cur_d
    P, I = native.P, native.I
    native.call(
        "greedy_descent", "fvdb_greedy_descent",
        [P, I, P, P, P, P, I, P, P, I, I, I, I, I, I, P, P, P],
        x.data_ptr(), int(bf16), x_sq.data_ptr(), mask.data_ptr(),
        nbrs_up.data_ptr(), up_offset.data_ptr(), nbrs_up.shape[0], q.data_ptr(),
        0 if stop_layer is None else stop_layer.data_ptr(), b, d, m,
        int(entry), int(entry_level), int(max_hops), cur.data_ptr(),
        cur_d.data_ptr(), native.stream_of(x))
    name = native.counter("greedy_descent", bf16)
    native.launches[name] += 1
    native.count_shape(name, f"B={b} M={m} levels={int(entry_level)}")
    return cur, cur_d


def _sorted_by_dist(d, ids, *rest):
    """Stable sort of each row by distance, carrying ids (and rest)."""
    d, order = torch.sort(d, dim=1, stable=True)
    return (d, torch.gather(ids, 1, order),
            *(torch.gather(r, 1, order) for r in rest))


def _dedup_sorted(d, ids):
    """Drop repeated ids from a distance-sorted list (keep the first) and
    sort again (the reference's _dedup_sorted)."""
    ef = ids.shape[1]
    tri = torch.tril(torch.ones(ef, ef, dtype=torch.bool, device=ids.device),
                     -1)
    dup = ((ids[:, :, None] == ids[:, None, :]) & (ids[:, None, :] >= 0)
           & tri[None]).any(-1)
    d = torch.where(dup, torch.full_like(d, INF), d)
    ids = torch.where(dup, torch.full_like(ids, -1), ids)
    return _sorted_by_dist(d, ids)


def beam_search_plain(x, x_sq, mask, nbrs0, nbrs_up, up_offset, q,
                      start_ids, active, layer: int, ef: int,
                      max_iters: int, result_mask=None,
                      use_nbrs0: bool | None = None, expand: int = 1,
                      stats: dict | None = None):
    """Plain version of K11: the reference's _beam_search_jit step for step
    (stable sorts, the same done / keep logic). ``stats`` (a dict) gets
    "steps" (steps of running queries), "steps_max" (the most steps one
    query ran: its chain of dependent reads), "parents" (lists gathered),
    "rows" (neighbours that passed the filters and were scored) and "seen"
    (see _mark_seen): the work the kernel does on these inputs."""
    if use_nbrs0 is None:
        use_nbrs0 = int(layer) == 0
    dev = q.device
    b, s = start_ids.shape
    start_ids = start_ids.to(torch.int32)
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=dev)
    q_sq = (q * q).sum(-1)
    safe_start = start_ids.clamp_min(0).long()
    start_valid = (start_ids >= 0) & mask[safe_start]
    if s > 1:  # drop repeated start ids (keep the first)
        tri_s = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev), -1)
        dup0 = ((start_ids[:, :, None] == start_ids[:, None, :])
                & (start_ids[:, None, :] >= 0) & tri_s[None]).any(-1)
        start_valid &= ~dup0
    d0 = _gather_dists(x, x_sq, q, q_sq, start_ids)
    d0 = torch.where(start_valid, d0, torch.full_like(d0, INF))
    pad = max(ef - s, 0)
    pad_d = torch.full((b, pad), INF, device=dev)
    pad_i = torch.full((b, pad), -1, dtype=torch.int32, device=dev)
    neg = torch.full_like(start_ids, -1)
    pool_d, pool_id = _sorted_by_dist(
        torch.cat([d0, pad_d], 1)[:, :ef],
        torch.cat([torch.where(start_valid, start_ids, neg), pad_i], 1)[:, :ef])
    pool_exp = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    has_res = result_mask is not None
    if has_res:
        elig0 = start_valid & result_mask[safe_start]
        res_d, res_id = _sorted_by_dist(
            torch.cat([torch.where(elig0, d0, torch.full_like(d0, INF)),
                       pad_d], 1)[:, :ef],
            torch.cat([torch.where(elig0, start_ids, neg), pad_i], 1)[:, :ef])
    else:
        res_d, res_id = pool_d, pool_id
    done = ~active
    rows_max = nbrs_up.shape[0] - 1
    ran = torch.zeros(b, dtype=torch.int64, device=dev)  # steps a query ran
    it = 0
    while it < max_iters and bool((~done).any()):
        und = torch.where(pool_exp | (pool_id < 0),
                          torch.full_like(pool_d, INF), pool_d)
        seld, bsel = torch.sort(und, dim=1, stable=True)
        seld, bsel = seld[:, :expand], bsel[:, :expand]  # lax.top_k order
        bd = seld[:, 0]
        worst = pool_d[:, -1]
        pool_full = pool_id[:, -1] >= 0
        done2 = done | torch.isinf(bd) | (pool_full & (bd > worst))
        run = ~done2
        nid = torch.gather(pool_id, 1, bsel)
        parent_ok = torch.isfinite(seld) & (nid >= 0) & run[:, None]
        pool_exp2 = pool_exp.scatter(
            1, bsel, torch.gather(pool_exp, 1, bsel) | parent_ok)
        nid_safe = nid.clamp_min(0).long()
        if use_nbrs0:
            nbr = nbrs0[nid_safe]  # [B, W, M0]
        else:
            row = (up_offset[nid_safe] + layer - 1).clamp(0, rows_max)
            nbr = nbrs_up[row.long()]  # [B, W, M]
        nbr = torch.where(parent_ok[:, :, None], nbr,
                          torch.full_like(nbr, -1)).reshape(b, -1)
        m_w = nbr.shape[1]
        in_pool = (nbr[:, :, None] == pool_id[:, None, :]).any(-1)
        tri = torch.tril(torch.ones(m_w, m_w, dtype=torch.bool, device=dev),
                         -1)
        step_dup = ((nbr[:, :, None] == nbr[:, None, :]) & tri[None]).any(-1)
        nbr_safe = nbr.clamp_min(0).long()
        valid = ((nbr >= 0) & ~in_pool & ~step_dup & mask[nbr_safe]
                 & run[:, None])
        if stats is not None:
            for key, v in (("steps", run), ("parents", parent_ok),
                           ("rows", valid)):
                stats[key] = stats.get(key, 0) + int(v.sum())
            ran += run
            _mark_seen(stats, x, nbr[valid])
        nd = _gather_dists(x, x_sq, q, q_sq, nbr)
        nd = torch.where(valid, nd, torch.full_like(nd, INF))
        new_d, new_id, new_exp = _sorted_by_dist(
            torch.cat([pool_d, nd], 1),
            torch.cat([pool_id, torch.where(valid, nbr,
                                            torch.full_like(nbr, -1))], 1),
            torch.cat([pool_exp2, torch.zeros_like(valid)], 1))
        keep = done2[:, None]
        pool_d = torch.where(keep, pool_d, new_d[:, :ef])
        pool_id = torch.where(keep, pool_id, new_id[:, :ef])
        pool_exp = torch.where(keep, pool_exp2, new_exp[:, :ef])
        if has_res:
            elig = valid & result_mask[nbr_safe]
            rall_d, rall_id = _sorted_by_dist(
                torch.cat([res_d, torch.where(elig, nd,
                                              torch.full_like(nd, INF))], 1),
                torch.cat([res_id, torch.where(elig, nbr,
                                               torch.full_like(nbr, -1))], 1))
            res_d = torch.where(keep, res_d, rall_d[:, :ef])
            res_id = torch.where(keep, res_id, rall_id[:, :ef])
        else:
            res_d, res_id = pool_d, pool_id
        done = done2
        it += 1
    if stats is not None:
        stats["steps_max"] = int(ran.max()) if b else 0
    return _dedup_sorted(res_d, res_id)


# warps a query of K11 (1-8): about 16 of a step's W x width candidates a
# warp, halved while the launch would hold more warps than the card keeps
# resident at once (132 SMs x 16 warps at the kernel's 128 registers)
BEAM_RESIDENT_WARPS = 2048


def beam_plan(b: int, expand: int, width: int) -> int:
    """Warps a query (a block) of K11 for B = b queries expanding
    ``expand`` lists of ``width`` a step."""
    warps = min(8, max(1, -(-expand * width // 16)))
    while warps > 1 and b * warps > BEAM_RESIDENT_WARPS:
        warps //= 2
    return warps


def beam_search(x, x_sq, mask, nbrs0, nbrs_up, up_offset, q, start_ids,
                active, layer: int, ef: int, max_iters: int,
                result_mask=None, use_nbrs0: bool | None = None,
                expand: int = 1):
    """K11: batched beam search at one graph layer.

    x [N, D] f32 or bf16 (upcast exactly) with x_sq [N] the mirror's f32
    norms; q [B, D] f32; start_ids [B, S] int32 (-1 padded); active [B]
    bool or None (all; an inactive query returns its start set); layer > 0
    reads nbrs_up through up_offset; mask [N] bool gates traversal;
    result_mask [N] bool or None gates only which rows may be returned
    (the filter path). Each step
    expands the ``expand`` best unexpanded pool entries. Returns (d [B, ef]
    f32, ids [B, ef] int32) sorted ascending, +inf / -1 padded. The plain
    version on CPU tensors, csrc/beam_search.cu on CUDA tensors (expand x
    list width <= 256; ``beam_plan`` warps a query)."""
    if use_nbrs0 is None:
        use_nbrs0 = int(layer) == 0
    if x.device.type == "cpu":
        return beam_search_plain(x, x_sq, mask, nbrs0, nbrs_up, up_offset, q,
                                 start_ids, active, layer, ef, max_iters,
                                 result_mask, use_nbrs0, expand)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    native.check(x, "x", torch.bfloat16 if bf16 else torch.float32, 2, dev)
    native.check(x_sq, "x_sq", torch.float32, 1, dev)
    native.check(mask, "mask", torch.bool, 1, dev)
    native.check(q, "q", torch.float32, 2, dev)
    native.check(start_ids, "start_ids", torch.int32, 2, dev)
    for t, name in ((active, "active"), (result_mask, "result_mask")):
        if t is not None:
            native.check(t, name, torch.bool, 1, dev)
    adj = nbrs0 if use_nbrs0 else nbrs_up
    native.check(adj, "adjacency", torch.int32, 2, dev)
    if not use_nbrs0:
        native.check(up_offset, "up_offset", torch.int32, 1, dev)
    b, d = q.shape
    s = start_ids.shape[1]
    mw = adj.shape[1]
    if expand * mw > 256 or s < 1 or ef < 1 or d != x.shape[1] \
            or start_ids.shape[0] != b:
        raise ValueError(
            f"beam_search takes expand x width <= 256, S >= 1, ef >= 1 and "
            f"matching shapes: expand {expand}, adjacency "
            f"{tuple(adj.shape)}, start {tuple(start_ids.shape)}, ef {ef}")
    out_d = torch.empty((b, ef), dtype=torch.float32, device=dev)
    out_id = torch.empty((b, ef), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_id
    P, I = native.P, native.I
    per_q = native.query("beam_search", "fvdb_beam_scratch_bytes", [I, I],
                         d, ef)
    scratch = (torch.empty(b * per_q, dtype=torch.uint8, device=dev)
               if per_q else None)
    native.call(
        "beam_search", "fvdb_beam_search",
        [P, I, P, P, P, I, I, P, I, P, I, I, P, I, P, P, I, I, I, I, P, P,
         P, P],
        x.data_ptr(), int(bf16), x_sq.data_ptr(), mask.data_ptr(),
        adj.data_ptr(), adj.shape[0], mw, 0 if use_nbrs0 else up_offset.data_ptr(),
        int(layer), q.data_ptr(), b, d, start_ids.data_ptr(), s,
        0 if active is None else active.data_ptr(),
        0 if result_mask is None else result_mask.data_ptr(), int(ef),
        int(max_iters), int(expand), beam_plan(b, expand, mw),
        0 if scratch is None else scratch.data_ptr(), out_d.data_ptr(),
        out_id.data_ptr(), native.stream_of(x))
    name = native.counter("beam_search", bf16, up=not use_nbrs0)
    native.launches[name] += 1
    native.count_shape(name, f"B={b} ef={ef} W={expand} layer={int(layer)}"
                       + (" filtered" if result_mask is not None else ""))
    return out_d, out_id


def _heuristic_kept_host(vecs, cand_d, valid, m: int) -> np.ndarray:
    """Host twin of heuristic_kept. vecs [B, C, D] candidate vectors
    (rows must be pre-gathered), cand_d [B, C] ascending."""
    b, c = cand_d.shape
    vecs = np.ascontiguousarray(vecs, np.float32)
    sq = np.einsum("bcd,bcd->bc", vecs, vecs)
    g = vecs @ vecs.transpose(0, 2, 1)  # batched BLAS, not einsum's C loop
    pd = sq[:, :, None] - 2.0 * g + sq[:, None, :]
    kept = np.zeros((b, c), bool)
    cnt = np.zeros(b, np.int32)
    for i in range(c):
        dmin = np.where(kept, pd[:, i, :], np.inf).min(axis=1)
        keep_i = valid[:, i] & (cand_d[:, i] < dmin) & (cnt < m)
        kept[:, i] = keep_i
        cnt += keep_i
    return kept


def _heuristic_prune_one(data, target_vec, ids: np.ndarray,
                         width: int) -> np.ndarray:
    """Reverse-link prune of one overfull list (the reference's): the
    heuristic selection up to width, then the closest pruned ones fill the
    rest, so spread links survive and near links still fill the list."""
    vecs = data[ids]
    d = ((vecs - target_vec) ** 2).sum(-1)
    order = np.argsort(d, kind="stable")
    ids, vecs, d = ids[order], vecs[order], d[order]
    kept = _heuristic_kept_host(vecs[None], d[None],
                                np.ones((1, len(ids)), bool), width)[0]
    return np.concatenate([ids[kept], ids[~kept]])[:width]


# flat-pair counts / table rows above which the reverse-link prune computes
# on the device against the resident mirror instead of gathering rows on
# the host
_PAIR_DEVICE_MIN = 16_384
_KEPT_DEVICE_MIN = 1_024


# ---------------------------------------------------------------------------
# Host index
# ---------------------------------------------------------------------------


class HNSWIndex:
    """HNSW over a shared VectorStore: device candidates and search, host
    linking."""

    def __init__(self, store: VectorStore, config: HNSWConfig | None = None):
        self.store = store
        self.config = config or HNSWConfig()
        cap = store.capacity
        self.levels = np.full(cap, -1, np.int16)  # -1 = not a member
        self.nbrs0 = np.full((cap, self.config.m0), -1, np.int32)
        self.up_offset = np.full(cap, -1, np.int32)
        self.up_cap = max(cap, 64)
        self.nbrs_up = np.full((self.up_cap, self.config.m), -1, np.int32)
        self.up_count = 0
        self.entry_point = -1
        self.max_level = -1
        self._rng = np.random.default_rng(self.config.seed)
        self._version = 0
        # device adjacency, updated by dirty-row deltas (a full upload is
        # ~200 MB at 1M rows; a linked batch dirties ~4 MB of it)
        self._device: dict | None = None
        self._device_version = -1
        self._dirty0: set = set()
        self._dirty_up: set = set()
        self._dirty_off: set = set()
        self._dirty_full = True
        # serializes device rebuilds against dirty marks: a clear() racing
        # a writer's update() could drop deltas
        self._dev_sync = threading.Lock()

    # ----------------------------------------------------------- bookkeeping
    def _ensure_capacity(self) -> None:
        cap = self.store.capacity
        if self.levels.shape[0] < cap:
            self.levels = grow_rows(self.levels, cap, fill=-1)
            self.nbrs0 = grow_rows(self.nbrs0, cap, fill=-1)
            self.up_offset = grow_rows(self.up_offset, cap, fill=-1)

    def _alloc_up_rows(self, n: int) -> int:
        if self.up_count + n > self.up_cap:
            extra = max(self.up_cap, n)
            self.nbrs_up = grow_rows(self.nbrs_up, self.up_cap + extra, fill=-1)
            self.up_cap += extra
        start = self.up_count
        self.up_count += n
        return start

    def _mark_dirty0(self, rows) -> None:
        with self._dev_sync:
            if not self._dirty_full:
                self._dirty0.update(np.atleast_1d(np.asarray(rows)).tolist())

    def _mark_dirty_up(self, rows) -> None:
        with self._dev_sync:
            if not self._dirty_full:
                self._dirty_up.update(
                    np.atleast_1d(np.asarray(rows)).tolist())

    def _mark_dirty_off(self, rows) -> None:
        with self._dev_sync:
            if not self._dirty_full:
                self._dirty_off.update(
                    np.atleast_1d(np.asarray(rows)).tolist())

    def _device_arrays(self) -> dict:
        """nbrs0, nbrs_up, up_offset on the store's device, current with the
        host arrays: scattered rows when under 25% of them changed, else a
        full upload."""
        with self._dev_sync:
            if self._device is not None \
                    and self._device_version == self._version:
                return self._device
            dev = self._device
            shapes_ok = (
                dev is not None and not self._dirty_full
                and tuple(dev["nbrs0"].shape) == self.nbrs0.shape
                and tuple(dev["nbrs_up"].shape) == self.nbrs_up.shape
                and tuple(dev["up_offset"].shape) == self.up_offset.shape)
            device = self.store.torch_device
            if shapes_ok and (len(self._dirty0) + len(self._dirty_up)
                              < 0.25 * self.nbrs0.shape[0]):
                for name, host, dirty in (
                        ("nbrs0", self.nbrs0, self._dirty0),
                        ("nbrs_up", self.nbrs_up, self._dirty_up),
                        ("up_offset", self.up_offset, self._dirty_off)):
                    if dirty:
                        idx = np.fromiter(dirty, np.int64, len(dirty))
                        dev[name].index_copy_(0, to_device(idx, device),
                                              to_device(host[idx], device))
            else:
                self._device = None  # free the stale copy first
                self._device = {
                    "nbrs0": to_device(self.nbrs0, device),
                    "nbrs_up": to_device(self.nbrs_up, device),
                    "up_offset": to_device(self.up_offset, device),
                }
            self._dirty0.clear()
            self._dirty_up.clear()
            self._dirty_off.clear()
            self._dirty_full = False
            self._device_version = self._version
            return self._device

    def _invalidate_device(self) -> None:
        """Make the next _device_arrays() a full upload."""
        with self._dev_sync:
            self._dirty_full = True
            self._dirty0.clear()
            self._dirty_up.clear()
            self._dirty_off.clear()

    def _sample_level(self) -> int:
        u = self._rng.random()
        level = int(math.floor(math.log(max(u, 1e-12))
                               / math.log(self.config.level_p)))
        return min(level, self.config.max_level)

    def member_mask(self, n: int | None = None) -> np.ndarray:
        """[n or store.capacity] bool membership (non-mutating)."""
        levels = self.levels  # local ref: concurrent grow replaces the object
        if n is None:
            n = max(self.store.capacity, levels.shape[0])
        m = np.zeros(n, bool)
        c = min(n, levels.shape[0])
        m[:c] = levels[:c] >= 0
        return m

    def member_rows(self) -> np.ndarray:
        return np.nonzero(self.member_mask())[0]

    @property
    def num_nodes(self) -> int:
        return int((self.levels >= 0).sum())

    @property
    def active_count(self) -> int:
        m = self.member_mask()[: self.store.count]
        return int((m & ~self.store.deleted[: self.store.count]).sum())

    @property
    def deleted_count(self) -> int:
        m = self.member_mask()[: self.store.count]
        return int((m & self.store.deleted[: self.store.count]).sum())

    def _search_mask(self, n: int | None = None) -> np.ndarray:
        if n is None:
            n = self.store.capacity
        return self.store.active_mask(n) & self.member_mask(n)

    def _fix_entry_point(self) -> None:
        """Ensure the entry point is an active member (repaired after
        deletions)."""
        mask = self._search_mask()
        if 0 <= self.entry_point < mask.shape[0] and mask[self.entry_point]:
            return
        rows = np.nonzero(mask)[0]
        if rows.size == 0:
            self.entry_point = -1
            self.max_level = -1
            return
        lv = self.levels[rows]
        best = rows[int(np.argmax(lv))]
        self.entry_point = int(best)
        self.max_level = int(self.levels[best])
        self._version += 1

    # ----------------------------------------------------------------- build
    def insert_rows(self, rows: np.ndarray) -> None:
        """Insert store rows into the graph. Rows must already exist in the
        VectorStore.

        Post-bootstrap batches pipeline: batch i+1's candidate kernels are
        launched (against the device member mask, already updated to hold
        batch i) before the host links batch i, so the card and the host
        work at once. Candidates read only vectors and the member mask, so
        the overlap changes no result.
        """
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        self._ensure_capacity()
        cfg = self.config
        pos = 0
        pending = None  # (batch, levels, device handles) awaiting link
        pending_n = 0
        pending_hi = 0
        mask_dev = None  # device member mask incl. dispatched-unlinked rows

        def _flush():
            nonlocal pending, pending_n, pending_hi
            if pending is not None:
                pb, pl, ph = pending
                self._link_batch_exact(pb, pl, self._flat_finalize(ph))
                self._version += 1
                pending = None
                pending_n = 0
                pending_hi = 0

        while pos < rows.size:
            n_members = self.num_nodes + pending_n
            if n_members < cfg.bootstrap_threshold:
                step = max(1, n_members) if n_members else 1
                step = min(step, cfg.bootstrap_threshold)
            else:
                step = 1024  # fixed post-bootstrap batch
            batch = rows[pos: pos + step]
            pos += len(batch)

            plan = None
            if cfg.link_mode == "auto" and n_members > cfg.bootstrap_threshold:
                plan = self._flat_plan(extra_hi=pending_hi)
            if plan is not None and plan[0]:
                n_pad = plan[1]
                if mask_dev is None:
                    mask_dev = to_device(self._search_mask(),
                                         self.store.torch_device)
                    if pending is not None:  # the in-flight rows are members
                        self._scatter_members(mask_dev, pending[0])
                levels_new = np.array(
                    [self._sample_level() for _ in batch], np.int32)
                handles = self._flat_dispatch(batch, mask_dev, n_pad)
                # the next batch must see this one as members
                self._scatter_members(mask_dev, batch)
                _flush()  # link the previous batch while this one computes
                pending = (batch, levels_new, handles)
                pending_n = len(batch)
                pending_hi = int(batch.max()) + 1
            else:
                _flush()
                mask_dev = None  # the serial path changes membership on host
                self._insert_batch(batch)
        _flush()

    def _scatter_members(self, mask_dev: torch.Tensor, batch: np.ndarray):
        """Set ``batch`` rows of the device mask, in place
        (:func:`set_member_rows`). Safe next to the candidate kernels
        already launched on the mask: they were enqueued first on the same
        stream, so they read it before this write runs."""
        set_member_rows(mask_dev, to_device(batch.astype(np.int32),
                                            mask_dev.device))

    def _flat_plan(self, extra_hi: int = 0):
        """(flat_ok, n_pad) for the exact candidate plan. ``extra_hi``
        extends the member-occupied bound past rows launched but not yet
        linked."""
        members = np.nonzero(self.member_mask())[0]
        member_hi = int(members.max()) + 1 if members.size else 1
        member_hi = max(member_hi, extra_hi)
        n_pad = min(bucket(member_hi, minimum=1024), self.store.capacity)
        return n_pad <= limits.effective_flat_threshold(), n_pad

    def _flat_dispatch(self, batch: np.ndarray, mask_dev, n_pad: int):
        """Launch the candidate kernels (K1 over the member prefix, then K4
        on the closest _HEUR_POOL) WITHOUT reading back."""
        cfg = self.config
        mirror = serving_mirror(self.store)
        q = to_device(self.store.data[batch], self.store.torch_device)
        vals, ids = l2_topk(mirror.x[:n_pad], mirror.x_sq[:n_pad],
                            mask_dev[:n_pad], q, cfg.ef_construction)
        c_sel = min(cfg.ef_construction, _HEUR_POOL)
        kept = heuristic_kept(mirror.x, ids[:, :c_sel].contiguous(),
                              vals[:, :c_sel].contiguous(), cfg.m0)
        return vals, ids, kept, c_sel

    @staticmethod
    def _flat_finalize(handles) -> dict:
        vals, ids, kept_sl, c_sel = handles
        vals, ids, kept_sl = to_host(vals, ids, kept_sl)
        kept = np.zeros(ids.shape, bool)
        kept[:, :c_sel] = kept_sl
        return {"mode": "exact", "ids": ids, "dists": vals, "kept": kept}

    def _insert_batch(self, batch: np.ndarray) -> None:
        cfg = self.config
        levels_new = np.array([self._sample_level() for _ in batch], np.int32)
        n_members = self.num_nodes

        if n_members == 0:
            # first node bootstraps the graph
            first = int(batch[0])
            self._install_node(first, int(levels_new[0]))
            self.entry_point = first
            self.max_level = int(levels_new[0])
            batch = batch[1:]
            levels_new = levels_new[1:]
            if batch.size == 0:
                self._version += 1
                return
            n_members = 1

        if n_members <= cfg.bootstrap_threshold:
            cands = self._exact_candidates(batch)
        else:
            cands = self._device_candidates(batch, levels_new)

        self._link_batch(batch, levels_new, cands)
        self._version += 1

    def _install_node(self, row: int, level: int) -> None:
        self.levels[row] = level
        self.nbrs0[row] = -1
        self._mark_dirty0(row)
        if level > 0:
            off = self._alloc_up_rows(level)
            self.up_offset[row] = off
            self.nbrs_up[off: off + level] = -1
            self._mark_dirty_off(row)
            self._mark_dirty_up(np.arange(off, off + level))

    def _exact_candidates(self, batch: np.ndarray) -> dict:
        """Bootstrap path: exact top-ef_construction candidates by brute
        force on the host while the graph is small."""
        mask = self._search_mask()
        members = np.nonzero(mask)[0]
        q = self.store.data[batch]
        x = self.store.data[members]
        d = (
            (q * q).sum(1)[:, None]
            - 2.0 * (q @ x.T)
            + (x * x).sum(1)[None, :]
        )
        np.maximum(d, 0.0, out=d)
        order = np.argsort(d, axis=1)[:, : self.config.ef_construction]
        ids = members[order]
        dists = np.take_along_axis(d, order, axis=1)
        return {
            "mode": "exact", "ids": ids, "dists": dists,
            "kept": self._kept_host(ids, dists, self.config.m0),
        }

    def _kept_host(self, ids: np.ndarray, dists: np.ndarray, m: int) -> np.ndarray:
        """Heuristic-selection flags over the closest _HEUR_POOL slice."""
        c_sel = min(ids.shape[1], _HEUR_POOL)
        sl_ids = ids[:, :c_sel]
        vecs = self.store.data[np.maximum(sl_ids, 0)]
        kept = np.zeros(ids.shape, bool)
        kept[:, :c_sel] = _heuristic_kept_host(
            vecs, dists[:, :c_sel], sl_ids >= 0, m)
        return kept

    def _device_candidates(self, batch: np.ndarray,
                           levels_new: np.ndarray) -> dict:
        """Candidate pools of a batch of new rows (their sampled levels in
        ``levels_new``, read by the per-layer plan)."""
        cfg = self.config
        device = self.store.torch_device
        flat_link_ok, n_pad = self._flat_plan()
        if cfg.link_mode == "auto" and flat_link_ok:
            mask = to_device(self._search_mask(), device)
            return self._flat_finalize(
                self._flat_dispatch(batch, mask, n_pad))
        if cfg.link_mode not in ("auto", "layer0", "per_layer"):
            raise ValueError(f"unknown link_mode {cfg.link_mode!r}")
        mirror = serving_mirror(self.store)
        dev = self._device_arrays()
        mask = to_device(self._search_mask(), device)
        q = to_device(self.store.data[batch], device)
        c_sel = min(cfg.ef_construction, _HEUR_POOL)
        if cfg.link_mode != "per_layer":
            # greedy all the way down, one ef_construction beam at layer 0;
            # upper layers link from the same pool, filtered by node level
            cur, _ = greedy_descent(mirror.x, mirror.x_sq, mask,
                                    dev["nbrs_up"], dev["up_offset"], q,
                                    self.entry_point, self.max_level)
            pool_d, pool_id = beam_search(
                mirror.x, mirror.x_sq, mask, dev["nbrs0"], dev["nbrs_up"],
                dev["up_offset"], q, cur[:, None], None, layer=0,
                ef=cfg.ef_construction, max_iters=cfg.ef_construction + 32)
            kept = heuristic_kept(mirror.x, pool_id[:, :c_sel].contiguous(),
                                  pool_d[:, :c_sel].contiguous(), cfg.m0)
            return self._flat_finalize((pool_d, pool_id, kept, c_sel))

        # per layer: descend to each row's level, then one beam a layer from
        # the highest such level down to 0, each seeded with the layer
        # above's pool (queries not yet at a layer keep their entries)
        stop = np.minimum(levels_new, self.max_level).astype(np.int32)
        cur, _ = greedy_descent(mirror.x, mirror.x_sq, mask, dev["nbrs_up"],
                                dev["up_offset"], q, self.entry_point,
                                self.max_level, to_device(stop, device))
        entries = to_host(cur)[0][:, None]  # [B, 1]
        per_layer = {}
        top_beam = int(min(self.max_level, int(stop.max())))
        for layer in range(top_beam, -1, -1):
            active = stop >= layer
            pool_d, pool_id = beam_search(
                mirror.x, mirror.x_sq, mask, dev["nbrs0"], dev["nbrs_up"],
                dev["up_offset"], q, to_device(entries.astype(np.int32),
                                               device),
                to_device(active, device), layer=layer,
                ef=cfg.ef_construction, max_iters=cfg.ef_construction + 32)
            kept = heuristic_kept(mirror.x, pool_id[:, :c_sel].contiguous(),
                                  pool_d[:, :c_sel].contiguous(),
                                  cfg.m0 if layer == 0 else cfg.m)
            pool_d, pool_id, kept_sl = to_host(pool_d, pool_id, kept)
            kept_all = np.zeros(pool_id.shape, bool)
            kept_all[:, :c_sel] = kept_sl
            per_layer[layer] = (pool_id, pool_d, kept_all)
            nxt = pool_id.copy()
            if not active.all():
                keep = ~active
                pad = np.full((entries.shape[0], nxt.shape[1]), -1, np.int32)
                pad[:, : entries.shape[1]] = entries
                nxt[keep] = pad[keep]
            entries = nxt
        return {"mode": "beam", "per_layer": per_layer}

    def _link_batch(self, batch: np.ndarray, levels_new: np.ndarray,
                    cands: dict) -> None:
        """Link a batch from its candidates: exact pools (one pool for
        every layer) through the vectorised _link_batch_exact; per-layer
        pools one row at a time, as the reference does: each row installs,
        takes its heuristic-kept candidates first and the closest unkept
        after, and adds reverse links that prune a full list."""
        if cands["mode"] == "exact":
            return self._link_batch_exact(batch, levels_new, cands)
        cfg = self.config
        max_searched = max(cands["per_layer"].keys())
        for qi, row in enumerate(batch):
            row = int(row)
            level = int(levels_new[qi])
            self._install_node(row, level)
            # cap at the layers searched: an earlier row of this batch may
            # have raised max_level past the search's snapshot
            for layer in range(min(level, max_searched), -1, -1):
                ids, _, kept = (a[qi] for a in cands["per_layer"][layer])
                keep = (ids >= 0) & (ids != row)
                m_l = cfg.m0 if layer == 0 else cfg.m
                chosen = np.concatenate([ids[keep & kept],
                                         ids[keep & ~kept]])[:m_l]
                self._set_links(row, layer, chosen)
                for c in chosen:
                    self._add_reverse_link(int(c), layer, row)
            if level > self.max_level:
                self.entry_point = row
                self.max_level = level

    def _layer_list(self, row: int, layer: int) -> np.ndarray:
        if layer == 0:
            return self.nbrs0[row]
        return self.nbrs_up[self.up_offset[row] + layer - 1]

    def _set_links(self, row: int, layer: int, ids: np.ndarray) -> None:
        lst = self._layer_list(row, layer)
        lst[:] = -1
        lst[: len(ids)] = ids
        if layer == 0:
            self._mark_dirty0(row)
        else:
            self._mark_dirty_up(self.up_offset[row] + layer - 1)

    def _add_reverse_link(self, target: int, layer: int, new_row: int):
        if layer == 0:
            self._mark_dirty0(target)
        else:
            self._mark_dirty_up(self.up_offset[target] + layer - 1)
        lst = self._layer_list(target, layer)
        free = np.nonzero(lst < 0)[0]
        if free.size:
            lst[free[0]] = new_row
            return
        # full: heuristic prune (keep spread links, fill closest)
        ids = np.concatenate([lst, [new_row]])
        best = _heuristic_prune_one(self.store.data, self.store.data[target],
                                    ids, lst.shape[0])
        lst[:] = -1
        lst[: len(best)] = best

    def _link_batch_exact(self, batch: np.ndarray, levels_new: np.ndarray,
                          cands: dict) -> None:
        """Vectorized linking from per-query exact candidate pools (the
        reference's, unchanged): nodes install before linking; forward
        links are a masked keep-first selection per layer; reverse links
        fill free slots with one scatter and batch-prune the overfull
        targets."""
        cfg = self.config
        batch = np.asarray(batch, np.int64)
        for qi, row in enumerate(batch):
            self._install_node(int(row), int(levels_new[qi]))
        for qi, row in enumerate(batch):
            if int(levels_new[qi]) > self.max_level:
                self.entry_point = int(row)
                self.max_level = int(levels_new[qi])

        ids_all = np.asarray(cands["ids"])
        kept_all = np.asarray(cands["kept"])
        top_cap = self.max_level if self.max_level >= 0 else 0
        max_l = int(min(levels_new.max(initial=0), top_cap))
        for layer in range(0, max_l + 1):
            at = np.nonzero(levels_new >= layer)[0]
            if at.size == 0:
                continue
            rows = batch[at]
            ids = ids_all[at]
            kept = kept_all[at]
            keep = (
                (ids >= 0)
                & (self.levels[np.maximum(ids, 0)] >= layer)
                & (ids != rows[:, None])
            )
            m_l = cfg.m0 if layer == 0 else cfg.m
            w = min(m_l, ids.shape[1])  # candidate pool may be narrower
            # rank: eligible heuristic-kept < eligible fill < ineligible,
            # distance order preserved within each class (stable sort)
            rank = (~keep).astype(np.int8) * 2 + (~kept).astype(np.int8)
            order = np.argsort(rank, axis=1, kind="stable")[:, :w]
            chosen = np.where(
                np.take_along_axis(keep, order, axis=1),
                np.take_along_axis(ids, order, axis=1),
                -1,
            )
            if layer == 0:
                self.nbrs0[rows] = -1
                self.nbrs0[rows[:, None], np.arange(w)[None, :]] = chosen
                self._mark_dirty0(rows)
            else:
                r = self.up_offset[rows] + layer - 1
                self.nbrs_up[r] = -1
                self.nbrs_up[r[:, None], np.arange(w)[None, :]] = chosen
                self._mark_dirty_up(r)
            self._add_reverse_links_bulk(layer, rows, chosen)

    def _add_reverse_links_bulk(self, layer: int, src_rows: np.ndarray,
                                chosen: np.ndarray) -> None:
        """Add src -> target reverse links for a whole batch at one layer."""
        targets = chosen.ravel()
        news = np.repeat(src_rows, chosen.shape[1])
        ok = targets >= 0
        if not ok.any():
            return
        targets, news = targets[ok], news[ok]
        order = np.argsort(targets, kind="stable")
        targets, news = targets[order], news[order]
        uniq, start, counts = np.unique(
            targets, return_index=True, return_counts=True)

        if layer == 0:
            lists = self.nbrs0[uniq]  # fancy-index copy; written back below
        else:
            up_rows = self.up_offset[uniq] + layer - 1
            lists = self.nbrs_up[up_rows]
        t_count, width = lists.shape

        free = lists < 0
        free_count = free.sum(axis=1)
        n_fit = np.minimum(counts, free_count)
        # column of each target's i-th free slot (free-first stable order)
        free_order = np.argsort(~free, axis=1, kind="stable")
        fit_mask = np.arange(width)[None, :] < n_fit[:, None]
        cols = free_order[fit_mask]  # row-major: target 0's slots, then 1's...
        rows_idx = np.repeat(np.arange(t_count), n_fit)
        within = np.arange(len(targets)) - np.repeat(start, counts)
        vals = news[within < np.repeat(n_fit, counts)]
        lists[rows_idx, cols] = vals

        over = np.nonzero(counts > free_count)[0]
        if over.size:
            # flat-pair reverse prune across all overfull targets: gather
            # only the real (target, candidate) pairs, rank per target and
            # truncate to the closest width + max(32, width) before the
            # O(C^2) heuristic (the reference's approximation)
            t_over = over.size
            ov_map = np.full(t_count, -1, np.int64)
            ov_map[over] = np.arange(t_over)

            cur_lists = lists[over]  # [T, width]
            jj, cc = np.nonzero(cur_lists >= 0)
            tgt_cur = jj
            cand_cur = cur_lists[jj, cc]

            tgt_all = np.repeat(np.arange(t_count), counts)
            j_all = ov_map[tgt_all]
            within_all = np.arange(len(targets)) - np.repeat(start, counts)
            ex = (j_all >= 0) & (within_all >= np.repeat(n_fit, counts))
            tgt_ex = j_all[ex]
            cand_ex = news[ex]

            tgt_f = np.concatenate([tgt_cur, tgt_ex])
            cand_f = np.concatenate([cand_cur, cand_ex]).astype(np.int64)
            t_rows = uniq[over]
            p_n = cand_f.size
            if p_n >= _PAIR_DEVICE_MIN:
                mirror = serving_mirror(self.store)
                dev = self.store.torch_device
                d_f = pair_sq_l2(
                    mirror.x, mirror.x_sq,
                    to_device(t_rows[tgt_f].astype(np.int32), dev),
                    to_device(cand_f.astype(np.int32), dev)).cpu().numpy()
            else:
                tvf = self.store.data[t_rows]  # [T, D]
                diff = self.store.data[cand_f] - tvf[tgt_f]  # [P, D]
                d_f = np.einsum("pd,pd->p", diff, diff)

            c_trunc = width + max(32, width)
            order_f = np.lexsort((d_f, tgt_f))  # stable: cur before extras
            tgt_s = tgt_f[order_f]
            cand_s = cand_f[order_f]
            d_s = d_f[order_f]
            starts_t = np.searchsorted(tgt_s, np.arange(t_over))
            rank_f = np.arange(len(tgt_s)) - starts_t[tgt_s]
            in_t = rank_f < c_trunc
            cand = np.full((t_over, c_trunc), -1, np.int64)
            d = np.full((t_over, c_trunc), np.inf, np.float32)
            cand[tgt_s[in_t], rank_f[in_t]] = cand_s[in_t]
            d[tgt_s[in_t], rank_f[in_t]] = d_s[in_t]

            if t_over >= _KEPT_DEVICE_MIN:
                mirror = serving_mirror(self.store)
                dev = self.store.torch_device
                kept = heuristic_kept(
                    mirror.x, to_device(cand.astype(np.int32), dev),
                    to_device(d, dev), width).cpu().numpy()
            else:
                kept = _heuristic_kept_host(
                    self.store.data[np.maximum(cand, 0)], d, cand >= 0, width)
            # kept-first then closest-unkept fill, take `width`
            rank = (~kept).astype(np.int8) + (cand < 0).astype(np.int8) * 2
            sel_order = np.argsort(rank, axis=1, kind="stable")[:, :width]
            sel = np.take_along_axis(cand, sel_order, axis=1)
            sel_ok = np.take_along_axis(rank, sel_order, axis=1) < 2
            lists[over] = np.where(sel_ok, sel, -1).astype(lists.dtype)

        if layer == 0:
            self.nbrs0[uniq] = lists
            self._mark_dirty0(uniq)
        else:
            self.nbrs_up[up_rows] = lists
            self._mark_dirty_up(up_rows)

    # ---------------------------------------------------------------- search
    def search_rows(self, queries: np.ndarray, k: int, ef: int | None = None,
                    extra_mask: np.ndarray | None = None):
        """Greedy descent (K10) + one layer-0 beam (K11) over the serving
        mirror (f32 or bf16). Returns (distances [B, k] true euclidean, rows
        [B, k]); ``extra_mask`` (a filter) gates the results only, not the
        traversal."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        ef = bucket(max(ef or self.config.ef_search, k))
        self._fix_entry_point()
        b = queries.shape[0]
        if self.entry_point < 0:
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int32))
        mirror = serving_mirror(self.store)
        dev = self._device_arrays()
        # the mask fits the mirror's row count: a concurrent capacity grow
        # between the two snapshots must not mix shapes
        mask = self._search_mask(n=int(mirror.x.shape[0]))
        device = self.store.torch_device
        mask_d = to_device(mask, device)
        res_mask = None
        if extra_mask is not None:
            res_mask = to_device(mask & fit_mask(extra_mask, mask.shape[0]),
                                 device)
        q = to_device(queries, device)
        cur, _ = greedy_descent(mirror.x, mirror.x_sq, mask_d,
                                dev["nbrs_up"], dev["up_offset"], q,
                                self.entry_point, max(self.max_level, 0))
        pool_d, pool_id = beam_search(
            mirror.x, mirror.x_sq, mask_d, dev["nbrs0"], dev["nbrs_up"],
            dev["up_offset"], q, cur[:, None], None, layer=0, ef=ef,
            max_iters=ef + 32, result_mask=res_mask,
            expand=limits.beam_expand())
        d, rows = to_host(pool_d, pool_id)
        d, rows = d[:, :k], rows[:, :k]
        d = np.sqrt(np.maximum(d, 0.0))
        d[rows < 0] = np.inf
        return d, rows

    # ------------------------------------------------------------ operations
    def remove_rows(self, rows: np.ndarray) -> int:
        """Physically scrub rows from the graph (vacuum/migration path).
        Returns count removed."""
        self._invalidate_device()
        rows = np.asarray(rows, np.int64)
        rows = rows[self.levels[rows] >= 0] if rows.size else rows
        if rows.size == 0:
            return 0
        dead = set(int(r) for r in rows)
        # scrub dangling refs from all member lists
        members = self.member_rows()
        dead_mask = np.zeros(self.levels.shape[0], bool)
        dead_mask[list(dead)] = True
        for r in members:
            if r in dead:
                continue
            self._scrub_list(self.nbrs0[r], dead_mask)
            lvl = int(self.levels[r])
            for layer in range(1, lvl + 1):
                self._scrub_list(
                    self.nbrs_up[self.up_offset[r] + layer - 1], dead_mask)
        for r in rows:
            self.levels[r] = -1
            self.nbrs0[r] = -1
            self.up_offset[r] = -1
        self._version += 1
        self._fix_entry_point()
        return int(rows.size)

    @staticmethod
    def _scrub_list(lst: np.ndarray, dead_mask: np.ndarray) -> None:
        valid = lst >= 0
        bad = valid & dead_mask[np.maximum(lst, 0)]
        if bad.any():
            kept = lst[valid & ~bad]
            lst[:] = -1
            lst[: kept.size] = kept

    def vacuum(self) -> int:
        """Remove soft-deleted members from the graph."""
        self._invalidate_device()
        m = self.member_mask()[: self.store.count]
        dead = np.nonzero(m & self.store.deleted[: self.store.count])[0]
        return self.remove_rows(dead)

    # ---------------------------------------------------------- persistence
    def export_graph(self, order: np.ndarray) -> dict:
        """The graph of the rows in ``order`` (store rows, all members),
        adjacency remapped to positions within ``order`` so it loads into a
        store of another row layout (the reference's export_graph)."""
        order = np.asarray(order, np.int64)
        pos = np.full(self.levels.shape[0], -1, np.int64)
        pos[order] = np.arange(order.size)

        def remap(a):
            return np.where(a >= 0, pos[np.maximum(a, 0)], -1).astype(np.int32)

        levels = self.levels[order].astype(np.int16)
        nbrs0 = remap(self.nbrs0[order])
        ups = []
        up_pos = np.full(order.size, -1, np.int64)
        cnt = 0
        for i, r in enumerate(order):
            lvl = int(levels[i])
            if lvl > 0:
                off = self.up_offset[r]
                ups.append(remap(self.nbrs_up[off: off + lvl]))
                up_pos[i] = cnt
                cnt += lvl
        nbrs_up = (
            np.vstack(ups) if ups else np.zeros((0, self.config.m), np.int32)
        )
        entry_pos = int(pos[self.entry_point]) if self.entry_point >= 0 else -1
        return {
            "m": self.config.m,
            "m0": self.config.m0,
            "levels": levels,
            "nbrs0": nbrs0,
            "nbrs_up": nbrs_up,
            "up_offset_pos": up_pos.astype(np.int64),
            "entry_pos": entry_pos,
            "max_level": int(self.max_level),
        }

    def install_graph(self, rows: np.ndarray, g: dict) -> None:
        """Inverse of export_graph: rows[i] is the store row of position i.
        The device adjacency is uploaded whole on its next use."""
        self._invalidate_device()
        rows = np.asarray(rows, np.int64)
        self._ensure_capacity()

        def remap(a):
            a = np.asarray(a, np.int64)
            return np.where(a >= 0, rows[np.maximum(a, 0)], -1).astype(np.int32)

        levels = np.asarray(g["levels"], np.int16)
        self.levels[rows] = levels
        self.nbrs0[rows] = remap(g["nbrs0"])
        nbrs_up = np.asarray(g["nbrs_up"], np.int64)
        up_pos = np.asarray(g["up_offset_pos"], np.int64)
        for i, r in enumerate(rows):
            lvl = int(levels[i])
            if lvl > 0:
                off = self._alloc_up_rows(lvl)
                self.up_offset[r] = off
                self.nbrs_up[off: off + lvl] = remap(
                    nbrs_up[up_pos[i]: up_pos[i] + lvl])
        entry_pos = int(g["entry_pos"])
        self.entry_point = int(rows[entry_pos]) if entry_pos >= 0 else -1
        self.max_level = int(g["max_level"])
        self._version += 1

    def graph_stats(self) -> GraphStats:
        members = self.member_rows()
        edges = int((self.nbrs0[members] >= 0).sum())
        for r in members:
            lvl = int(self.levels[r])
            if lvl > 0:
                off = self.up_offset[r]
                edges += int((self.nbrs_up[off: off + lvl] >= 0).sum())
        n = members.size
        return GraphStats(
            num_nodes=int(n),
            num_edges=edges,
            avg_degree=edges / n if n else 0.0,
            max_layer=int(self.levels[members].max()) if n else -1,
        )

    def memory_usage_bytes(self) -> int:
        return int(self.nbrs0.nbytes + self.nbrs_up.nbytes
                   + self.levels.nbytes + self.up_offset.nbytes)
