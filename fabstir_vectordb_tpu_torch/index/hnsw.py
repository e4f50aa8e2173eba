"""HNSW graph index, insert path: fixed-degree adjacency built by exact
device candidates and host linking.

The JAX package's ``index/hnsw.py`` as far as the flat-regime slice needs
it. The host side (level sampling from ``np.random.default_rng(seed)``,
dense -1 padded adjacency ``nbrs0 [cap, M0]`` / ``nbrs_up``, the vectorised
linking and the reverse-link prune) is a copy. The device side is:

- link candidates: the exact top-``ef_construction`` members of each new
  row, from the fused L2 top-k kernel (K1, ``ops.topk.l2_topk``) over the
  member-occupied prefix of the mirror, with a device member mask updated
  in place per batch;
- the neighbour-selection heuristic (K4, :func:`heuristic_kept`);
- the row-pair distances of the reverse-link prune (K5, :func:`pair_sq_l2`).

Graph search (greedy descent + layer-0 beam) comes with the pruned serving
regime; so does the beam candidate plan used above the flat threshold.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.topk import l2_topk
from ..utils import limits, native
from ..utils.padding import bucket, grow_rows
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


@dataclass
class GraphStats:
    num_nodes: int
    num_edges: int
    avg_degree: float
    max_layer: int


# ---------------------------------------------------------------------------
# Device kernels and their plain versions
# ---------------------------------------------------------------------------

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


def heuristic_kept(x, cand_ids, cand_d, m: int) -> torch.Tensor:
    """K4: heuristic-selection mask. cand_ids int32 / cand_d f32 [B, C],
    each row sorted ascending by distance to its query (-1 / +inf padded,
    C <= 128 on the card). Returns kept [B, C] bool with at most m True a
    row. A -1 id gathers row 0 but is never kept. The plain version on CPU
    tensors, csrc/heuristic_kept.cu on CUDA tensors."""
    if x.device.type == "cpu":
        return heuristic_kept_plain(x, cand_ids, cand_d, m)
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
    native.check(cand_ids, "cand_ids", torch.int32, 2, dev)
    native.check(cand_d, "cand_d", torch.float32, 2, dev)
    b, c = cand_ids.shape
    if cand_d.shape != cand_ids.shape or not 1 <= c <= 128:
        raise ValueError(f"heuristic_kept takes [B, C<=128] candidates, "
                         f"got {tuple(cand_ids.shape)}")
    kept = torch.empty((b, c), dtype=torch.uint8, device=dev)
    if b == 0:
        return kept.bool()
    P, I = native.P, native.I
    native.call(
        "heuristic_kept", "fvdb_heuristic_kept", [P, P, P, I, I, I, I, P, P],
        x.data_ptr(), cand_ids.data_ptr(), cand_d.data_ptr(), b, c,
        x.shape[1], m, kept.data_ptr(), native.stream_of(x))
    native.launches["heuristic_kept"] += 1
    return kept.bool()


def pair_sq_l2_plain(x, x_sq, t_ids, c_ids) -> torch.Tensor:
    t, c = t_ids.long(), c_ids.long()
    dots = (x[t].float() * x[c].float()).sum(-1)
    return (x_sq[t] - 2.0 * dots + x_sq[c]).clamp_min(0.0)


def pair_sq_l2(x, x_sq, t_ids, c_ids) -> torch.Tensor:
    """K5: squared L2 between row pairs of the mirror: int32 [P] x 2 ->
    f32 [P]. The plain version on CPU tensors, csrc/pair_sq_l2.cu on CUDA
    tensors (ids must be in range there)."""
    if x.device.type == "cpu":
        return pair_sq_l2_plain(x, x_sq, t_ids, c_ids)
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
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
        "pair_sq_l2", "fvdb_pair_sq_l2", [P, P, P, P, I, I, P, P],
        x.data_ptr(), x_sq.data_ptr(), t_ids.data_ptr(), c_ids.data_ptr(), p,
        x.shape[1], out.data_ptr(), native.stream_of(x))
    native.launches["pair_sq_l2"] += 1
    return out


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


# flat-pair counts / table rows above which the reverse-link prune computes
# on the device against the resident mirror instead of gathering rows on
# the host
_PAIR_DEVICE_MIN = 16_384
_KEPT_DEVICE_MIN = 1_024


# ---------------------------------------------------------------------------
# Host index
# ---------------------------------------------------------------------------


class HNSWIndex:
    """HNSW over a shared VectorStore: device candidates, host linking."""

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
            if n_members > cfg.bootstrap_threshold:
                plan = self._flat_plan(extra_hi=pending_hi)
            if plan is not None and plan[0]:
                n_pad = plan[1]
                if mask_dev is None:
                    mask_dev = to_device(self._search_mask(), self.store.device)
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
        """Set ``batch`` rows of the device mask, in place. Safe next to
        the candidate kernels already launched on the mask: they were
        enqueued first on the same stream, so they read it before this
        write runs."""
        mask_dev[to_device(batch.astype(np.int64), mask_dev.device)] = True

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
        q = to_device(self.store.data[batch], self.store.device)
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
            cands = self._device_candidates(batch)

        self._link_batch_exact(batch, levels_new, cands)
        self._version += 1

    def _install_node(self, row: int, level: int) -> None:
        self.levels[row] = level
        self.nbrs0[row] = -1
        if level > 0:
            off = self._alloc_up_rows(level)
            self.up_offset[row] = off
            self.nbrs_up[off: off + level] = -1

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

    def _device_candidates(self, batch: np.ndarray) -> dict:
        flat_link_ok, n_pad = self._flat_plan()
        if flat_link_ok:
            mask = to_device(self._search_mask(), self.store.device)
            return self._flat_finalize(
                self._flat_dispatch(batch, mask, n_pad))
        raise NotImplementedError(
            "graph-beam link candidates (a member prefix above the flat "
            "threshold) are not ported yet")

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
            else:
                r = self.up_offset[rows] + layer - 1
                self.nbrs_up[r] = -1
                self.nbrs_up[r[:, None], np.arange(w)[None, :]] = chosen
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
                dev = self.store.device
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
                dev = self.store.device
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
        else:
            self.nbrs_up[up_rows] = lists

    # ------------------------------------------------------------ operations
    def remove_rows(self, rows: np.ndarray) -> int:
        """Physically scrub rows from the graph (vacuum/migration path).
        Returns count removed."""
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
        m = self.member_mask()[: self.store.count]
        dead = np.nonzero(m & self.store.deleted[: self.store.count])[0]
        return self.remove_rows(dead)

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
