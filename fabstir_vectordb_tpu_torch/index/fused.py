"""Fused search: the whole query path in one short chain of device launches.

The JAX package's ``index/fused.py`` for three regimes, picked by capacity:

- flat (up to the flat threshold): one masked exact L2 top-k (K1) with
  the membership / soft-delete / filter mask fused into selection, over the
  f32 mirror or, with FVDB_SERVING_DTYPE=bfloat16, a bf16 one (twice the
  threshold): there K1 takes a wider pool with the query rounded to bf16
  and K2 re-scores it in f32 (:func:`flat_search_rerank`), and by default
  the host re-scores the survivors from the f32 rows. FVDB_FLAT_SELECT=
  approx takes the pool from K9's bins instead (:func:`flat_search_approx`);
- reduced-rank (above it, FVDB_PCA_SERVE=1, the default): the corpus
  projected on its top principal directions into a bf16 [N, r] mirror
  (K14's projection), a wide stage-1 pool over that mirror (K14's
  selection), then an exact f32 re-score of the pool: on the device against
  a full-dim bf16 mirror (K2) followed by an exact host re-score of the
  survivors, or on the host alone. The pool width is calibrated at build
  time against an exact oracle of probe queries (K1 on bf16 blocks + K8's
  merge), streamed over the same blocks as the projection. A store with a
  procedural source (utils/synth.py) has its full-dim mirror, or in host
  mode the projection's blocks, generated on the device by K17;
- pruned (above it, with FVDB_PCA_SERVE=0): K13 :func:`hybrid_search`,
  greedy descent (K10) and a layer-0 beam (K11) over the HNSW members, then
  the IVF n-probe scan (K12) over the IVF members, seeded with the beam's
  top-k so the two results merge inside K12's selection; on the f32 mirror
  or, with FVDB_SERVING_DTYPE=bfloat16, on the bf16 one (rows upcast, the
  f32 query, the f32 host rows' norms).

A query batch is one upload, the launches, and one [B, k] readback (plus,
in the reduced-rank regime, the host re-score). Engine state (mirrors,
masks, adjacency, tiles) stays on the device between calls, keyed by the
engines' versions; the regimes release each other's state.

Distances returned are squared euclidean (callers take the square root).
"""
from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import torch

from ..ops.distance import pairwise_sq_l2
from ..ops.projection import pca_basis
from ..ops.topk import (_MAX_GRID_Q, _splits, INF, approx_topk, l2_topk,
                        l2_topk_plain, masked_topk_plain, merge_topk,
                        merge_topk_plain, select_scratch)
from ..utils import limits, native
from ..utils.padding import bucket, fit_mask, round_up
from ..utils.transfer import put_bf16_blocks, to_device, to_host
from .hnsw import (beam_search, beam_search_plain, greedy_descent,
                   greedy_descent_plain)
from .ivf import IVFLists, ivf_search, ivf_search_plain
from .store import serving_mirror


def hybrid_search(x, x_sq, hnsw_mask, ivf_mask, extra_mask, nbrs0, nbrs_up,
                  up_offset, entry: int, entry_level: int,
                  ivf: IVFLists | None, q, k: int, ef: int, n_probe: int,
                  has_hnsw: bool, has_filter: bool = False,
                  beam_expand: int = 1, plain: bool = False):
    """K13, the pruned regime's query (the reference's
    hybrid_search_kernel): K10 greedy descent over the HNSW members, a K11
    layer-0 beam (ef, ``ef + 32`` steps, the filter as its result mask
    only), then K12 over the IVF members (ANDed with the filter) of
    ``ivf``'s lists (None: no IVF rows to search), seeded with the beam's
    top-k. The masks are disjoint, so the seeded selection is the
    reference's two merge_topk calls. Returns (vals [B, k], rows [B, k]).
    ``plain`` runs the kernels' plain versions instead (the kernels take
    those themselves on CPU tensors)."""
    gd, bs, iv = ((greedy_descent_plain, beam_search_plain, ivf_search_plain)
                  if plain else (greedy_descent, beam_search, ivf_search))
    b = q.shape[0]
    seed = None
    if has_hnsw:
        cur, _ = gd(x, x_sq, hnsw_mask, nbrs_up, up_offset, q, entry,
                    entry_level)
        # traversal keeps the whole graph; the filter only gates which rows
        # may enter the results
        seed = bs(x, x_sq, hnsw_mask, nbrs0, nbrs_up, up_offset, q,
                  cur[:, None], None, 0, ef, ef + 32,
                  extra_mask if has_filter else None, True, beam_expand)
    if ivf is not None:
        vals, rows, _ = iv(x, x_sq, ivf_mask, ivf, q, k, n_probe,
                           extra_mask if has_filter else None, seed)
        return vals, rows
    vals = torch.full((b, k), float("inf"), device=q.device)
    rows = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    if seed is not None:  # the beam's list is sorted and padded already
        w = min(k, seed[0].shape[1])
        vals[:, :w], rows[:, :w] = seed[0][:, :w], seed[1][:, :w]
    return vals, rows


def hybrid_search_plain(*args, **kwargs):
    """K13 with every kernel's plain version."""
    return hybrid_search(*args, plain=True, **kwargs)


# ------------------------------------------------------------- K14, K2, K8
def stage1_select_plain(xp, xp_sq, mask, qp, ov_k: int):
    """Plain version of K14's stage 1: max(|qp|^2 - 2 bf16(qp).xp + xp_sq,
    0), the product of bf16 values taken in f32, then the exact masked
    top-ov_k by (distance, row)."""
    qr = qp.to(torch.bfloat16).float()
    q_sq = (qp * qp).sum(-1)
    d = (q_sq[:, None] - 2.0 * (qr @ xp.float().T) + xp_sq[None, :])
    return masked_topk_plain(d.clamp_min(0.0), mask, ov_k)


def stage1_select(xp, xp_sq, mask, qp, ov_k: int,
                  transient_bytes: int | None = None):
    """K14's stage 1 (the reference's stage1_select_kernel): the ov_k
    nearest rows of the projected bf16 mirror xp [N, r] (f32 norms xp_sq
    [N], mask [N] bool or None) to the projected queries qp [B, r] f32.
    Returns (vals [B, ov_k], rows [B, ov_k]) sorted by (distance, row),
    padded with (+inf, -1). A launch takes as many queries as keep its
    [queries, N] f32 buffer within ``transient_bytes`` (None:
    limits.stage1_transient_bytes()). The plain version on CPU tensors,
    csrc/stage1_select.cu on CUDA tensors."""
    if xp.device.type == "cpu":
        return stage1_select_plain(xp, xp_sq, mask, qp, ov_k)
    dev = xp.device
    native.check(xp, "xp", torch.bfloat16, 2, dev)
    native.check(xp_sq, "xp_sq", torch.float32, 1, dev)
    native.check(qp, "qp", torch.float32, 2, dev)
    if mask is not None:
        native.check(mask, "mask", torch.bool, 1, dev)
    n, r = xp.shape
    b = qp.shape[0]
    if qp.shape[1] != r or xp_sq.shape[0] != n or ov_k < 1 \
            or (mask is not None and mask.shape[0] != n):
        raise ValueError("shape mismatch in stage1_select")
    out_d = torch.empty((b, ov_k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, ov_k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_r
    P, I = native.P, native.I
    m_ptr = 0 if mask is None else mask.data_ptr()
    # query chunks keep the [chunk, N] distance buffer within the budget
    if transient_bytes is None:
        transient_bytes = limits.stage1_transient_bytes()
    qc = max(1, min(b, int(transient_bytes) // (4 * n), _MAX_GRID_Q))
    for lo in range(0, b, qc):
        hi = min(b, lo + qc)
        dump = torch.empty((hi - lo, n), dtype=torch.float32, device=dev)
        work = select_scratch("stage1_select", hi - lo, ov_k, dev)
        native.call(
            "stage1_select", "fvdb_stage1_select",
            [P, P, P, P, I, I, I, I, I, P, P, P, P, P],
            xp.data_ptr(), xp_sq.data_ptr(), m_ptr, qp[lo:hi].data_ptr(),
            hi - lo, n, r, ov_k, _splits(hi - lo, n, dev), dump.data_ptr(),
            work.data_ptr(), out_d[lo:hi].data_ptr(), out_r[lo:hi].data_ptr(),
            native.stream_of(xp))
        native.launches["stage1_select"] += 1
    return out_d, out_r


def project_rows_plain(src, mu, p, out, out_sq, lo: int = 0) -> None:
    """Plain version of K14's projection: bf16((f32 src - mu) @ p) written
    into out[lo:lo+n] and the f32 norms of those bf16 rows into
    out_sq[lo:lo+n]."""
    y = ((src.float() - mu) @ p).to(torch.bfloat16)
    out[lo:lo + y.shape[0]] = y
    yf = y.float()
    out_sq[lo:lo + y.shape[0]] = (yf * yf).sum(1)


def split_bf16x3(p):
    """P [D, r] f32 as three bf16 matrices (hi, mid, lo) whose sum is P:
    each the round to nearest of what the ones before leave. The plain
    statement of csrc/project_rows.cu's split."""
    hi = p.to(torch.bfloat16)
    r1 = p - hi.float()  # exact
    mid = r1.to(torch.bfloat16)
    return hi, mid, (r1 - mid.float()).to(torch.bfloat16)


def project_rows_split_plain(src, mu, p, block: int = 64):
    """The arithmetic of K14's tensor-core kernel in plain PyTorch, f32
    [n, r] before rounding: bf16 rows times each part of P's exact split
    (products exact in f32, sums in f32), each ``block`` dims (the
    kernel's window) summed apart and then added to the running sums less
    that block's share of mu . P."""
    x = src.float()
    parts = [t.float() for t in split_bf16x3(p)]
    acc = torch.zeros((x.shape[0], p.shape[1]), dtype=torch.float32,
                      device=x.device)
    for d0 in range(0, x.shape[1], block):
        xs = x[:, d0:d0 + block]
        step = sum(xs @ t[d0:d0 + block] for t in parts)
        acc = acc + (step - mu[d0:d0 + block] @ p[d0:d0 + block])
    return acc


def project_rows(src, mu, p, out, out_sq, lo: int = 0) -> None:
    """K14's projection of a block (the reference's _project_chunk,
    _xp_write and _bf16_row_norms): src [n, D] bf16 rows, mu [D] and
    p [D, r] f32; writes rows lo .. lo + n - 1 of the bf16 mirror out
    [N, r] and of its norms out_sq [N] in place. The plain version on CPU
    tensors; on CUDA tensors csrc/project_rows.cu (P's exact bf16 split,
    then the products on the tensor cores) or it raises."""
    if src.device.type == "cpu":
        return project_rows_plain(src, mu, p, out, out_sq, lo)
    dev = src.device
    n, d, r = _proj_args(src, torch.bfloat16, mu, p)
    native.check(out, "out", torch.bfloat16, 2, dev)
    native.check(out_sq, "out_sq", torch.float32, 1, dev)
    if out.shape[1] != r or lo < 0 or lo + n > out.shape[0] \
            or out_sq.shape[0] != out.shape[0]:
        raise ValueError("project_rows: the block does not fit the mirror")
    if n == 0:
        return None
    P, I, L = native.P, native.I, native.L
    if d % 8 or src.data_ptr() % 16:  # TMA reads 16-byte aligned rows
        src = torch.nn.functional.pad(src, (0, -d % 8))
    work = torch.empty(native.query("project_rows",
                                    "fvdb_project_scratch_bytes", [I, I], d,
                                    r), dtype=torch.uint8, device=dev)
    native.call("project_rows", "fvdb_project_rows",
                [P, I, I, I, P, P, I, L, P, P, P, P], src.data_ptr(), n, d,
                src.shape[1], mu.data_ptr(), p.data_ptr(), r, lo,
                out.data_ptr(), out_sq.data_ptr(), work.data_ptr(),
                native.stream_of(src))
    native.launches["project_rows"] += 1
    return None


def project_queries_plain(q, mu, p):
    return (q - mu) @ p


def project_queries(q, mu, p):
    """Queries into the reduced-rank space: (q - mu) @ p in f32, [B, r].
    The plain version on CPU tensors, csrc/project_rows.cu on CUDA
    tensors."""
    if q.device.type == "cpu":
        return project_queries_plain(q, mu, p)
    b, d, r = _proj_args(q, torch.float32, mu, p)
    out = torch.empty((b, r), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    P, I = native.P, native.I
    native.call("project_rows", "fvdb_project_queries",
                [P, I, I, P, P, I, P, P], q.data_ptr(), b, d, mu.data_ptr(),
                p.data_ptr(), r, out.data_ptr(), native.stream_of(q))
    native.launches["project_queries"] += 1
    return out


def _proj_args(src, dtype, mu, p):
    dev = src.device
    native.check(src, "src", dtype, 2, dev)
    native.check(mu, "mu", torch.float32, 1, dev)
    native.check(p, "p", torch.float32, 2, dev)
    n, d = src.shape
    if mu.shape[0] != d or p.shape[0] != d or p.shape[1] < 1:
        raise ValueError(f"projection of [n, {d}] rows takes mu [{d}] and "
                         f"p [{d}, r >= 1], got {tuple(p.shape)}")
    return n, d, p.shape[1]


def rerank_f32_plain(x, q, rows, m: int):
    """Plain version of K2: difference-form f32 distances of the candidate
    rows of the f32 or bf16 mirror x, then the m first by (distance,
    row)."""
    xg = x[rows.clamp_min(0).long()].float()  # [B, OV, D]
    diff = xg - q[:, None, :]
    d = (diff * diff).sum(-1)
    d = torch.where(rows >= 0, d, torch.full_like(d, INF))
    # the merge with an empty list is the (distance, row) top-m, padded
    return merge_topk_plain(d, rows, d[:, :0], rows[:, :0], m)


def rerank_f32(x, q, rows, m: int):
    """K2 (the reference's rerank_f32_kernel): re-score each query's
    candidate rows rows [B, OV] int32 (-1: none; distinct, as stage 1 and
    K1 / K9 give them) of the mirror x [N, D] (bf16, upcast exactly, or
    f32) against q [B, D] f32 in the difference form, and keep the m first
    by (distance, row), padded with (+inf, -1). The plain version on CPU
    tensors, csrc/rerank_f32.cu on CUDA tensors."""
    if x.device.type == "cpu":
        return rerank_f32_plain(x, q, rows, m)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    native.check(x, "x", torch.bfloat16 if bf16 else torch.float32, 2, dev)
    native.check(q, "q", torch.float32, 2, dev)
    native.check(rows, "rows", torch.int32, 2, dev)
    n, d = x.shape
    b, ov = rows.shape
    if q.shape != (b, d) or m < 1:
        raise ValueError("shape mismatch in rerank_f32")
    out_d = torch.empty((b, m), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, m), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_r
    P, I = native.P, native.I
    for lo in range(0, b, _MAX_GRID_Q):  # the select's grid caps a launch
        hi = min(b, lo + _MAX_GRID_Q)
        dist = torch.empty((hi - lo, ov), dtype=torch.float32, device=dev)
        work = select_scratch("rerank_f32", hi - lo, m, dev)
        native.call("rerank_f32",
                    "fvdb_rerank_f32" if bf16 else "fvdb_rerank_f32_rows",
                    [P, I, I, P, P, I, I, I, P, P, P, P, P],
                    x.data_ptr(), n, d, q[lo:hi].data_ptr(),
                    rows[lo:hi].data_ptr(), hi - lo, ov, m, dist.data_ptr(),
                    work.data_ptr(), out_d[lo:hi].data_ptr(),
                    out_r[lo:hi].data_ptr(), native.stream_of(x))
        native.launches["rerank_f32" if bf16 else "rerank_f32_rows"] += 1
    return out_d, out_r


def flat_search_rerank(x, x_sq, mask, q, k: int, ov_k: int,
                       plain: bool = False):
    """The reference's flat_search_rerank_kernel: K1 over the bf16 serving
    mirror x [N, D] with the query rounded to bf16 (x_sq the f32 norms of
    the f32 host rows) for a pool of ov_k, then K2's f32 re-score of the
    pool to k. ``plain`` runs both plain versions."""
    topk, rr = (l2_topk_plain, rerank_f32_plain) if plain \
        else (l2_topk, rerank_f32)
    _, rows = topk(x, x_sq, mask, q, ov_k, round_query=True)
    return rr(x, q, rows, k)


def flat_search_approx(x, x_sq, mask, q, k: int, ov_k: int):
    """The reference's flat_search_approx_kernel: K9's binned pool of ov_k
    over the f32 or bf16 serving mirror x [N, D] (a bf16 mirror rounds the
    query, as the reference's bf16 compute does), then K2's f32 re-score of
    the pool to k; masked rows never enter the pool, so they cannot come
    back through the re-score."""
    _, rows = approx_topk(x, x_sq, mask, q, ov_k,
                          round_query=x.dtype == torch.bfloat16)
    return rerank_f32(x, q, rows, k)


def oracle_step_plain(blk, m, q, base: int, vals, rows, k: int):
    """Plain version of K8's oracle step: the exact top-k of q against the
    bf16 block blk (upcast, norms from the upcast rows), rows offset by
    base, merged into the running (vals, rows)."""
    d = pairwise_sq_l2(q, blk.float())
    tv, ti = masked_topk_plain(d, m, k)
    tr = torch.where(ti >= 0, ti + base, ti)
    return merge_topk_plain(vals, rows, tv, tr, k)


def oracle_step(blk, m, q, base: int, vals, rows, k: int):
    """K8's oracle step (the reference's _oracle_step): the running exact
    top-k (vals, rows [B, k]) of probe queries q [B, D] over streamed bf16
    corpus blocks; this block blk [n, D] holds rows base .. base + n - 1,
    masked by m [n]. K1 on the bf16 block, then K8's merge; the plain
    version on CPU tensors."""
    if blk.device.type == "cpu":
        return oracle_step_plain(blk, m, q, base, vals, rows, k)
    tv, tr = l2_topk(blk, None, m, q, k, row_base=base)
    return merge_topk(vals, rows, tv, tr, k)


class FusedSearcher:
    """Caches device-resident engine state and launches fused searches."""

    def __init__(self, hybrid):
        self.hybrid = hybrid
        self._key = None
        self._dev: dict | None = None
        self._state_lock = threading.RLock()
        # device filter mask keyed by content digest: repeated filtered
        # queries would otherwise upload a capacity-sized mask every call
        self._mask_digest: bytes | None = None
        self._mask_dev = None
        # reduced-rank state: PCA fit + projected bf16 mirror (+ the
        # full-dim bf16 rerank mirror), keyed by (store version, rank, fit)
        self._proj_key = None
        self._proj: dict | None = None
        # the members mask alone, all the reduced-rank regime needs (the
        # full-dim f32 mirror is never resident there)
        self._members_key = None
        self._members_dev = None
        # a projection installed from outside (convert.install_projection):
        # (mu [D], p [D, r]), used instead of a fit
        self._fit = None

    def _device_mask(self, extra_mask: np.ndarray) -> torch.Tensor:
        m = np.ascontiguousarray(extra_mask)
        digest = hashlib.blake2b(m.tobytes(), digest_size=16).digest()
        if digest != self._mask_digest:
            self._mask_dev = to_device(m, self.hybrid.store.device)
            self._mask_digest = digest
        return self._mask_dev

    def _state_key(self):
        h = self.hybrid
        return (h.store._version, h.hnsw._version, h.ivf._version,
                limits.serving_dtype())

    def _device_state(self, pruned: bool = False) -> dict:
        """Mirror and masks; with ``pruned``, also the graph and the IVF's
        device lists (the flat regime reads none of those)."""
        dev, key = self._dev, self._key
        if dev is not None and key == self._state_key() + (pruned,):
            return dev
        with self._state_lock:
            if self._dev is None or self._key != self._state_key() + (pruned,):
                self._dev = None  # release before the new upload
                self._dev = self._build_state(pruned)
                self._key = self._state_key() + (pruned,)
            return self._dev

    def _build_state(self, pruned: bool) -> dict:
        h = self.hybrid
        if pruned:
            h.hnsw._fix_entry_point()  # the entry may have been deleted
        mirror = serving_mirror(h.store)
        device = h.store.device
        n = int(mirror.x.shape[0])
        active = h.store.active_mask(n)
        hnsw_mask = active & h.hnsw.member_mask(n)
        # a row both engines claim mid-migration is served once
        ivf_mask = active & h.ivf.member_mask(n) & ~hnsw_mask
        state = {
            "x": mirror.x,
            "x_sq": mirror.x_sq,
            "members": to_device(hnsw_mask | ivf_mask, device),
        }
        if not pruned:
            return state
        graph = h.hnsw._device_arrays()
        has_ivf = h.ivf.trained and bool(ivf_mask.any())
        state.update(
            hnsw_mask=to_device(hnsw_mask, device),
            ivf_mask=to_device(ivf_mask, device),
            ones=torch.ones(n, dtype=torch.bool, device=device),
            nbrs0=graph["nbrs0"], nbrs_up=graph["nbrs_up"],
            up_offset=graph["up_offset"],
            entry=max(h.hnsw.entry_point, 0),
            entry_level=max(h.hnsw.max_level, 0),
            ivf=h.ivf.device_lists() if has_ivf else None,
            has_hnsw=h.hnsw.num_nodes > 0 and h.hnsw.entry_point >= 0)
        return state

    # rows per projection block when the corpus streams from the host; the
    # mirror's rows are the count rounded up to _PROJ_ROW_PAD, not the
    # power-of-two capacity
    _PROJ_CHUNK = 2_097_152
    _PROJ_ROW_PAD = 1_048_576
    _PROBES = 128  # calibration probe queries
    _CAL_K = 10  # recall@k the calibration targets

    def install_fit(self, mu: np.ndarray | None, p: np.ndarray | None) -> None:
        """Serve the reduced-rank regime with this projection (mu [D],
        p [D, r]) instead of fitting one; the rank is r, the oversample is
        calibrated (or pinned by FVDB_PCA_OVERSAMPLE) as for a fit.
        ``mu=None`` goes back to fitting the corpus."""
        fit = None
        if mu is not None:
            mu = np.ascontiguousarray(mu, np.float32)
            p = np.ascontiguousarray(p, np.float32)
            if mu.shape != (self.hybrid.store.dim,) \
                    or p.shape[0] != mu.shape[0]:
                raise ValueError(f"a fit of mu {mu.shape}, p {p.shape} does "
                                 f"not fit dim {self.hybrid.store.dim}")
            fit = (mu, p)
        with self._state_lock:
            self._fit = fit
            self._release_proj()  # the next search builds on this fit

    def _proj_state(self) -> dict:
        """Reduced-rank serving state (the reference's _proj_state): PCA fit,
        projected bf16 mirror with its norms, the calibrated oversample and,
        in device rerank mode, the full-dim bf16 mirror. Rebuilt when the
        store version or the rank changes, or a fit is installed."""
        rank_req = limits.pca_rank()
        key = (self.hybrid.store._version, rank_req)
        if self._proj is not None and self._proj_key == key:
            return self._proj
        with self._state_lock:
            return self._proj_state_locked(key, rank_req)

    def _proj_state_locked(self, key, rank_req: int) -> dict:
        h = self.hybrid
        if self._proj is not None and self._proj_key == key:
            return self._proj  # another thread built it while we waited
        self._proj = None  # release before the new upload
        # the full-dim mirror and the graph / tile state are dead weight in
        # this regime: free them before allocating
        h.store.release_mirror()
        self._dev = None
        self._key = None
        device = h.store.device
        data = h.store.data
        count = max(h.store.count, 1)
        dim = data.shape[1]
        n_rows = min(data.shape[0], round_up(count, self._PROJ_ROW_PAD))
        fit = self._fit
        if fit is None:
            # PCA of a <= 16K-row sample on the host; the eigenvalues pick
            # the auto rank
            stride = max(1, count // 16_384)
            mu, evals, basis = pca_basis(data[:count:stride])
            rank = rank_req
            if rank < 0:  # auto: smallest rank capturing pca_var()
                ev = np.maximum(evals, 0.0)
                total = ev.sum()
                if total <= 0:
                    rank = 32
                else:
                    cum = np.cumsum(ev) / total
                    rank = int(np.searchsorted(cum, limits.pca_var()) + 1)
                rank = int(min(max(rank, 32), 192, dim))
            rank = min(rank, dim)
        else:
            mu, basis = fit
            rank = basis.shape[1]
        mu_d = to_device(np.asarray(mu, np.float32), device)

        members_np = h.store.active_mask(data.shape[0]) & (
            h.hnsw.member_mask(data.shape[0])
            | h.ivf.member_mask(data.shape[0]))
        member_rows = np.nonzero(members_np[:count])[0]
        pinned = rank_req >= 0 and limits.pca_oversample() is not None
        if pinned or not member_rows.size:
            # restart fast path: rank and oversample pinned, no probe pass
            probe_rows = np.zeros(0, np.int64)
        else:
            sel = np.linspace(0, member_rows.size - 1,
                              min(self._PROBES, member_rows.size)) \
                .astype(np.int64)
            probe_rows = member_rows[sel]

        mode = limits.pca_rerank_mode()

        def want_device_rerank(r: int) -> bool:
            if mode == "host":
                return False
            used = n_rows * r * 2 + n_rows * 4 + n_rows
            need = n_rows * dim * 2
            head = max(1 << 30, limits.stage1_transient_bytes())
            fits = used + need + head <= limits.hbm_budget_bytes()
            return mode == "device" or (fits and count >= 2_000_000)

        rerank_x = None
        oracle_rows = None
        attempt = 0
        while True:
            if want_device_rerank(rank):
                if rerank_x is None and h.store.device_source is not None:
                    # a procedural corpus (utils/synth.py): K17 makes the
                    # mirror on the device, nothing is uploaded
                    rerank_x = h.store.device_source.mirror_bf16(n_rows)
                if rerank_x is None:
                    rerank_x = put_bf16_blocks(data, n_rows, device)
            else:
                rerank_x = None  # the auto-rank retry may outgrow the budget
            p_d = to_device(np.ascontiguousarray(basis[:, :rank], np.float32),
                            device)
            xp, xp_sq, oracle_rows = self._build_proj_mirror(
                data, n_rows, mu_d, p_d, members_np, probe_rows, oracle_rows,
                src=rerank_x)
            oversample, achieved = self._calibrate_oversample(
                xp, xp_sq, members_np[:n_rows], data, probe_rows, mu_d, p_d,
                oracle_rows)
            if (achieved >= limits.pca_target() or rank_req >= 0
                    or fit is not None or attempt >= 1 or rank >= dim):
                break
            rank = min(2 * rank, dim)  # auto-rank retry: double and rebuild
            xp = xp_sq = None
            attempt += 1
        if pinned:
            achieved = None  # not measured: the probe pass was skipped

        self._proj = {
            "mu": mu_d, "p": p_d, "xp": xp, "xp_sq": xp_sq,
            "n_rows": n_rows, "oversample": oversample,
            "achieved_recall": achieved, "rerank_x": rerank_x,
            "rank_doubled": attempt > 0,
        }
        self._proj_key = key
        return self._proj

    def _build_proj_mirror(self, data, n_rows, mu_d, p_d, members_np,
                           probe_rows, oracle_rows, src=None):
        """One pass over the corpus: project every block into the bf16
        mirror (K14's projection, in place) and, on the first pass, keep the
        probes' exact top-(_CAL_K + 1) (K8's oracle step). ``src`` (the
        resident full-dim bf16 rerank mirror) makes the pass read blocks on
        the device; without it, blocks are generated on the device when the
        store has a procedural source (K17, one generation block a step),
        else uploaded as bf16."""
        device = mu_d.device
        rank = int(p_d.shape[1])
        want_oracle = oracle_rows is None and probe_rows.size > 0
        width = self._CAL_K + 1
        if want_oracle:
            q_probe = to_device(data[probe_rows], device)
            ovals = torch.full((len(probe_rows), width), INF, device=device)
            orows = torch.full((len(probe_rows), width), -1,
                               dtype=torch.int32, device=device)
        gen = None if src is not None else self.hybrid.store.device_source
        if src is not None:
            step = max(262_144, self._PROJ_CHUNK // 4)
        elif gen is not None:
            step = gen.block_rows  # the draws are tied to its blocks
        else:
            step = self._PROJ_CHUNK
        xp = torch.empty((n_rows, rank), dtype=torch.bfloat16, device=device)
        xp_sq = torch.empty(n_rows, dtype=torch.float32, device=device)
        for lo in range(0, n_rows, step):
            hi = min(lo + step, n_rows)
            if src is not None:
                blk = src[lo:hi]
            elif gen is not None:
                blk = gen.rows(lo // step, range(0, hi - lo),
                               torch.bfloat16)[0]
            else:
                blk = put_bf16_blocks(data[lo:hi], hi - lo, device)
            project_rows(blk, mu_d, p_d, xp, xp_sq, lo)
            if want_oracle:
                m = to_device(members_np[lo:hi], device)
                ovals, orows = oracle_step(blk, m, q_probe, lo, ovals, orows,
                                           width)
            del blk
        if want_oracle:
            # exclude each probe's own row, keep _CAL_K true neighbours
            orows_np = to_host(orows)[0]
            out = np.full((len(probe_rows), self._CAL_K), -1, np.int64)
            for j, pr in enumerate(probe_rows):
                r = orows_np[j]
                r = r[(r >= 0) & (r != pr)][: self._CAL_K]
                out[j, : len(r)] = r
            oracle_rows = out
        return xp, xp_sq, oracle_rows

    def _calibrate_oversample(self, xp, xp_sq, members_slice, data,
                              probe_rows, mu_d, p_d, oracle_rows):
        """The smallest oversample whose stage-1 pool holds the probes'
        true neighbours at limits.pca_target(), measured with one wide pool
        (its prefixes give every width). Returns (oversample, recall)."""
        explicit = limits.pca_oversample()
        if probe_rows.size == 0 or oracle_rows is None:
            return (explicit or 8), 1.0
        ov_max = int(min(1024, xp.shape[0]))
        mask_dev = to_device(members_slice, xp.device)
        pools = []
        for lo in range(0, len(probe_rows), 16):
            q = to_device(data[probe_rows[lo: lo + 16]], xp.device)
            qp = project_queries(q, mu_d, p_d)
            _, pool_d = stage1_select(xp, xp_sq, mask_dev, qp, ov_max)
            pools.append(to_host(pool_d)[0])
        pool = np.concatenate(pools, axis=0)
        want = [set(int(r) for r in row if r >= 0) for row in oracle_rows]
        total = sum(len(w) for w in want) or 1

        def recall_at(width: int) -> float:
            hits = 0
            for j, w in enumerate(want):
                got = set(int(r) for r in pool[j, :width] if r >= 0)
                hits += len(w & got)
            return hits / total

        if explicit is not None:
            return explicit, recall_at(min(explicit * self._CAL_K, ov_max))
        target = limits.pca_target()
        chosen, achieved = None, 0.0
        for factor in (4, 6, 8, 12, 16, 24, 32, 48, 64, 96):
            width = min(factor * self._CAL_K, ov_max)
            r = recall_at(width)
            if r >= target or width >= ov_max:
                chosen, achieved = factor, r
                break
        if chosen is None:
            chosen, achieved = 96, recall_at(ov_max)
        return chosen, achieved

    def _release_proj(self) -> None:
        """Free the reduced-rank state when another regime serves: the
        regimes' device state never coexists."""
        self._proj = None
        self._proj_key = None
        self._members_dev = None
        self._members_key = None

    def _members_state(self, n_rows: int) -> torch.Tensor:
        """The device members mask over the mirror's n_rows rows."""
        h = self.hybrid
        key = (self._state_key(), n_rows)
        if self._members_dev is None or self._members_key != key:
            members = h.store.active_mask(n_rows) & (
                h.hnsw.member_mask(n_rows) | h.ivf.member_mask(n_rows))
            self._members_dev = to_device(members, h.store.device)
            self._members_key = key
        return self._members_dev

    def _projected_dispatch(self, queries_np: np.ndarray, k: int,
                            extra_mask: np.ndarray | None):
        """Stage 1 on the device: the top-(oversample * k) in PCA space.
        Stage 2: K2 against the full-dim bf16 mirror when it is resident,
        then (``post``, on the host) an exact f32 re-score of the survivors
        from the canonical rows; without the mirror, ``post`` re-scores the
        whole pool."""
        proj = self._proj_state()
        n_rows = proj["n_rows"]
        device = self.hybrid.store.device
        mask = self._members_state(n_rows)
        if extra_mask is not None:
            mask = mask & self._device_mask(fit_mask(extra_mask, n_rows))
        oversample = limits.pca_oversample() or proj["oversample"]
        # the pool never narrows below the calibrated width: the probe pass
        # measured the top-_CAL_K recall of exactly that prefix
        ov_k = min(bucket(max(k, self._CAL_K) * oversample),
                   int(proj["xp"].shape[0]))
        q = to_device(queries_np, device)
        qp = project_queries(q, proj["mu"], proj["p"])
        # power-of-two query chunks keep the [B, N] stage-1 transient under
        # limits.stage1_transient_bytes()
        b = int(qp.shape[0])
        b_sub = max(1, min(
            b, limits.stage1_transient_bytes() // max(n_rows * 4, 1)))
        b_sub = 1 << (b_sub.bit_length() - 1)
        budget = limits.stage1_transient_bytes()
        if b <= b_sub:
            vals_p, rows_p = stage1_select(proj["xp"], proj["xp_sq"], mask,
                                           qp, ov_k, budget)
        else:
            parts = [stage1_select(proj["xp"], proj["xp_sq"], mask,
                                   qp[lo: lo + b_sub].contiguous(), ov_k,
                                   budget)
                     for lo in range(0, b, b_sub)]
            vals_p = torch.cat([pt[0] for pt in parts])
            rows_p = torch.cat([pt[1] for pt in parts])
        if proj["rerank_x"] is not None:
            m = min(bucket(max(32, 4 * k)), int(rows_p.shape[1]))
            vals_p, rows_p = rerank_f32(proj["rerank_x"], q, rows_p, m)
        store = self.hybrid.store

        def rerank(vals_np: np.ndarray, rows_np: np.ndarray):
            """Stage 2 on the host: exact squared L2 over the candidate
            rows, selected in the norm-expansion form (cached row norms +
            one batched matmul), then the k winners re-scored in the
            difference form and ordered by it."""
            safe = np.maximum(rows_np, 0)
            cv = store.data[safe]  # [B, OV, D]
            dots = np.matmul(cv, queries_np[:, :, None])[..., 0]
            q_sq = np.einsum("bd,bd->b", queries_np, queries_np)
            d = store.host_sq()[safe] - 2.0 * dots + q_sq[:, None]
            d = np.where(rows_np >= 0, d, np.inf)
            order = np.argsort(d, axis=1, kind="stable")[:, :k]
            top_rows = np.take_along_axis(rows_np, order, axis=1)
            diff = store.data[np.maximum(top_rows, 0)] \
                - queries_np[:, None, :]  # [B, k, D]
            top_d = np.einsum("bkd,bkd->bk", diff, diff)
            top_d = np.where(top_rows >= 0, top_d, np.inf)
            order2 = np.argsort(top_d, axis=1, kind="stable")
            return (np.take_along_axis(top_d, order2, axis=1),
                    np.take_along_axis(top_rows, order2, axis=1))

        return vals_p, rows_p, rerank

    def serving_info(self) -> dict:
        """Which query plan serves right now; materializes no device
        state."""
        cap = self.hybrid.store.capacity
        if cap <= limits.effective_flat_threshold():
            regime = "flat-exact"
        elif limits.pca_serve():
            regime = "reduced-rank"
        else:
            regime = "pruned"
        info = {
            "regime": regime,
            "serving_dtype": limits.serving_dtype(),
            "capacity_rows": int(cap),
            "effective_flat_threshold": int(limits.effective_flat_threshold()),
        }
        if regime == "flat-exact":
            info["flat_select"] = limits.flat_select()
            if info["flat_select"] == "approx":
                info["flat_oversample"] = limits.flat_oversample()
        if regime == "reduced-rank":
            proj = self._proj
            if proj is not None:
                info["pca_rank"] = int(proj["p"].shape[1])
                info["pca_oversample"] = (limits.pca_oversample()
                                          or proj["oversample"])
                ar = proj["achieved_recall"]
                # None: rank and oversample were pinned, no probe pass
                info["pca_calibrated_recall"] = (
                    None if ar is None else round(float(ar), 4))
                info["pca_rerank"] = ("device" if proj["rerank_x"] is not None
                                      else "host")
                info["pca_rank_doubled"] = proj["rank_doubled"]
            else:
                r = limits.pca_rank()
                info["pca_rank"] = "auto" if r < 0 else r
                info["pca_oversample"] = limits.pca_oversample() or "auto"
        return info

    def prewarm(self, k: int = 10) -> float:
        """Build the serving regime's device state and run its launches once
        on a dummy query (and the host post-process, where the regime has
        one). Returns seconds spent."""
        t0 = time.perf_counter()
        dummy = np.zeros((1, self.hybrid.store.dim), np.float32)
        vals, rows, post = self.search_dispatch(dummy, k, ef=50, n_probe=16)
        vals, rows = to_host(vals, rows)
        if post is not None:
            post(vals, rows)
        return time.perf_counter() - t0

    def search_dispatch(self, queries: np.ndarray, k: int, ef: int,
                        n_probe: int, extra_mask: np.ndarray | None = None):
        """Launch one fused search WITHOUT the readback. Returns
        ``(sq_dists, rows, post)``: two device tensors and, in the
        reduced-rank regime, the host re-score to apply to them after the
        readback (``post(vals, rows) -> (vals, rows)``; None in the other
        regimes). CUDA launches are asynchronous, so callers can launch
        batch i+1 before reading i. The regime is chosen before any state
        is built: the reduced-rank regime never uploads the full-dim f32
        mirror."""
        queries_np = np.atleast_2d(np.asarray(queries, np.float32))
        if self.hybrid.store.capacity <= limits.effective_flat_threshold():
            self._release_proj()  # the regimes' device state never coexists
            return self._flat_dispatch(queries_np, k, extra_mask)
        if limits.pca_serve():
            return self._projected_dispatch(queries_np, k, extra_mask)
        self._release_proj()
        dev = self._device_state(pruned=True)
        extra = (dev["ones"] if extra_mask is None else self._device_mask(
            fit_mask(extra_mask, int(dev["x"].shape[0]))))
        q = to_device(queries_np, self.hybrid.store.device)
        vals, rows = hybrid_search(
            dev["x"], dev["x_sq"], dev["hnsw_mask"], dev["ivf_mask"], extra,
            dev["nbrs0"], dev["nbrs_up"], dev["up_offset"], dev["entry"],
            dev["entry_level"], dev["ivf"], q, k, ef, n_probe,
            dev["has_hnsw"], has_filter=extra_mask is not None,
            beam_expand=limits.beam_expand())
        return vals, rows, None

    def _flat_dispatch(self, queries_np: np.ndarray, k: int,
                       extra_mask: np.ndarray | None):
        """The flat regime, branch for branch as the reference's: K9 + K2
        under FVDB_FLAT_SELECT=approx; on a bf16 mirror K1 (query rounded)
        + K2, then (FVDB_BF16_REFINE, the default) the exact host re-score
        of the survivors from the f32 rows, returned as ``post``; raw K1
        on a bf16 mirror with FVDB_BF16_RERANK=0; exact K1 on the f32
        mirror."""
        dev = self._device_state()
        x, x_sq = dev["x"], dev["x_sq"]
        cap = int(x.shape[0])
        mask = dev["members"]
        if extra_mask is not None:
            mask = mask & self._device_mask(fit_mask(extra_mask, cap))
        q = to_device(queries_np, self.hybrid.store.device)
        bf16 = x.dtype == torch.bfloat16
        if limits.flat_select() == "approx" and cap > k:
            ov_k = min(bucket(max(limits.flat_oversample(), 4 * k)), cap)
            vals, rows = flat_search_approx(x, x_sq, mask, q, k, ov_k)
            return vals, rows, None
        if bf16 and limits.bf16_rerank() and cap > k:
            if limits.bf16_host_refine():
                # the device re-score is exact for the bf16-stored rows; the
                # host re-scores the survivors from the f32 rows, so the
                # scores are exact and only pool misses remain
                ov_k = min(bucket(max(8 * k, limits.bf16_oversample())), cap)
                m = min(bucket(max(32, 4 * k)), ov_k)
                vals, rows = flat_search_rerank(x, x_sq, mask, q, m, ov_k)
                store = self.hybrid.store

                def refine(vals_np: np.ndarray, rows_np: np.ndarray):
                    """Difference-form f32 distances of the m survivors
                    from the host rows; the k first, stable in pool
                    order."""
                    diff = store.data[np.maximum(rows_np, 0)] \
                        - queries_np[:, None, :]  # [B, m, D]
                    d = np.einsum("bmd,bmd->bm", diff, diff)
                    d = np.where(rows_np >= 0, d, np.inf)
                    order = np.argsort(d, axis=1, kind="stable")[:, :k]
                    return (np.take_along_axis(d, order, axis=1),
                            np.take_along_axis(rows_np, order, axis=1))

                return vals, rows, refine
            ov_k = min(bucket(max(4 * k, 64)), cap)
            vals, rows = flat_search_rerank(x, x_sq, mask, q, k, ov_k)
            return vals, rows, None
        vals, rows = l2_topk(x, x_sq, mask, q, k, round_query=bf16)
        return vals, rows, None

    def search(self, queries: np.ndarray, k: int, ef: int, n_probe: int,
               extra_mask: np.ndarray | None = None):
        """Returns (sq-dists [B, k], rows [B, k]) as numpy."""
        vals, rows, post = self.search_dispatch(queries, k, ef, n_probe,
                                                extra_mask)
        vals, rows = to_host(vals, rows)
        if post is not None:
            vals, rows = post(vals, rows)
        return vals, rows
