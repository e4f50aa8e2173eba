"""Fused search: the whole query path in one short chain of device launches.

The JAX package's ``index/fused.py`` for two regimes, picked by capacity:

- flat (up to the flat threshold, f32 mirror): one masked exact L2 top-k
  (K1) with the membership / soft-delete / filter mask fused into
  selection;
- pruned (above it, with FVDB_PCA_SERVE=0): K13 :func:`hybrid_search`,
  greedy descent (K10) and a layer-0 beam (K11) over the HNSW members, then
  the IVF n-probe scan (K12) over the IVF members, seeded with the beam's
  top-k so the two results merge inside K12's selection.

A query batch is one upload, the launches, and one [B, k] readback. Engine
state (mirror, masks, adjacency, tiles) stays on the device between calls,
keyed by the engines' versions.

Not ported yet, and raising ``NotImplementedError`` instead of serving some
other way: bf16 mirrors (FVDB_SERVING_DTYPE=bfloat16), approximate flat
selection (FVDB_FLAT_SELECT=approx) and the reduced-rank regime above the
threshold (FVDB_PCA_SERVE=1, the default).

Distances returned are squared euclidean (callers take the square root).
"""
from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import torch

from ..ops.topk import l2_topk
from ..utils import limits
from ..utils.padding import fit_mask
from ..utils.transfer import to_device, to_host
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
        return info

    def prewarm(self, k: int = 10) -> float:
        """Upload the device state and run the serving kernels once on a
        dummy query. Returns seconds spent."""
        t0 = time.perf_counter()
        dummy = np.zeros((1, self.hybrid.store.dim), np.float32)
        to_host(*self.search_dispatch(dummy, k, ef=50, n_probe=16)[:2])
        return time.perf_counter() - t0

    def search_dispatch(self, queries: np.ndarray, k: int, ef: int,
                        n_probe: int, extra_mask: np.ndarray | None = None):
        """Launch one fused search WITHOUT the readback. Returns
        ``(sq_dists, rows, post)``: two device tensors and ``post=None``
        (the ported regimes need no host post-process). CUDA launches are
        asynchronous, so callers can launch batch i+1 before reading i."""
        if limits.serving_dtype() != "float32":
            raise NotImplementedError(
                "FVDB_SERVING_DTYPE=bfloat16 serving (bf16 mirror + f32 "
                "rerank) is not ported yet")
        queries_np = np.atleast_2d(np.asarray(queries, np.float32))
        if self.hybrid.store.capacity <= limits.effective_flat_threshold():
            if limits.flat_select() == "approx":
                raise NotImplementedError(
                    "FVDB_FLAT_SELECT=approx (approximate pool + rerank) is "
                    "not ported yet")
            dev = self._device_state()
            mask = dev["members"]
            if extra_mask is not None:
                cap = int(dev["x"].shape[0])
                mask = mask & self._device_mask(fit_mask(extra_mask, cap))
            q = to_device(queries_np, self.hybrid.store.device)
            vals, rows = l2_topk(dev["x"], dev["x_sq"], mask, q, k)
            return vals, rows, None
        if limits.pca_serve():
            raise NotImplementedError(
                "reduced-rank serving above the flat threshold "
                "(FVDB_PCA_SERVE=1, the default) is not ported yet; "
                "FVDB_PCA_SERVE=0 serves the pruned regime")
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

    def search(self, queries: np.ndarray, k: int, ef: int, n_probe: int,
               extra_mask: np.ndarray | None = None):
        """Returns (sq-dists [B, k], rows [B, k]) as numpy."""
        vals, rows, _ = self.search_dispatch(queries, k, ef, n_probe,
                                             extra_mask)
        return to_host(vals, rows)
