"""Fused search, flat regime: one masked exact L2 top-k over the mirror.

The JAX package's ``index/fused.py`` for corpora up to the flat threshold
with an f32 mirror. A query batch is one upload, one launch of the fused L2
top-k kernel (K1) with the membership / soft-delete / filter mask fused into
selection, and one [B, k] readback. Engine state (mirror and member mask)
stays on the device between calls, keyed by the engines' versions.

Not ported yet, and raising ``NotImplementedError`` instead of serving some
other way: bf16 mirrors (FVDB_SERVING_DTYPE=bfloat16), approximate flat
selection (FVDB_FLAT_SELECT=approx) and stores above the flat threshold
(graph + IVF pruned search, reduced-rank search).

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
from .store import serving_mirror


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

    def _device_state(self) -> dict:
        dev, key = self._dev, self._key
        if dev is not None and key == self._state_key():
            return dev
        with self._state_lock:
            key = self._state_key()
            if self._dev is None or self._key != key:
                h = self.hybrid
                self._dev = None  # release before the new upload
                mirror = serving_mirror(h.store)
                n = int(mirror.x.shape[0])
                active = h.store.active_mask(n)
                hnsw_mask = active & h.hnsw.member_mask(n)
                # a row both engines claim mid-migration is served once
                ivf_mask = active & h.ivf.member_mask(n) & ~hnsw_mask
                self._dev = {
                    "x": mirror.x,
                    "x_sq": mirror.x_sq,
                    "members": to_device(hnsw_mask | ivf_mask,
                                         h.store.device),
                }
                self._key = key
            return self._dev

    def prewarm(self, k: int = 10) -> float:
        """Upload the device state and run the serving kernel once on a
        dummy query. Returns seconds spent."""
        t0 = time.perf_counter()
        dummy = np.zeros((1, self.hybrid.store.dim), np.float32)
        to_host(*self.search_dispatch(dummy, k, ef=50, n_probe=16)[:2])
        return time.perf_counter() - t0

    def search_dispatch(self, queries: np.ndarray, k: int, ef: int,
                        n_probe: int, extra_mask: np.ndarray | None = None):
        """Launch one fused search WITHOUT the readback. Returns
        ``(sq_dists, rows, post)``: two device tensors and ``post=None``
        (exact regimes need no host post-process). CUDA launches are
        asynchronous, so callers can launch batch i+1 before reading i."""
        if self.hybrid.store.capacity > limits.effective_flat_threshold():
            raise NotImplementedError(
                "stores above the flat threshold (pruned / reduced-rank "
                "search) are not ported yet")
        if limits.serving_dtype() != "float32":
            raise NotImplementedError(
                "FVDB_SERVING_DTYPE=bfloat16 serving (bf16 mirror + f32 "
                "rerank) is not ported yet")
        if limits.flat_select() == "approx":
            raise NotImplementedError(
                "FVDB_FLAT_SELECT=approx (approximate pool + rerank) is not "
                "ported yet")
        queries_np = np.atleast_2d(np.asarray(queries, np.float32))
        dev = self._device_state()
        mask = dev["members"]
        if extra_mask is not None:
            cap = int(dev["x"].shape[0])
            mask = mask & self._device_mask(fit_mask(extra_mask, cap))
        q = to_device(queries_np, self.hybrid.store.device)
        vals, rows = l2_topk(dev["x"], dev["x_sq"], mask, q, k)
        return vals, rows, None

    def search(self, queries: np.ndarray, k: int, ef: int, n_probe: int,
               extra_mask: np.ndarray | None = None):
        """Returns (sq-dists [B, k], rows [B, k]) as numpy."""
        vals, rows, _ = self.search_dispatch(queries, k, ef, n_probe,
                                             extra_mask)
        return to_host(vals, rows)
