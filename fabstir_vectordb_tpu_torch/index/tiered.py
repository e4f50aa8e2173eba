"""Exact search over a host-resident corpus streamed to the device in tiles.

The JAX package's ``index/tiered.py``: when the corpus does not fit the
device as an f32 mirror, its rows stay on the host and queries stream over
fixed-size row tiles, keeping a running [B, k] top-k (values and global
rows) that each tile's top-k merges into. Soft-delete and filter masks are
per-tile slices fused into the selection, as on the resident path.

On the card a tile goes up from one of two pinned host buffers on a side
stream, ordered by events, so the copy of tile t + 1 overlaps the scan of
tile t (JAX's asynchronous ``device_put`` did the same); the step is K1 over
the tile (norms taken in the kernel, rows offset by the tile's first row)
and K8's merge into the running buffers. On the CPU every step takes the
kernels' plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.topk import l2_topk, l2_topk_plain, merge_topk, merge_topk_plain
from ..utils.device import resolve_device
from ..utils.padding import round_up
from ..utils.transfer import to_device, to_host


def tile_step_plain(x_tile, mask_tile, q, base: int, vals, rows, k: int):
    """Plain version of the tile step: the tile's exact top-min(k, tile) by
    squared L2 (rows offset by ``base``), merged into (vals, rows) [B, k].
    Returns the merged (vals, rows)."""
    tv, tr = l2_topk_plain(x_tile, None, mask_tile, q,
                           min(k, x_tile.shape[0]), row_base=base)
    return merge_topk_plain(vals, rows, tv, tr, k)


def tile_step(x_tile, mask_tile, q, base: int, vals, rows, k: int,
              out=None):
    """K8's tile step (the reference's ``_tile_step``): K1 over the f32 tile
    x_tile [n, D] under mask_tile [n] with its norms taken in the kernel and
    its rows offset by ``base``, then K8's merge of that top-min(k, n) into
    the running (vals, rows) [B, k], written to ``out`` (a pair of [B, k]
    buffers) when given. On CPU tensors both take their plain versions."""
    tv, tr = l2_topk(x_tile, None, mask_tile, q, min(k, x_tile.shape[0]),
                     row_base=base)
    return merge_topk(vals, rows, tv, tr, k, out=out)


class TieredFlatSearcher:
    """Exact search over a host-resident corpus streamed tile by tile.

    data: [N, D] float32 (numpy or a memmap). mask: [N] bool or None.
    ``hbm_budget_bytes`` bounds device residency: tiles are sized so that
    two fit (the one scanned and the one arriving). ``device=None`` means
    the card.
    """

    def __init__(self, data: np.ndarray, mask: np.ndarray | None = None,
                 hbm_budget_bytes: int = 2 << 30,
                 tile_rows: int | None = None, device=None):
        self.data = data
        self.n, self.dim = data.shape
        self.mask = np.ones(self.n, bool) if mask is None else mask
        self.device = resolve_device(device)
        if tile_rows is None:
            bytes_per_row = self.dim * 4
            tile_rows = max(1024, int(hbm_budget_bytes / 2 / bytes_per_row))
        # every tile has the same row count; the tail is zero-padded and
        # masked out
        self.tile_rows = max(1024, min(round_up(tile_rows, 1024),
                                       round_up(self.n, 1024)))
        self.n_tiles = (self.n + self.tile_rows - 1) // self.tile_rows
        self._pipe = None  # the card's pinned and device tile buffers

    def _host_tile(self, t: int, mask: np.ndarray):
        lo = t * self.tile_rows
        hi = min(lo + self.tile_rows, self.n)
        x = np.asarray(self.data[lo:hi], np.float32)
        m = mask[lo:hi]
        if hi - lo < self.tile_rows:  # pad the tail tile to the fixed shape
            pad = self.tile_rows - (hi - lo)
            x = np.concatenate([x, np.zeros((pad, self.dim), np.float32)])
            m = np.concatenate([m, np.zeros(pad, bool)])
        return x, m, lo

    def search(self, queries: np.ndarray, k: int,
               extra_mask: np.ndarray | None = None, progress=None):
        """Returns (squared distances [B, k], rows [B, k]) as numpy; exact
        over the active rows."""
        return to_host(*self.search_async(queries, k, extra_mask,
                                          progress=progress))

    def search_async(self, queries: np.ndarray, k: int,
                     extra_mask: np.ndarray | None = None, progress=None):
        """Like ``search`` but returns the device tensors without waiting
        for the device: every tile's copy and step is queued (the host
        waits only to refill a pinned buffer). Callers running several
        searchers (one a device) overlap them by reading back later.
        ``progress(t)`` is called after tile t is queued."""
        q = to_device(np.atleast_2d(np.asarray(queries, np.float32)),
                      self.device)
        b = q.shape[0]
        vals = torch.full((b, k), float("inf"), device=self.device)
        rows = torch.full((b, k), -1, dtype=torch.int32, device=self.device)
        mask = self.mask if extra_mask is None else (self.mask & extra_mask)
        if self.n == 0:
            return vals, rows
        if self.device.type != "cuda":
            for t in range(self.n_tiles):
                x, m, lo = self._host_tile(t, mask)
                vals, rows = tile_step(torch.from_numpy(x),
                                       torch.from_numpy(m), q, lo, vals,
                                       rows, k)
                if progress is not None:
                    progress(t)
            return vals, rows
        return self._stream(q, k, mask, vals, rows, progress)

    def _buffers(self):
        """Two pinned host tiles and masks, two device tiles and masks, a
        copy stream and its events, made once."""
        if self._pipe is None:
            n, d, dev = self.tile_rows, self.dim, self.device
            self._pipe = {
                "hx": [torch.empty((n, d), pin_memory=True) for _ in (0, 1)],
                "hm": [torch.empty(n, dtype=torch.bool, pin_memory=True)
                       for _ in (0, 1)],
                "dx": [torch.empty((n, d), device=dev) for _ in (0, 1)],
                "dm": [torch.empty(n, dtype=torch.bool, device=dev)
                       for _ in (0, 1)],
                "stream": torch.cuda.Stream(dev),
                "copied": [torch.cuda.Event() for _ in (0, 1)],
                "scanned": [torch.cuda.Event() for _ in (0, 1)],
                "used": [False, False],
            }
        return self._pipe

    def _stream(self, q, k: int, mask: np.ndarray, vals, rows, progress):
        p = self._buffers()
        main = torch.cuda.current_stream(self.device)
        side = p["stream"]
        # the running top-k ping-pongs between two pairs of buffers: each
        # merge writes the pair its inputs are not in
        run = [(vals, rows), (torch.empty_like(vals), torch.empty_like(rows))]
        cur = 0
        for t in range(self.n_tiles):
            s = t % 2
            lo = t * self.tile_rows
            hi = min(lo + self.tile_rows, self.n)
            if p["used"][s]:
                # the copy that last read this pinned buffer has finished
                p["copied"][s].synchronize()
            hx, hm = p["hx"][s], p["hm"][s]
            hx[: hi - lo].numpy()[:] = self.data[lo:hi]
            hm[: hi - lo].numpy()[:] = mask[lo:hi]
            if hi - lo < self.tile_rows:
                hx[hi - lo:].zero_()
                hm[hi - lo:].zero_()
            with torch.cuda.stream(side):
                if p["used"][s]:
                    # the scan that last read this device buffer is done
                    side.wait_event(p["scanned"][s])
                p["dx"][s].copy_(hx, non_blocking=True)
                p["dm"][s].copy_(hm, non_blocking=True)
                p["copied"][s].record(side)
            p["used"][s] = True
            main.wait_event(p["copied"][s])
            v, r = run[cur]
            tile_step(p["dx"][s], p["dm"][s], q, lo, v, r, k,
                      out=run[1 - cur])
            cur = 1 - cur
            p["scanned"][s].record(main)
            if progress is not None:
                progress(t)
        return run[cur]


class MultiDeviceTieredSearcher:
    """Exact search over a host corpus streamed across several devices:
    rows split evenly, each device streams its own share and keeps its own
    running top-k, and the partials merge on the host (k * devices values a
    query)."""

    def __init__(self, data: np.ndarray, mask: np.ndarray | None = None,
                 devices: list | None = None,
                 hbm_budget_bytes: int = 2 << 30,
                 tile_rows: int | None = None):
        self.devices = [resolve_device(d) for d in devices] if devices \
            else [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())]
        if not self.devices:
            raise RuntimeError("no device to search on")
        n = data.shape[0]
        bounds = np.linspace(0, n, len(self.devices) + 1).astype(np.int64)
        full_mask = np.ones(n, bool) if mask is None else mask
        self.shards = []
        for dev, lo, hi in zip(self.devices, bounds[:-1], bounds[1:]):
            if hi <= lo:
                continue
            searcher = TieredFlatSearcher(
                data[lo:hi], full_mask[lo:hi],
                hbm_budget_bytes=hbm_budget_bytes, tile_rows=tile_rows,
                device=dev)
            self.shards.append((searcher, int(lo)))

    def search(self, queries: np.ndarray, k: int):
        """Returns (squared distances [B, k], rows [B, k]) over the whole
        corpus."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        # queue every shard's stream before reading any back
        pending = [(s.search_async(q, k), base) for s, base in self.shards]
        parts = []
        for (vals_d, rows_d), base in pending:
            vals, rows = to_host(vals_d, rows_d)
            parts.append((vals, np.where(rows >= 0, rows + base, -1)))
        all_vals = np.concatenate([p[0] for p in parts], axis=1)
        all_rows = np.concatenate([p[1] for p in parts], axis=1)
        order = np.argsort(all_vals, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(all_vals, order, axis=1),
                np.take_along_axis(all_rows, order, axis=1))
