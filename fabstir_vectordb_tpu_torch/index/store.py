"""Dense row-oriented vector storage shared by all index engines.

The JAX package's ``index/store.py`` with a PyTorch device mirror. The host
arrays (data, deleted flags, timestamps, id maps, version) are the same as
there; the device mirror (x, x_sq) lives on the store's device, in f32 or
bf16, and is uploaded again only when the version or the dtype changes.
The host row norms are keyed by a second version that only row-data changes
bump (soft deletes do not), and cover the ``count`` allocated rows only.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import limits
from ..utils.device import resolve_device
from ..utils.padding import grow_capacity, grow_rows
from ..utils.transfer import put_bf16_blocks, to_device


class DuplicateIdError(ValueError):
    pass


class UnknownIdError(KeyError):
    pass


class DimensionMismatchError(ValueError):
    pass


@dataclass
class DeviceMirror:
    x: torch.Tensor  # [capacity, dim] f32 or bf16
    x_sq: torch.Tensor  # [capacity] f32 norms of the f32 host rows
    version: int
    dtype: str = "float32"
    # recorded on the stream that wrote x and x_sq when that is not the
    # serving stream (a staged mirror): a reader's stream waits on it
    ready: torch.cuda.Event | None = None


class MirrorStager:
    """Uploads a loaded corpus's row blocks as they arrive, then installs
    them as the store's device mirror (the JAX package's MirrorStager,
    ``index/store.py:47-115``).

    On the card each ``add`` copies its block through pinned memory with
    ``non_blocking=True`` on a side stream (a bf16 mirror's block through
    ``put_bf16_blocks``), so the upload overlaps the rest of the load.
    ``install`` assembles the blocks in row order into the [capacity, dim]
    mirror on that stream, takes the norms there and records an event; the
    mirror is published with it, and every reader's stream waits on it
    (``VectorStore.device``) before its first kernel reads the
    mirror, so a search never sees a half-copied one. Blocks may arrive in
    any order; ``index`` is their position in row order. The mirror is
    bit-identical to the one ``VectorStore.device`` would upload (same dtype
    cast, same norms, zero tail)."""

    def __init__(self, dtype: str = "float32", device=None):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"mirror dtype must be float32|bfloat16, got "
                             f"{dtype}")
        self.dtype = dtype
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._slots: dict[int, torch.Tensor] = {}
        self.rows = 0

    def _on_side(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def add(self, index: int, block: np.ndarray) -> None:
        b = np.ascontiguousarray(block, np.float32)
        if b.size == 0:
            return
        with self._on_side():
            if self.dtype == "bfloat16":
                t = put_bf16_blocks(b, b.shape[0], self.device)
            else:
                t = to_device(b, self.device)
        self._slots[index] = t
        self.rows += b.shape[0]

    def install(self, store: "VectorStore") -> None:
        """Publish the staged mirror for ``store``, keyed to its current
        version: call it after every load-time mutation. Rows must have been
        staged in ``index`` order matching store rows [0, n)."""
        dt = torch.bfloat16 if self.dtype == "bfloat16" else torch.float32
        with store._lock:
            if store.torch_device != self.device:
                raise ValueError(f"staged on {self.device}, the store serves "
                                 f"on {store.torch_device}")
            x_sq_host = (store.host_sq() if self.dtype == "bfloat16"
                         else None)
            with self._on_side():
                x = torch.zeros((store.capacity, store.dim), dtype=dt,
                                device=self.device)
                pos = 0
                for i in sorted(self._slots):
                    blk = self._slots[i]
                    x[pos: pos + blk.shape[0]].copy_(blk)
                    pos += blk.shape[0]
                # the same expressions as VectorStore.device: bf16 mirrors
                # carry the f32 norms of the f32 host rows
                x_sq = (to_device(x_sq_host, self.device)
                        if x_sq_host is not None else (x * x).sum(1))
                ready = None
                if self._stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
                    # readers run on the serving stream: the allocator must
                    # not hand these blocks to the side stream until that
                    # stream's reads are done
                    serving = torch.cuda.default_stream(self.device)
                    x.record_stream(serving)
                    x_sq.record_stream(serving)
            self._slots.clear()
            store._mirror = DeviceMirror(x=x, x_sq=x_sq,
                                         version=store._version,
                                         dtype=self.dtype, ready=ready)


# rows a thread squares at a time in row_sq_norms
_NORM_CHUNK = 65_536


def row_sq_norms(data: np.ndarray, out: np.ndarray) -> np.ndarray:
    """out[i] = |data[i]|^2 in f32, np.einsum's arithmetic row by row,
    chunks of rows spread over host threads (einsum releases the GIL, and
    a row's sum does not depend on the chunk it is in)."""
    n = data.shape[0]

    def one(lo: int) -> None:
        blk = data[lo: lo + _NORM_CHUNK]
        np.einsum("nd,nd->n", blk, blk, dtype=np.float32,
                  out=out[lo: lo + blk.shape[0]])

    starts = range(0, n, _NORM_CHUNK)
    workers = min(8, os.cpu_count() or 1, len(starts))
    if workers <= 1:
        for lo in starts:
            one(lo)
    else:
        with ThreadPoolExecutor(workers) as ex:
            list(ex.map(one, starts))
    return out


class VectorStore:
    """Host-canonical vector rows + device mirror.

    Row states: unallocated (row >= count), active, deleted (soft).
    ``device=None`` means the card; without one the constructor raises.
    """

    def __init__(self, dim: int, initial_capacity: int = 1024, device=None):
        if dim <= 0:
            raise DimensionMismatchError("dim must be positive")
        self.torch_device = resolve_device(device)
        self.dim = dim
        self.capacity = grow_capacity(1, initial_capacity)
        self.count = 0  # allocated rows (including soft-deleted)
        self.data = np.zeros((self.capacity, dim), np.float32)
        self.deleted = np.zeros(self.capacity, bool)
        self.timestamps = np.zeros(self.capacity, np.float64)
        self.id_to_row: dict[str, int] = {}
        self.row_to_id: list = []
        self._version = 0
        # bumped by every change of row data (add, fill, register, vacuum,
        # bump_version), not by soft deletes: it keys the host row norms
        self._data_version = 0
        self._mirror: DeviceMirror | None = None
        self._host_sq: tuple | None = None
        self._lock = threading.RLock()
        # optional procedural corpus (utils/synth.py): the reduced-rank
        # mirror build generates its rows on the device instead of
        # uploading the host copy
        self.device_source = None

    def attach_device_source(self, source) -> None:
        """Register a source whose ``mirror_bf16(n_rows)`` makes this
        store's rows on the store's device (``None`` detaches). The caller
        checks first that it reproduces the host rows
        (``source.spot_check``): mirror builds trust it. Any later change of
        row data or row count (add, fill, register, vacuum) detaches it;
        soft deletes keep it (they live in masks, not in row data)."""
        if source is not None and source.device != self.torch_device:
            raise ValueError(f"the source makes rows on {source.device}, "
                             f"the store serves on {self.torch_device}")
        self.device_source = source

    # ------------------------------------------------------------ mutation
    def _check_new_ids(self, ids: list) -> None:
        """Duplicate-id validation that permits re-inserting a soft-deleted
        id: the tombstoned row releases its mapping (stays deleted forever)
        and the id maps to the new row. Only the ids already mapped are
        visited (a set intersection finds them); a live one raises before
        any mapping is released."""
        uniq = set(ids)
        if len(uniq) != len(ids):
            raise DuplicateIdError("duplicate ids within batch")
        if not self.id_to_row:
            return
        hits = uniq.intersection(self.id_to_row)
        if not hits:
            return
        live = {vid for vid in hits if not self.deleted[self.id_to_row[vid]]}
        if live:
            first = next(vid for vid in ids if vid in live)
            raise DuplicateIdError(f"duplicate vector id: {first}")
        for vid in hits:
            self.row_to_id[self.id_to_row.pop(vid)] = None

    def _grow_to(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = grow_capacity(needed, self.capacity)
        self.data = grow_rows(self.data, new_cap)
        self.deleted = grow_rows(self.deleted, new_cap)
        self.timestamps = grow_rows(self.timestamps, new_cap)
        self.capacity = new_cap

    def add_batch(self, ids: list, vectors: np.ndarray,
                  timestamps: np.ndarray | float | None = None) -> np.ndarray:
        """Append rows; returns their row indices. Duplicate ids are errors."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise DimensionMismatchError(
                f"expected [n, {self.dim}] vectors, got {vectors.shape}")
        if len(ids) != vectors.shape[0]:
            raise ValueError("ids/vectors length mismatch")
        with self._lock:
            self._check_new_ids(ids)
            n = vectors.shape[0]
            self._grow_to(self.count + n)
            rows = np.arange(self.count, self.count + n, dtype=np.int32)
            self.data[rows] = vectors
            if timestamps is None:
                timestamps = time.time()
            self.timestamps[rows] = timestamps
            self.deleted[rows] = False
            for vid, row in zip(ids, rows):
                self.id_to_row[vid] = int(row)
                self.row_to_id.append(vid)
            self.count += n
            self._version += 1
            self._data_version += 1
            self.device_source = None
            return rows

    def add_blocks(self, ids: list, blocks: list,
                   timestamps: np.ndarray | float | None = None) -> np.ndarray:
        """Append pre-chunked [n_i, dim] blocks, each copied straight into
        the store (no corpus-sized concatenation first)."""
        n = sum(int(b.shape[0]) for b in blocks)
        if len(ids) != n:
            raise ValueError("ids/blocks length mismatch")
        for b in blocks:
            if b.ndim != 2 or b.shape[1] != self.dim:
                raise DimensionMismatchError(
                    f"expected [n, {self.dim}] block, got {b.shape}")
        with self._lock:
            rows = self.register_rows(ids, timestamps)
            pos = int(rows[0]) if n else self.count
            for b in blocks:
                self.data[pos: pos + b.shape[0]] = np.asarray(b, np.float32)
                pos += b.shape[0]
            return rows

    def register_rows(self, ids: list,
                      timestamps: np.ndarray | float | None = None
                      ) -> np.ndarray:
        """Allocate rows and id mappings without writing vector data (they
        read as zeros until ``fill_rows``)."""
        with self._lock:
            self._check_new_ids(ids)
            n = len(ids)
            self._grow_to(self.count + n)
            rows = np.arange(self.count, self.count + n, dtype=np.int32)
            if timestamps is None:
                timestamps = time.time()
            self.timestamps[rows] = timestamps
            self.deleted[rows] = False
            self.id_to_row.update(zip(ids, rows.tolist()))
            self.row_to_id.extend(ids)
            self.count += n
            self._version += 1
            self._data_version += 1
            self.device_source = None
            return rows

    def fill_rows(self, start_row: int, block: np.ndarray,
                  bump_version: bool = False) -> None:
        """Write a contiguous [n, dim] block into registered rows. Callers
        streaming many blocks bump the version once at the end (each bump
        retires the device state)."""
        block = np.asarray(block, np.float32)
        with self._lock:
            self.data[start_row: start_row + block.shape[0]] = block
            self.device_source = None
            self._data_version += 1
            if bump_version:
                self._version += 1

    def bump_version(self) -> None:
        """Retire every cached state of the rows (after writes made straight
        into ``data``)."""
        with self._lock:
            self._version += 1
            self._data_version += 1

    def row_of(self, vid: str) -> int:
        try:
            return self.id_to_row[vid]
        except KeyError:
            raise UnknownIdError(vid) from None

    def id_of(self, row: int) -> str | None:
        if 0 <= row < self.count:
            return self.row_to_id[row]
        return None

    def get_vector(self, vid: str) -> np.ndarray:
        return self.data[self.row_of(vid)].copy()

    def mark_deleted(self, vid: str) -> bool:
        """Soft-delete. Returns False if already deleted."""
        with self._lock:
            row = self.row_of(vid)
            if self.deleted[row]:
                return False
            self.deleted[row] = True
            self._version += 1
            return True

    def is_deleted(self, vid: str) -> bool:
        return bool(self.deleted[self.row_of(vid)])

    def contains(self, vid: str) -> bool:
        return vid in self.id_to_row

    def vacuum(self) -> list:
        """Physically free soft-deleted rows (data zeroed, id mapping
        dropped; rows stay tombstoned so row indices stay stable). Returns
        the removed ids."""
        with self._lock:
            removed = []
            for row in np.nonzero(self.deleted[: self.count])[0]:
                vid = self.row_to_id[row]
                if vid is not None:
                    removed.append(vid)
                    del self.id_to_row[vid]
                    self.row_to_id[row] = None
                self.data[row] = 0.0
            self._version += 1
            self._data_version += 1
            self.device_source = None
            return removed

    # ------------------------------------------------------------- queries
    @property
    def active_count(self) -> int:
        return self.count - int(self.deleted[: self.count].sum())

    def active_mask(self, n: int | None = None) -> np.ndarray:
        """[n or capacity] bool: allocated and not deleted (a consistent
        prefix snapshot under a concurrent capacity grow)."""
        deleted = self.deleted  # local ref: growth replaces the object
        if n is None:
            n = max(self.capacity, deleted.shape[0])
        mask = np.zeros(n, bool)
        count = min(self.count, n, deleted.shape[0])
        mask[:count] = ~deleted[:count]
        return mask

    def device(self, dtype: str = "float32") -> DeviceMirror:
        """Device-resident (x, x_sq); uploaded again only when the host
        data or the dtype changed. ``dtype="bfloat16"`` keeps the rows in
        bf16 (rounded to nearest even from the f32 host rows, half the
        device memory) with x_sq the f32 norms of the f32 host rows
        (:meth:`host_sq`). One mirror is held at a time."""
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"mirror dtype must be float32|bfloat16, got "
                             f"{dtype}")
        with self._lock:
            m = self._mirror
            if m is None or m.version != self._version or m.dtype != dtype:
                # free the stale mirror before allocating the new one
                self._mirror = m = None
                if dtype == "bfloat16":
                    x = put_bf16_blocks(self.data, self.data.shape[0],
                                        self.torch_device)
                    x_sq = to_device(self.host_sq(), self.torch_device)
                else:
                    x = to_device(self.data, self.torch_device)
                    x_sq = (x * x).sum(1)
                self._mirror = DeviceMirror(x=x, x_sq=x_sq,
                                            version=self._version,
                                            dtype=dtype)
            elif m.ready is not None:
                # a staged mirror: this thread's stream waits for its copies
                torch.cuda.current_stream(self.torch_device).wait_event(
                    m.ready)
            return self._mirror

    def release_mirror(self) -> None:
        """Drop the device mirror (uploaded again on next use): the
        reduced-rank regime serves without the full-dim f32 mirror."""
        with self._lock:
            self._mirror = None

    def host_sq(self) -> np.ndarray:
        """[capacity] f32 squared norms of the host rows (0 past ``count``),
        cached by the row-data version: a soft delete keeps them (the host
        rerank of the reduced-rank regime and the bf16 mirror read them)."""
        with self._lock:
            cached = self._host_sq
            if cached is None or cached[0] != self._data_version \
                    or cached[1].shape[0] != self.data.shape[0]:
                sq = np.zeros(self.data.shape[0], np.float32)
                row_sq_norms(self.data[: self.count], sq)
                self._host_sq = cached = (self._data_version, sq)
            return cached[1]

    def memory_usage_bytes(self) -> int:
        return int(self.data.nbytes + self.deleted.nbytes
                   + self.timestamps.nbytes + 64 * len(self.id_to_row))


def serving_mirror(store: VectorStore) -> DeviceMirror:
    """The mirror in the serving dtype (FVDB_SERVING_DTYPE)."""
    return store.device(limits.serving_dtype())

