"""Dense row-oriented vector storage shared by all index engines.

The JAX package's ``index/store.py`` with a PyTorch device mirror. The host
arrays (data, deleted flags, timestamps, id maps, version) are the same as
there; the device mirror (x, x_sq) lives on the store's device and is
uploaded again only when the version changes.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import limits
from ..utils.device import resolve_device
from ..utils.padding import grow_capacity, grow_rows
from ..utils.transfer import to_device


class DuplicateIdError(ValueError):
    pass


class UnknownIdError(KeyError):
    pass


class DimensionMismatchError(ValueError):
    pass


@dataclass
class DeviceMirror:
    x: torch.Tensor  # [capacity, dim] f32
    x_sq: torch.Tensor  # [capacity] f32
    version: int


class VectorStore:
    """Host-canonical vector rows + device mirror.

    Row states: unallocated (row >= count), active, deleted (soft).
    ``device=None`` means the card; without one the constructor raises.
    """

    def __init__(self, dim: int, initial_capacity: int = 1024, device=None):
        if dim <= 0:
            raise DimensionMismatchError("dim must be positive")
        self.device = resolve_device(device)
        self.dim = dim
        self.capacity = grow_capacity(1, initial_capacity)
        self.count = 0  # allocated rows (including soft-deleted)
        self.data = np.zeros((self.capacity, dim), np.float32)
        self.deleted = np.zeros(self.capacity, bool)
        self.timestamps = np.zeros(self.capacity, np.float64)
        self.id_to_row: dict[str, int] = {}
        self.row_to_id: list = []
        self._version = 0
        self._mirror: DeviceMirror | None = None
        self._lock = threading.RLock()

    # ------------------------------------------------------------ mutation
    def _check_new_ids(self, ids: list) -> None:
        """Duplicate-id validation that permits re-inserting a soft-deleted
        id: the tombstoned row releases its mapping (stays deleted forever)
        and the id maps to the new row."""
        if len(set(ids)) != len(ids):
            raise DuplicateIdError("duplicate ids within batch")
        for vid in ids:
            row = self.id_to_row.get(vid)
            if row is None:
                continue
            if not self.deleted[row]:
                raise DuplicateIdError(f"duplicate vector id: {vid}")
            self.row_to_id[row] = None
            del self.id_to_row[vid]

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
            return rows

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

    def device_mirror(self, dtype: str = "float32") -> DeviceMirror:
        """Device-resident (x, x_sq); uploaded again only when the host
        data changed. Only the f32 mirror is ported: a bf16 one raises."""
        if dtype != "float32":
            raise NotImplementedError(
                f"a {dtype} device mirror is not ported yet "
                "(FVDB_SERVING_DTYPE=float32 is)")
        with self._lock:
            m = self._mirror
            if m is None or m.version != self._version:
                # free the stale mirror before allocating the new one
                self._mirror = m = None
                x = to_device(self.data, self.device)
                self._mirror = DeviceMirror(
                    x=x, x_sq=(x * x).sum(1), version=self._version)
            return self._mirror

    def memory_usage_bytes(self) -> int:
        return int(self.data.nbytes + self.deleted.nbytes
                   + self.timestamps.nbytes + 64 * len(self.id_to_row))


def serving_mirror(store: VectorStore) -> DeviceMirror:
    """The mirror in the serving dtype (FVDB_SERVING_DTYPE)."""
    return store.device_mirror(limits.serving_dtype())
