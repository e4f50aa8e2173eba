"""Columnar metadata index: vectorized filter evaluation over row space.

The reference evaluates filters per result after a 3x oversampled search
(reference: src/hybrid/core.rs:513-549). Pushing the filter INTO candidate
selection needs a bitmask over all rows — but computing that mask by calling
``MetadataFilter.matches`` per row is O(N) Python per query (seconds at 1M
rows). This module maintains a columnar projection of the metadata —
``field path -> typed numpy column`` — updated on mutation, so the 8-operator
filter language lowers to vectorized numpy predicates and the full-corpus
bitmask costs microseconds.

Representation per field (dot-path), all row-indexed and lazily allocated:
  - numeric column (float64) + validity mask — bools excluded, matching
    ``_json_eq``'s bool/number distinction;
  - interned string codes (int32, -1 = not-a-string);
  - bool codes (int8, -1 = not-a-bool);
  - null / presence masks;
  - multi-value inverted sets for array fields (scalar element -> row set),
    giving array-contains equality without per-row scans.

``mask()`` returns None when a predicate can't be lowered (equality against
a dict/list literal, or a field dropped by the ``max_fields`` cap) — callers
then fall back to the reference's oversample+post-filter, which is O(k), not
O(N). Everything lowerable is exact: a property test asserts equivalence
with ``MetadataFilter.matches`` row-by-row semantics.
"""
from __future__ import annotations

import numpy as np

from .metadata_filter import MetadataFilter

_NULL_KEY = ("z",)


def _elem_key(v):
    """Hash key for an array element, with JSON equality semantics
    (bool distinct from number; int == float). None for non-scalars."""
    if v is None:
        return _NULL_KEY
    if isinstance(v, bool):
        return ("b", v)
    if isinstance(v, (int, float)):
        return ("n", float(v))
    if isinstance(v, str):
        return ("s", v)
    return None


class FieldColumn:
    """Typed columnar projection of one metadata field path."""

    __slots__ = (
        "cap", "present", "null", "num", "num_valid", "scode", "interner",
        "bcode", "multi", "row_multi", "is_container",
    )

    def __init__(self, cap: int):
        self.cap = cap
        self.present = np.zeros(cap, bool)
        self.null = None  # lazily: bool[cap]
        self.num = None  # lazily: float64[cap]
        self.num_valid = None  # lazily: bool[cap]
        self.scode = None  # lazily: int32[cap], -1 = not-a-string
        self.interner: dict = {}
        self.bcode = None  # lazily: int8[cap], -1 = not-a-bool
        self.multi: dict = {}  # element key -> set of rows (array fields)
        self.row_multi: dict = {}  # row -> list of element keys
        self.is_container = None  # lazily: bool[cap] — value is dict/list

    def grow(self, cap: int) -> None:
        if cap <= self.cap:
            return
        self.present = _grow(self.present, cap)
        for name in ("null", "num", "num_valid", "scode", "bcode",
                     "is_container"):
            arr = getattr(self, name)
            if arr is not None:
                setattr(self, name, _grow(arr, cap))
        self.cap = cap

    # ------------------------------------------------------------- mutation
    def clear(self, row: int) -> None:
        if not self.present[row]:
            return
        self.present[row] = False
        for name in ("null", "num_valid", "is_container"):
            arr = getattr(self, name)
            if arr is not None:
                arr[row] = False
        if self.scode is not None:
            self.scode[row] = -1
        if self.bcode is not None:
            self.bcode[row] = -1
        for k in self.row_multi.pop(row, ()):
            rows = self.multi.get(k)
            if rows is not None:
                rows.discard(row)
                if not rows:
                    del self.multi[k]

    def set(self, row: int, value) -> None:
        self.clear(row)
        self.present[row] = True
        if value is None:
            if self.null is None:
                self.null = np.zeros(self.cap, bool)
            self.null[row] = True
        elif isinstance(value, bool):
            if self.bcode is None:
                self.bcode = np.full(self.cap, -1, np.int8)
            self.bcode[row] = int(value)
        elif isinstance(value, (int, float)):
            if self.num is None:
                self.num = np.zeros(self.cap, np.float64)
                self.num_valid = np.zeros(self.cap, bool)
            self.num[row] = float(value)
            self.num_valid[row] = True
        elif isinstance(value, str):
            if self.scode is None:
                self.scode = np.full(self.cap, -1, np.int32)
            code = self.interner.setdefault(value, len(self.interner))
            self.scode[row] = code
        elif isinstance(value, list):
            if self.is_container is None:
                self.is_container = np.zeros(self.cap, bool)
            self.is_container[row] = True
            keys = []
            for elem in value:
                k = _elem_key(elem)
                if k is not None:
                    self.multi.setdefault(k, set()).add(row)
                    keys.append(k)
            if keys:
                self.row_multi[row] = keys
        else:  # dict — reachable only via nested-object equality literals
            if self.is_container is None:
                self.is_container = np.zeros(self.cap, bool)
            self.is_container[row] = True

    # -------------------------------------------------------------- queries
    def eq_mask(self, value, n: int) -> np.ndarray:
        """Rows whose value equals ``value`` OR whose array contains it."""
        out = np.zeros(n, bool)
        if value is None:
            if self.null is not None:
                out |= self.null[:n]
        elif isinstance(value, bool):
            if self.bcode is not None:
                out |= self.bcode[:n] == int(value)
        elif isinstance(value, (int, float)):
            if self.num_valid is not None:
                out |= self.num_valid[:n] & (self.num[:n] == float(value))
        elif isinstance(value, str):
            code = self.interner.get(value)
            if code is not None and self.scode is not None:
                out |= self.scode[:n] == code
        k = _elem_key(value)
        if k is not None:
            rows = self.multi.get(k)
            if rows:
                idx = np.fromiter((r for r in rows if r < n), np.int64,
                                  count=-1)
                out[idx] = True
        return out

    def scalar_eq_mask(self, value, n: int) -> np.ndarray:
        """Rows whose value IS ``value`` (no array-contains — $in semantics,
        reference metadata_filter.rs evaluates $in against the field value
        itself, not its elements)."""
        out = np.zeros(n, bool)
        if value is None:
            if self.null is not None:
                out |= self.null[:n]
        elif isinstance(value, bool):
            if self.bcode is not None:
                out |= self.bcode[:n] == int(value)
        elif isinstance(value, (int, float)):
            if self.num_valid is not None:
                out |= self.num_valid[:n] & (self.num[:n] == float(value))
        elif isinstance(value, str):
            code = self.interner.get(value)
            if code is not None and self.scode is not None:
                out |= self.scode[:n] == code
        return out

    def range_mask(self, f: MetadataFilter, n: int) -> np.ndarray:
        if self.num_valid is None:
            return np.zeros(n, bool)
        out = self.num_valid[:n].copy()
        num = self.num[:n]
        if f.min is not None:
            out &= (num >= f.min) if f.min_inclusive else (num > f.min)
        if f.max is not None:
            out &= (num <= f.max) if f.max_inclusive else (num < f.max)
        return out

    def memory_usage_bytes(self) -> int:
        total = self.present.nbytes
        for name in ("null", "num", "num_valid", "scode", "bcode",
                     "is_container"):
            arr = getattr(self, name)
            if arr is not None:
                total += arr.nbytes
        total += 64 * (len(self.multi) + len(self.row_multi))
        return total


def _grow(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros(cap, arr.dtype)
    if arr.dtype == np.int32 or arr.dtype == np.int8:
        out.fill(-1)
    out[: arr.shape[0]] = arr
    return out


class ColumnarMetadata:
    """Row-aligned columnar metadata table + filter-to-bitmask compiler."""

    def __init__(self, capacity: int = 1024, max_fields: int = 256):
        self.capacity = max(capacity, 1)
        self.max_fields = max_fields
        self.columns: dict[str, FieldColumn] = {}
        self.untracked: set[str] = set()
        self.row_fields: dict[int, list] = {}  # row -> field paths set
        # rows with dict metadata: rows without never match ANY filter
        # (parity with compile_mask's "None rows never match", including
        # the empty-$and edge case)
        self.has_meta = np.zeros(self.capacity, bool)
        self.epoch = 0

    # ------------------------------------------------------------- mutation
    def ensure_capacity(self, cap: int) -> None:
        if cap <= self.capacity:
            return
        new_cap = 1 << (cap - 1).bit_length()
        for col in self.columns.values():
            col.grow(new_cap)
        self.has_meta = _grow(self.has_meta, new_cap)
        self.capacity = new_cap

    def _column(self, path: str) -> FieldColumn | None:
        col = self.columns.get(path)
        if col is None:
            if len(self.columns) >= self.max_fields:
                self.untracked.add(path)
                return None
            col = FieldColumn(self.capacity)
            self.columns[path] = col
        return col

    def clear_row(self, row: int) -> None:
        for path in self.row_fields.pop(row, ()):
            col = self.columns.get(path)
            if col is not None:
                col.clear(row)
        if row < self.capacity:
            self.has_meta[row] = False
        self.epoch += 1

    def set_row(self, row: int, meta) -> None:
        """Project one row's metadata dict into the columns. Non-dict or
        None metadata leaves the row absent from every column (matching
        ``compile_mask``: such rows never match field predicates)."""
        self.ensure_capacity(row + 1)
        self.clear_row(row)
        if not isinstance(meta, dict):
            return
        self.has_meta[row] = True
        flat: dict = {}
        _flatten(meta, "", flat)
        paths = []
        for path, value in flat.items():
            col = self._column(path)
            if col is not None:
                col.set(row, value)
                paths.append(path)
        if paths:
            self.row_fields[row] = paths

    def set_rows(self, rows, metas) -> None:
        for row, meta in zip(rows, metas):
            self.set_row(int(row), meta)

    # -------------------------------------------------------------- compile
    def mask(self, flt: MetadataFilter, n_rows: int) -> np.ndarray | None:
        """Filter tree -> bool mask [n_rows], or None when not lowerable
        (caller falls back to oversample + post-filter)."""
        m = self._mask(flt, n_rows)
        if m is None:
            return None
        self.ensure_capacity(n_rows)
        return m & self.has_meta[:n_rows]

    def _mask(self, f: MetadataFilter, n: int) -> np.ndarray | None:
        if f.kind == "and":
            out = np.ones(n, bool)  # empty $and matches everything
            for sub in f.value:
                m = self._mask(sub, n)
                if m is None:
                    return None
                out &= m
            return out
        if f.kind == "or":
            out = np.zeros(n, bool)  # empty $or matches nothing
            for sub in f.value:
                m = self._mask(sub, n)
                if m is None:
                    return None
                out |= m
            return out

        if f.field in self.untracked:
            return None
        col = self.columns.get(f.field)
        if col is None:
            # field never seen in any row -> no row can match
            return np.zeros(n, bool)

        if f.kind == "equals":
            if isinstance(f.value, (dict, list)):
                return None  # container-literal equality: not lowerable
            return col.eq_mask(f.value, n)
        if f.kind == "in":
            out = np.zeros(n, bool)
            for v in f.value:
                if isinstance(v, (dict, list)):
                    return None
                out |= col.scalar_eq_mask(v, n)
            return out
        if f.kind == "range":
            return col.range_mask(f, n)
        return None

    def memory_usage_bytes(self) -> int:
        return sum(c.memory_usage_bytes() for c in self.columns.values())


def _flatten(meta: dict, prefix: str, out: dict) -> None:
    for key, value in meta.items():
        if "." in key:
            # dot-notation lookup splits on '.', so a literal dotted key is
            # unreachable by any filter — don't index it
            continue
        path = f"{prefix}.{key}" if prefix else key
        out[path] = value
        if isinstance(value, dict):
            _flatten(value, path, out)
