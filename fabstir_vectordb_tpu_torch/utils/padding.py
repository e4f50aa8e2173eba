"""Shape/padding helpers (a copy of the JAX package's ``utils/padding.py``).

The port keeps the same capacity buckets, so a store grows through the same
row counts and the two packages hold the same arrays for the same inserts.
"""
from __future__ import annotations

import numpy as np

LANE = 128  # TPU lane width; last-dim alignment target.
SUBLANE = 8  # f32 sublane count.


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    if m <= 0:
        raise ValueError("m must be positive")
    return ((x + m - 1) // m) * m


def grow_capacity(needed: int, minimum: int = 1024) -> int:
    """Capacity bucket for ``needed`` rows: next power of two, >= minimum.

    Power-of-two buckets bound the number of distinct jit specializations to
    O(log N) over the life of an index.
    """
    cap = max(int(minimum), SUBLANE)
    while cap < needed:
        cap *= 2
    return cap


def bucket(x: int, minimum: int = 8) -> int:
    """Round ``x`` up to a power-of-two bucket (>= minimum).

    Used for jit static args (k, ef, n_probe) so distinct user-facing values
    share compiled kernels; results are sliced back host-side.
    """
    b = max(minimum, 1)
    while b < x:
        b *= 2
    return b


def pad_rows(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    """Pad the leading dim of ``arr`` with ``fill`` up to ``capacity`` rows."""
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"array rows {n} exceed capacity {capacity}")
    if n == capacity:
        return arr
    pad_shape = (capacity - n,) + arr.shape[1:]
    pad = np.full(pad_shape, fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def fit_mask(mask: np.ndarray, n: int) -> np.ndarray:
    """Crop/False-pad a boolean row mask to exactly ``n`` rows.

    Search paths snapshot the device mirror and host masks at slightly
    different instants; under a concurrent capacity grow their lengths can
    disagree (growth swaps the backing arrays). Reconciling every mask to
    the mirror's row count serves a consistent prefix snapshot — rows
    appended after the mirror upload stay invisible until the next
    version-keyed re-upload — instead of a broadcast shape error.
    """
    if mask.shape[0] == n:
        return mask
    out = np.zeros(n, bool)
    c = min(n, mask.shape[0])
    out[:c] = mask[:c]
    return out


def grow_rows(arr, new_len: int, fill=0):
    """Grow ``arr`` to ``new_len`` rows, preserving the prefix.

    np.vstack/np.concatenate-based growth copies the (lazily zeroed) tail
    through memcpy and costs seconds at production sizes on first touch;
    np.zeros + prefix copy keeps the tail as untouched COW pages (~1 ms for
    200 MB). Use for every capacity-bucket growth.
    """
    import numpy as np

    shape = (new_len,) + arr.shape[1:]
    if fill == 0:
        out = np.zeros(shape, arr.dtype)
    else:
        out = np.full(shape, fill, arr.dtype)
    out[: arr.shape[0]] = arr
    return out
