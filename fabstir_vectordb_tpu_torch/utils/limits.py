"""The size thresholds and serving knobs that the port reads.

Same environment variables and defaults as the JAX package's
``utils/limits.py``, limited to what the flat-regime slice reads: the flat
threshold, the serving dtype and the flat selection.
"""
from __future__ import annotations

import os

FLAT_THRESHOLD = int(os.environ.get("FVDB_FLAT_THRESHOLD", 4_194_304))


def effective_flat_threshold(dtype: str | None = None) -> int:
    """FLAT_THRESHOLD adjusted for the resident dtype (bf16 rows are half
    the bytes, so the flat plan covers twice the rows). An explicit
    FVDB_FLAT_THRESHOLD is taken as already adjusted."""
    if "FVDB_FLAT_THRESHOLD" in os.environ:
        return FLAT_THRESHOLD
    dtype = dtype or serving_dtype()
    return FLAT_THRESHOLD * (2 if dtype == "bfloat16" else 1)


def serving_dtype() -> str:
    """Device-resident corpus dtype ("float32" | "bfloat16",
    FVDB_SERVING_DTYPE). Read per call so tests can flip it."""
    return os.environ.get("FVDB_SERVING_DTYPE", "float32")


def flat_select() -> str:
    """Flat-regime selection ("exact" | "approx", FVDB_FLAT_SELECT)."""
    v = os.environ.get("FVDB_FLAT_SELECT", "exact")
    if v not in ("exact", "approx"):
        raise ValueError(f"FVDB_FLAT_SELECT must be exact|approx, got {v}")
    return v
