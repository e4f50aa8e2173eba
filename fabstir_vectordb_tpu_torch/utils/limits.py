"""The size thresholds and serving knobs that the port reads.

Same environment variables and defaults as the JAX package's
``utils/limits.py``, limited to what the ported slices read: the flat
threshold, the serving dtype, the flat selection, the reduced-rank switch
and the beam's expansion width.
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


def pca_serve() -> bool:
    """Reduced-rank serving above the flat threshold (FVDB_PCA_SERVE,
    default on). Off ("0"): the HNSW beam + IVF n-probe pruned path serves
    instead."""
    return os.environ.get("FVDB_PCA_SERVE", "1") != "0"


def beam_expand() -> int:
    """Beam-search candidates expanded per step (FVDB_BEAM_EXPAND, default
    4): the layer-0 beam's step loop is the pruned path's only sequential
    depth, and W candidates a step cut it ~W x for a few wasted gathers."""
    return max(1, int(os.environ.get("FVDB_BEAM_EXPAND", 4)))


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
