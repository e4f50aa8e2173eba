"""The size thresholds and serving knobs that the port reads.

Same environment variables and defaults as the JAX package's
``utils/limits.py``, limited to what the ported slices read: the flat
threshold, the serving dtype and the bf16 flat regime's re-score knobs, the
flat selection and its pool width, the reduced-rank regime's knobs and
budgets, the beam's expansion width and cold serving during lazy loads.
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


def pca_rank() -> int:
    """Projected dimensionality of reduced-rank serving (FVDB_PCA_RANK).
    -1 ("auto", the default): the smallest rank capturing ``pca_var()`` of
    the sample variance, clamped to [32, 192]."""
    v = os.environ.get("FVDB_PCA_RANK", "auto")
    if v == "auto":
        return -1
    return max(8, int(v))


def pca_var() -> float:
    """Variance fraction targeted by auto rank (FVDB_PCA_VAR, default 0.9)."""
    return min(0.999, max(0.5, float(os.environ.get("FVDB_PCA_VAR", 0.9))))


def pca_oversample() -> int | None:
    """Stage-1 candidates per requested k (FVDB_PCA_OVERSAMPLE). None (unset
    or "auto", the default): the mirror build calibrates it against measured
    probe recall; an explicit value is used as it is."""
    v = os.environ.get("FVDB_PCA_OVERSAMPLE")
    if v is None or v == "auto":
        return None
    return max(2, int(v))


def pca_rerank_mode() -> str:
    """Reduced-rank stage-2 placement (FVDB_PCA_RERANK): "auto" (default:
    on the device against a full-dim bf16 mirror when it fits the HBM budget
    and the corpus has >= 2M rows, else on the host), "device" or "host"."""
    v = os.environ.get("FVDB_PCA_RERANK", "auto")
    if v not in ("auto", "device", "host"):
        raise ValueError(f"FVDB_PCA_RERANK must be auto|device|host, got {v}")
    return v


def pca_target() -> float:
    """Recall@k the reduced-rank calibration targets (FVDB_PCA_TARGET,
    default 0.99)."""
    return min(1.0, max(0.5, float(os.environ.get("FVDB_PCA_TARGET", 0.99))))


def hbm_budget_bytes() -> int:
    """Serving device-memory budget (FVDB_HBM_BUDGET_GB, default 12 GiB, the
    JAX package's value for a 16 GiB chip): gates keeping a full-dim bf16
    mirror beside the reduced-rank mirror."""
    gb = float(os.environ.get("FVDB_HBM_BUDGET_GB", 12))
    return int(gb * (1 << 30))


def stage1_transient_bytes() -> int:
    """Cap on the reduced-rank stage-1 [B, N] distance transient
    (FVDB_STAGE1_TRANSIENT_GB, default 4 GiB): query batches are split into
    power-of-two sub-batches under it."""
    gb = float(os.environ.get("FVDB_STAGE1_TRANSIENT_GB", 4))
    return int(gb * (1 << 30))


def beam_expand() -> int:
    """Beam-search candidates expanded per step (FVDB_BEAM_EXPAND, default
    4): the layer-0 beam's step loop is the pruned path's only sequential
    depth, and W candidates a step cut it ~W x for a few wasted gathers."""
    return max(1, int(os.environ.get("FVDB_BEAM_EXPAND", 4)))


def cold_serve() -> bool:
    """Answer searches during a lazy load through on-demand chunk fetches
    (FVDB_COLD_SERVE, default on). Off: searches block on wait_ready()
    until the background materializer is done."""
    return os.environ.get("FVDB_COLD_SERVE", "1") != "0"


def serving_dtype() -> str:
    """Device-resident corpus dtype ("float32" | "bfloat16",
    FVDB_SERVING_DTYPE). Read per call so tests can flip it."""
    return os.environ.get("FVDB_SERVING_DTYPE", "float32")


def bf16_rerank() -> bool:
    """f32 re-scoring of bf16 flat-scan candidates (FVDB_BF16_RERANK,
    default on): the bf16 flat regime takes a wider pool from the bf16
    scan and re-scores it on the device in the f32 difference form, exact
    with respect to the bf16-stored rows."""
    return os.environ.get("FVDB_BF16_RERANK", "1") != "0"


def bf16_host_refine() -> bool:
    """Exact host refine of the bf16 flat regime's device-cut survivors
    (FVDB_BF16_REFINE, default on; only read when bf16_rerank is on): the
    survivors are re-scored from the f32 host rows, so the scores are
    exact and only pool misses remain."""
    return os.environ.get("FVDB_BF16_REFINE", "1") != "0"


def bf16_oversample() -> int:
    """Pool width floor of the bf16 flat refine (FVDB_BF16_OVERSAMPLE,
    default 128, at least 32): the pool is bucket(max(8 k, this)), capped
    at the mirror's rows."""
    return max(32, int(os.environ.get("FVDB_BF16_OVERSAMPLE", 128)))


def flat_select() -> str:
    """Flat-regime selection ("exact" | "approx", FVDB_FLAT_SELECT). approx:
    a binned approximate pool (K9) re-scored exactly in f32 (K2)."""
    v = os.environ.get("FVDB_FLAT_SELECT", "exact")
    if v not in ("exact", "approx"):
        raise ValueError(f"FVDB_FLAT_SELECT must be exact|approx, got {v}")
    return v


def flat_oversample() -> int:
    """Approximate flat selection's pool width (FVDB_FLAT_OVERSAMPLE,
    default 128, at least 16); dispatch widens it to at least 4 k."""
    return max(16, int(os.environ.get("FVDB_FLAT_OVERSAMPLE", 128)))
