"""Carry an index's state across from the JAX package as numpy arrays.

:func:`hybrid_from_numpy` takes the arrays that define a hybrid index and
returns a port :class:`HybridIndex` that holds the same rows, graph and
quantizer, so it answers searches as the original does. The caller reads the
arrays off the source object (for a JAX ``HybridIndex`` ``h``: ``h.store.data``,
``h.store.row_to_id``, ``h.hnsw.nbrs0``, ``h.ivf.centroids`` and so on); this
module never touches one. :func:`install_projection` carries the
reduced-rank regime's projection across the same way (the JAX searcher's
``h.fused._proj["mu"]`` and ``["p"]`` as numpy), and
:func:`pq_codebook_from_numpy` a PQ codebook (a JAX ``PQCodebook``'s
``centroids`` and ``dim``).
"""
from __future__ import annotations

import numpy as np
import torch

from .index.hybrid import HybridConfig, HybridIndex
from .ops.quantization import PQCodebook
from .utils.device import resolve_device


def hybrid_from_numpy(state: dict, device=None,
                      config: HybridConfig | None = None) -> HybridIndex:
    """Build a port HybridIndex from ``state``:

    - ``store``: ``data`` [capacity, D] f32, ``ids`` (the row -> id list,
      None for vacuumed rows, one entry per allocated row), ``timestamps``
      and ``deleted`` [capacity];
    - ``hnsw``: ``levels``, ``nbrs0``, ``nbrs_up``, ``up_offset``,
      ``entry_point``, ``max_level`` (and ``up_count``, else derived);
    - ``ivf``: ``centroids`` ([C, D] or None) and ``assignments``.
    """
    st, hn, iv = state["store"], state["hnsw"], state["ivf"]
    data = np.array(st["data"], np.float32)
    cap, dim = data.shape
    ids = list(st["ids"])
    idx = HybridIndex(dim, config, device=device)

    s = idx.store
    s.capacity = cap
    s.data = data
    s.deleted = np.array(st["deleted"], bool)
    s.timestamps = np.array(st["timestamps"], np.float64)
    s.count = len(ids)
    s.row_to_id = ids
    s.id_to_row = {vid: r for r, vid in enumerate(ids) if vid is not None}
    s.bump_version()

    g = idx.hnsw
    g.levels = np.array(hn["levels"], np.int16)
    g.nbrs0 = np.array(hn["nbrs0"], np.int32)
    g.nbrs_up = np.array(hn["nbrs_up"], np.int32)
    g.up_offset = np.array(hn["up_offset"], np.int32)
    g.up_cap = g.nbrs_up.shape[0]
    if "up_count" in hn:
        g.up_count = int(hn["up_count"])
    else:
        up = (g.levels > 0) & (g.up_offset >= 0)
        ends = g.up_offset[up].astype(np.int64) + g.levels[up]
        g.up_count = int(ends.max()) if ends.size else 0
    g.entry_point = int(hn["entry_point"])
    g.max_level = int(hn["max_level"])
    g._version += 1

    v = idx.ivf
    v.assignments = np.array(iv["assignments"], np.int32)
    if iv.get("centroids") is not None:
        v.centroids = np.array(iv["centroids"], np.float32)
        v.trained = True
    v._version += 1
    return idx


def install_projection(idx: HybridIndex, proj: dict) -> None:
    """Serve ``idx``'s reduced-rank regime with the projection in ``proj``:
    ``mu`` [D] and ``p`` [D, r] (numpy), used instead of the port's own
    PCA fit, so both packages project onto one basis (an eigensolver may
    flip or rotate near-tied columns). The rank is p's width; the port
    calibrates the oversample on that basis, or a pinned restart pins it
    with FVDB_PCA_OVERSAMPLE."""
    idx.fused.install_fit(np.asarray(proj["mu"], np.float32),
                          np.asarray(proj["p"], np.float32))


def pq_codebook_from_numpy(centroids, dim: int, device=None) -> PQCodebook:
    """A port :class:`PQCodebook` holding ``centroids`` [M, K, Ds] (numpy,
    as f32) on ``device`` (None: the card), so both packages encode and
    scan with one codebook."""
    cents = np.asarray(centroids, np.float32)
    if cents.ndim != 3 or cents.shape[0] * cents.shape[2] != dim:
        raise ValueError(f"centroids {cents.shape} do not cover dim {dim}")
    return PQCodebook(torch.from_numpy(cents.copy()).to(
        resolve_device(device)), int(dim))
