"""Carry an index's state across from the JAX package as numpy arrays.

:func:`hybrid_from_numpy` takes the arrays that define a hybrid index and
returns a port :class:`HybridIndex` that holds the same rows, graph and
quantizer, so it answers searches as the original does. The caller reads the
arrays off the source object (for a JAX ``HybridIndex`` ``h``: ``h.store.data``,
``h.store.row_to_id``, ``h.hnsw.nbrs0``, ``h.ivf.centroids`` and so on); this
module never touches one.
"""
from __future__ import annotations

import numpy as np

from .index.hybrid import HybridConfig, HybridIndex


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
    s._version += 1

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
