"""Multi-shard search and training over a shard mesh (K15).

The JAX package's ``parallel/sharded.py``: inverted lists and the flat
corpus shard over a mesh axis, queries may shard over a second axis, and
each search ends in the collective top-k merge, an all_gather of every
shard's partial top-k and one top-k over them. There every function is a
``jax.jit`` over ``jax.shard_map`` and XLA inserts the collectives; here a
shard body runs for each shard this process holds (:mod:`.mesh`), the
mesh's ``all_gather`` / ``all_reduce_sum`` carry the results between
shards, and the device work is the port's CUDA kernels:

  - ``sharded_flat_search``: each shard K1 over its rows (or K9's pool and
    K2's exact re-score), then the shard merge (csrc/shard_merge.cu), which
    rebases each shard's rows to global ones;
  - ``sharded_projected_search``: K14's query projection, then the flat
    search over the bf16 projected rows with the query rounded;
  - ``sharded_ivf_search``: K1 over the replicated centroids ranks the
    probes, each shard scans the probed lists it owns (K12 with a list
    range) over its packed rows, and the merge maps the packed positions
    to global rows;
  - ``sharded_lloyd_step`` / ``sharded_kmeans_train``: K6 in two halves,
    the partial sums on each shard, their all_reduce, then the update;
  - ``sharded_hnsw_search``: the graph replicated, the query batch
    sharded: K10 and K11 on each shard's queries;
  - ``sharded_hybrid_search``: the last two, merged on the host.

The IVF layout differs from the reference's: it pads every list to the
longest (``[C_pad, L_pad, D]`` f32 list vectors, 25.8 GB at bench.py's 1M
tier where 94% is padding), while a shard here holds only its lists' rows,
packed, with their norms, validity and global rows; the same answers come
from about 1/18 of the bytes. The padded blobs exist only on the host, in
the save format (:mod:`.persistence`).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..index.fused import project_queries, rerank_f32
from ..index.hnsw import beam_search, greedy_descent
from ..index.ivf import IVFLists, ivf_scan
from ..index.store import serving_mirror
from ..ops.distance import squared_norms
from ..ops.kmeans import kmeans_scalable_init, lloyd_finish, lloyd_partial
from ..ops.topk import approx_topk, l2_topk, shard_merge
from ..utils import limits
from ..utils.padding import round_up
from ..utils.transfer import to_device

# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _on(mesh, a, dtype=None) -> torch.Tensor:
    """``a`` (numpy or a tensor) as a tensor on the mesh's device."""
    t = a.to(mesh.device) if isinstance(a, torch.Tensor) \
        else to_device(np.asarray(a), mesh.device)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.contiguous()


def _bases(mesh, n_local: int, axis: str) -> torch.Tensor:
    """Each shard's first global row: the flat merge's row bases."""
    return torch.arange(mesh.shape[axis], dtype=torch.int32,
                        device=mesh.device) * int(n_local)


def _query_parts(mesh, q, query_axis) -> list:
    """The slice of q of each query shard this process runs; all of q
    without a query axis."""
    if query_axis is None:
        return [q]
    sl = mesh.shard_slices(q.shape[0], query_axis)
    return [q[sl[i]] for i in mesh.shards(query_axis)]


def _join_queries(mesh, outs: list, query_axis):
    """Each query shard's (vals, rows) back into the whole batch, on every
    shard (the replicated result of the reference's np.asarray)."""
    if query_axis is None:
        return outs[0]
    vals = mesh.all_gather([o[0] for o in outs], query_axis)
    rows = mesh.all_gather([o[1] for o in outs], query_axis)
    return (vals.reshape(-1, vals.shape[-1]),
            rows.reshape(-1, rows.shape[-1]))


# --------------------------------------------------------------------------
# Flat (exact) sharded search
# --------------------------------------------------------------------------


def _flat_body(x, x_sq, mask, q, k: int, select: str, oversample: int,
               round_query: bool):
    """One shard's partial top-min(k, n_local) with shard-local rows."""
    n_local = x.shape[0]
    kk = min(k, n_local)
    if select == "approx" and n_local > k:
        ov = min(max(oversample, 4 * k), n_local)
        _, cand = approx_topk(x, x_sq, mask, q, ov, round_query=round_query)
        # exact f32 re-score of the local pool (difference form)
        return rerank_f32(x, q, cand, kk)
    return l2_topk(x, x_sq, mask, q, kk, round_query=round_query)


def _flat_run(mesh, axis, query_axis, x, x_sq, mask, q, k: int,
              select: str = "exact", oversample: int = 128,
              round_query: bool = False):
    n = x.shape[0]
    rsl = mesh.shard_slices(n, axis)
    bases = _bases(mesh, n // mesh.shape[axis], axis)
    outs = []
    for qq in _query_parts(mesh, q, query_axis):
        parts = [_flat_body(x[rsl[s]], x_sq[rsl[s]], mask[rsl[s]], qq, k,
                            select, oversample, round_query)
                 for s in mesh.shards(axis)]
        vals = mesh.all_gather([p[0] for p in parts], axis)  # [S, B, kk]
        rows = mesh.all_gather([p[1] for p in parts], axis)
        outs.append(shard_merge(vals, rows, k, base=bases))
    return _join_queries(mesh, outs, query_axis)


def sharded_flat_search(mesh, axis: str = "data", select: str = "exact",
                        oversample: int = 128, query_axis: str | None = None):
    """Builds an exact search over a row-sharded corpus.

    Returns fn(x [N, D] f32 or bf16, x_sq [N], mask [N], q [B, D], k) ->
    (dists [B, k], rows [B, k]) squared distances, sorted by (distance,
    row), padded with (+inf, -1), on every shard. N must divide evenly by
    the axis size (pad with mask=False rows). Arguments may be numpy
    arrays or tensors; they move to the mesh's device.

    ``select="approx"``: each shard picks an ``oversample``-wide pool of
    its rows (max(oversample, 4k), at most its rows) through K9 and
    re-scores the pool exactly in f32 (K2) before the merge, as the
    reference's turbo flat mode.

    ``query_axis`` (2D mesh) also shards the query batch (B divisible by
    its size); the gather runs only over the row axis.
    """
    if select not in ("exact", "approx"):
        raise ValueError(f"select must be exact|approx, got {select}")

    def run(x, x_sq, mask, q, k: int):
        x = _on(mesh, x)
        return _flat_run(mesh, axis, query_axis, x, _on(mesh, x_sq,
                                                        torch.float32),
                         _on(mesh, mask, torch.bool),
                         _on(mesh, q, torch.float32), k, select, oversample)

    return run


def sharded_projected_search(mesh, axis: str = "data"):
    """Row-sharded reduced-rank stage 1 (the multi-shard twin of the
    reduced-rank regime's, index/fused.py).

    Returns fn(xp [N, rank] bf16, xp_sq [N], mask [N], mu [D], p [D, rank],
    q [B, D], ov_k) -> (approx squared distances, rows) [B, ov_k]: the
    stage-1 candidates. The queries project through K14's query kernel
    and round to the rows' dtype, as the reference's
    ``((q - mu) @ p).astype(xp.dtype)``; each shard scans its rows with K1
    (bf16 rows, the rounded query); the merge gives the global ov_k. The
    caller re-scores the candidates against the full-precision corpus.
    """

    def run(xp, xp_sq, mask, mu, p, q, ov_k: int):
        xp = _on(mesh, xp)
        qp = project_queries(_on(mesh, q, torch.float32),
                             _on(mesh, mu, torch.float32),
                             _on(mesh, p, torch.float32))
        bf16 = xp.dtype == torch.bfloat16
        if bf16:
            qp = qp.to(torch.bfloat16).float()
        return _flat_run(mesh, axis, None, xp, _on(mesh, xp_sq, torch.float32),
                         _on(mesh, mask, torch.bool), qp, ov_k,
                         round_query=bf16)

    return run


# --------------------------------------------------------------------------
# Sharded IVF
# --------------------------------------------------------------------------


@dataclass
class IVFShard:
    """One shard's lists c_lo .. c_lo + c_local - 1, packed: x [n_s, D] f32
    the list rows (list by list, each list's in its tile order), x_sq [n_s]
    their norms, valid [n_s] bool (a row that is active), rows [n_s] int32
    their global rows, ``lists.tiles`` [c_local, L_s] their positions in x
    (-1 padded). ``slots`` (host) is each row's position in its padded list
    of the save format."""

    c_lo: int
    c_local: int
    x: torch.Tensor
    x_sq: torch.Tensor
    valid: torch.Tensor
    rows: torch.Tensor
    lists: IVFLists
    slots: np.ndarray

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.x, self.x_sq, self.valid, self.rows, self.lists.tiles,
            self.lists.list_len))


@dataclass
class ShardedIVFState:
    """The cluster-sharded IVF layout. centroids [C_pad, D] replicated
    (padding clusters at 1e30, which rank last); ``shards`` the packed
    lists of each shard this process holds; ``row_map`` / ``map_base``
    their global rows concatenated and each shard's offset there (the
    merge's row map on a LocalMesh); ``l_pad`` and ``pad_row`` what the
    padded save format needs (its list length, and the vector its padding
    slots hold)."""

    centroids: torch.Tensor
    c_sq: torch.Tensor
    shards: dict
    n_clusters: int  # real (unpadded) cluster count
    l_pad: int
    pad_row: np.ndarray
    mesh: object
    axis: str
    row_map: torch.Tensor = field(repr=False)
    map_base: torch.Tensor = field(repr=False)

    @property
    def c_pad(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def nbytes(self) -> int:
        """Device bytes of the state on this process."""
        return (sum(s.nbytes for s in self.shards.values())
                + self.centroids.numel() * 4 + self.c_sq.numel() * 4
                + self.row_map.numel() * 4)


def _pack_shard(device, c_lo: int, c_local: int, cl: np.ndarray,
                slots: np.ndarray, rows: np.ndarray, vecs: np.ndarray,
                valid: np.ndarray) -> IVFShard:
    """A shard's packed lists from its entries in list order: cl the local
    list of each (ascending), slots their positions in the padded lists,
    rows their global rows, vecs [n_s, D] f32, valid bool."""
    lens = np.bincount(cl, minlength=c_local).astype(np.int64)
    starts = np.zeros(c_local + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    l_s = max(int(lens.max(initial=0)), 1)
    tiles = np.full((c_local, l_s), -1, np.int32)
    pos = np.arange(cl.size, dtype=np.int64)
    tiles[cl, pos - starts[cl]] = pos
    x = to_device(np.ascontiguousarray(vecs, np.float32), device)
    lists = IVFLists(
        centroids=None, c_sq=None, tiles=to_device(tiles, device),
        list_len=to_device(lens.astype(np.int32), device),
        longest=np.cumsum(np.sort(lens)[::-1]))
    return IVFShard(c_lo, c_local, x, squared_norms(x),
                    to_device(valid.astype(bool), device),
                    to_device(rows.astype(np.int32), device), lists,
                    slots.astype(np.int32))


def _ivf_state(mesh, axis, centroids, n_clusters, l_pad, pad_row,
               shards: dict) -> ShardedIVFState:
    c_pad = round_up(n_clusters, mesh.shape[axis])
    d = centroids.shape[1]
    cents = np.full((c_pad, d), 1e30, np.float32)
    cents[:n_clusters] = centroids[:n_clusters]
    cents_d = to_device(cents, mesh.device)
    order = sorted(shards)
    row_map = torch.cat([shards[s].rows for s in order]) if order \
        else torch.zeros(0, dtype=torch.int32, device=mesh.device)
    offs = np.zeros(mesh.shape[axis], np.int32)
    at = 0
    for s in order:
        offs[s] = at
        at += shards[s].rows.shape[0]
    return ShardedIVFState(
        centroids=cents_d, c_sq=squared_norms(cents_d), shards=shards,
        n_clusters=int(n_clusters), l_pad=int(l_pad),
        pad_row=np.asarray(pad_row, np.float32), mesh=mesh, axis=axis,
        row_map=row_map.contiguous(), map_base=to_device(offs, mesh.device))


def shard_ivf_state(mesh, centroids: np.ndarray, tiles: np.ndarray,
                    data: np.ndarray, active_mask: np.ndarray,
                    axis: str = "data") -> ShardedIVFState:
    """Build the sharded lists from host IVF state, for the shards this
    process holds: tiles [C, L_pad] row ids (-1 padded) as
    IVFIndex.tiles() gives them; data [cap, D] host rows; active_mask
    [cap] bool. A tile entry's row is valid when it is active (the
    reference's ``list_valid``)."""
    centroids = np.asarray(centroids, np.float32)
    tiles = np.asarray(tiles)
    c, l_pad = tiles.shape
    c_local = round_up(c, mesh.shape[axis]) // mesh.shape[axis]
    shards = {}
    for s in mesh.shards(axis):
        lo = s * c_local
        blk = tiles[lo: min(lo + c_local, c)]
        cl, slot = np.nonzero(blk >= 0)
        rows = blk[cl, slot].astype(np.int64)
        shards[s] = _pack_shard(mesh.device, lo, c_local, cl, slot, rows,
                                data[rows], active_mask[rows])
    return _ivf_state(mesh, axis, centroids, c, l_pad, data[0], shards)


def _ivf_probes(state: ShardedIVFState, q, n_probe: int):
    """The probed lists of each query: K1 over the replicated centroids
    (the padding ones at 1e30 have no finite distance and come out as -1
    past the real ones)."""
    _, probe = l2_topk(state.centroids, state.c_sq, None, q, n_probe)
    return probe


def _ivf_run(mesh, axis, state: ShardedIVFState, q, k: int, n_probe: int,
             query_axis):
    outs = []
    for qq in _query_parts(mesh, q, query_axis):
        probe = _ivf_probes(state, qq, n_probe)
        parts = []
        for s in mesh.shards(axis):
            sh = state.shards[s]
            v, r = ivf_scan(sh.x, sh.x_sq, sh.valid, sh.lists, probe, qq, k,
                            c_lo=sh.c_lo)
            if not mesh.is_local:
                # the shard's packed positions to global rows before the
                # gather: no other rank holds this shard's row map
                v, r = shard_merge(v[None], r[None], k, row_map=sh.rows)
            parts.append((v, r))
        vals = mesh.all_gather([p[0] for p in parts], axis)
        rows = mesh.all_gather([p[1] for p in parts], axis)
        if mesh.is_local:
            outs.append(shard_merge(vals, rows, k, base=state.map_base,
                                    row_map=state.row_map))
        else:
            outs.append(shard_merge(vals, rows, k))
    return _join_queries(mesh, outs, query_axis)


def sharded_ivf_search(mesh, axis: str = "data",
                       query_axis: str | None = None):
    """Builds an n-probe search over cluster-sharded inverted lists.

    Returns fn(state, q [B, D], k, n_probe) -> (dists [B, k], rows [B, k])
    squared distances by (distance, row), (+inf, -1) padded. With
    ``query_axis`` (2D mesh) the batch is also data-parallel (B divisible
    by its size); every shard gets the whole result back."""

    def run(state: ShardedIVFState, q, k: int, n_probe: int):
        if state.c_pad % mesh.shape[axis] or not set(
                mesh.shards(axis)) <= set(state.shards) \
                or state.centroids.device != mesh.device:
            raise ValueError("the IVF state was sharded over another mesh")
        return _ivf_run(mesh, axis, state, _on(mesh, q, torch.float32), k,
                        n_probe, query_axis)

    return run


# --------------------------------------------------------------------------
# Sharded k-means (the "training step")
# --------------------------------------------------------------------------


def sharded_lloyd_step(mesh, axis: str = "data"):
    """Builds a data-parallel Lloyd iteration.

    Returns fn(x [N, D], mask [N], centroids [C, D]) -> (new_centroids
    [C, D], mean squared error, a 0-dim tensor): each shard's partial sums,
    counts and error (K6's first half), their all_reduce, then the update
    (its second half). N must divide by the axis size."""

    def run(x, mask, centroids):
        x = _on(mesh, x, torch.float32)
        mask = _on(mesh, mask, torch.bool)
        cents = _on(mesh, centroids, torch.float32)
        sl = mesh.shard_slices(x.shape[0], axis)
        parts = [lloyd_partial(x[sl[s]], mask[sl[s]], cents)
                 for s in mesh.shards(axis)]
        sums, counts, stats = (mesh.all_reduce_sum([p[i] for p in parts],
                                                   axis) for i in range(3))
        return lloyd_finish(sums, counts, stats, cents)

    return run


def _pad_rows(mesh, x, mask, axis):
    """x and mask padded to a multiple of the axis size with masked-out
    zero rows, on the mesh's device."""
    n = x.shape[0]
    n_pad = round_up(n, mesh.shape[axis])
    x = _on(mesh, x, torch.float32)
    mask = _on(mesh, mask, torch.bool)
    if n_pad > n:
        x = torch.cat([x, x.new_zeros((n_pad - n, x.shape[1]))])
        mask = torch.cat([mask, mask.new_zeros(n_pad - n)])
    return x, mask


def sharded_lloyd_until(mesh, x, mask, init, max_iterations: int = 25,
                        tol: float = 1e-4, axis: str = "data"):
    """Data-parallel Lloyd from ``init`` [C, D] until ``max_iterations``
    or, past the first iteration, a relative error change below ``tol``
    (the reference trainer's loop). Returns (centroids, info)."""
    xd, md = _pad_rows(mesh, x, mask, axis)
    cents = _on(mesh, init, torch.float32)
    step = sharded_lloyd_step(mesh, axis)
    last_err = float("inf")
    iterations = 0
    converged = False
    err = 0.0
    for i in range(max_iterations):
        cents, err_t = step(xd, md, cents)
        err = float(err_t)
        iterations = i + 1
        if i > 0 and abs(last_err - err) / max(last_err, 1e-30) < tol:
            converged = True
            break
        last_err = err
    return cents, {"iterations": iterations, "converged": converged,
                   "final_error": float(err)}


def sharded_kmeans_train(mesh, x, mask, n_clusters: int,
                         max_iterations: int = 25, tol: float = 1e-4,
                         seed: int = 42, axis: str = "data"):
    """Multi-shard k-means: kmeans|| seeding (K7) on one device from the
    first max(40 C, C) masked rows, then data-parallel Lloyd over the mesh.
    Returns (centroids as numpy [C, D], info). The seeding draws from a
    ``torch.Generator`` seeded with ``seed``, so its centroids differ from
    the reference's ``jax.random`` ones."""
    mask_np = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor)
                         else mask, bool)
    sample_idx = np.nonzero(mask_np)[0][: max(n_clusters * 40, n_clusters)]
    xs = _on(mesh, x[sample_idx] if isinstance(x, np.ndarray)
             else x[torch.from_numpy(sample_idx).to(x.device)], torch.float32)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(seed)
    init = kmeans_scalable_init(
        gen, xs, torch.ones(xs.shape[0], dtype=torch.bool,
                            device=mesh.device), n_clusters)
    cents, info = sharded_lloyd_until(mesh, x, mask_np, init,
                                      max_iterations, tol, axis)
    return cents.cpu().numpy(), info


# --------------------------------------------------------------------------
# Sharded HNSW (query-data-parallel serving)
# --------------------------------------------------------------------------


@dataclass
class ShardedHNSWState:
    """Graph and vectors replicated (one copy on a LocalMesh's device):
    HNSW traversal is pointer-chasing over the whole graph, so the graph
    replicates and the QUERY batch shards."""

    x: torch.Tensor
    x_sq: torch.Tensor
    mask: torch.Tensor
    nbrs0: torch.Tensor
    nbrs_up: torch.Tensor
    up_offset: torch.Tensor
    entry: int
    entry_level: int


def shard_hnsw_state(mesh, hnsw) -> ShardedHNSWState:
    """An HNSWIndex's serving mirror, member mask and adjacency on the
    mesh's device."""
    mirror = serving_mirror(hnsw.store)
    dev = hnsw._device_arrays()
    mask = hnsw._search_mask(n=int(mirror.x.shape[0]))
    put = lambda t: t.to(mesh.device)  # noqa: E731
    return ShardedHNSWState(
        x=put(mirror.x), x_sq=put(mirror.x_sq),
        mask=to_device(mask, mesh.device), nbrs0=put(dev["nbrs0"]),
        nbrs_up=put(dev["nbrs_up"]), up_offset=put(dev["up_offset"]),
        entry=int(hnsw.entry_point), entry_level=max(int(hnsw.max_level), 0))


def sharded_hnsw_search(mesh, axis: str = "data"):
    """Builds a query-sharded HNSW search.

    Returns fn(state, q [B, D] (B divisible by the axis size), k, ef) ->
    (dists [B, k], rows [B, k]) squared distances, on every shard. Each
    shard runs the greedy descent (K10) and the layer-0 beam (K11,
    ``max_iters = ef + 32``, ``expand = limits.beam_expand()``) on its
    slice of the batch; the gather of the batch is the only collective."""

    def run(state: ShardedHNSWState, q, k: int, ef: int):
        q = _on(mesh, q, torch.float32)
        sl = mesh.shard_slices(q.shape[0], axis)
        parts = []
        for s in mesh.shards(axis):
            qq = q[sl[s]]
            b = qq.shape[0]
            stop = torch.zeros(b, dtype=torch.int32, device=mesh.device)
            cur, _ = greedy_descent(state.x, state.x_sq, state.mask,
                                    state.nbrs_up, state.up_offset, qq,
                                    state.entry, state.entry_level, stop)
            pool_d, pool_id = beam_search(
                state.x, state.x_sq, state.mask, state.nbrs0, state.nbrs_up,
                state.up_offset, qq, cur[:, None].contiguous(),
                torch.ones(b, dtype=torch.bool, device=mesh.device), layer=0,
                ef=ef, max_iters=ef + 32, expand=limits.beam_expand())
            parts.append((pool_d[:, :k].contiguous(),
                          pool_id[:, :k].contiguous()))
        vals = mesh.all_gather([p[0] for p in parts], axis)
        rows = mesh.all_gather([p[1] for p in parts], axis)
        return (vals.reshape(-1, vals.shape[-1]),
                rows.reshape(-1, rows.shape[-1]))

    return run


# --------------------------------------------------------------------------
# Sharded hybrid search (both engines over the mesh)
# --------------------------------------------------------------------------


def sharded_hybrid_search(mesh, axis: str = "data"):
    """The multi-shard hybrid query path: the query-sharded HNSW beam over
    the replicated recent-tier graph AND the list-sharded IVF scan over the
    historical tier, merged into one top-k on the host (numpy, as the
    reference). Rows share the VectorStore's row space.

    Returns fn(hstate, istate, q [B, D] (B divisible by the axis size), k,
    ef, n_probe) -> (dists, rows) numpy, squared distances."""
    hs = sharded_hnsw_search(mesh, axis)
    ivs = sharded_ivf_search(mesh, axis)

    def run(hstate, istate, q, k: int, ef: int, n_probe: int):
        hd, hr = hs(hstate, q, k, ef)
        ivd, ivr = ivs(istate, q, k, n_probe)
        hd, hr, ivd, ivr = (t.cpu().numpy() for t in (hd, hr, ivd, ivr))
        d = np.concatenate([hd, ivd], axis=1)
        r = np.concatenate([hr, ivr], axis=1)
        d = np.where(r >= 0, d, np.inf)
        order = np.argsort(d, axis=1)[:, :k]
        out_d = np.take_along_axis(d, order, axis=1)
        out_r = np.take_along_axis(r, order, axis=1)
        out_r = np.where(np.isfinite(out_d), out_r, -1)
        return out_d, out_r

    return run
