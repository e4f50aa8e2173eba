"""IVF (inverted-file) index: k-means coarse quantizer, membership and the
n-probe search.

The JAX package's ``index/ivf.py`` as far as the ported slices need it:
training (k-means, K6), centroid install, assignment of rows to lists,
removal, membership masks and counters, the padded list tiles, and the
search by metric (euclidean, cosine, dot) on an f32 or bf16 mirror: the
centroid ranking (K1 over the centroids, by the same metric) and the
probed list scan with its top-k (K12, :func:`ivf_search`). Retraining,
adding clusters, balancing, compaction and the quality evaluation are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.distance import (METRIC_CODE, check_metric, finalize_distance,
                            pairwise_distance, squared_norms)
from ..ops.kmeans import assign_clusters, kmeans_train_stepped
from ..ops.topk import (INF, l2_topk, masked_topk_plain, merge_topk_plain,
                        select_scratch)
from ..utils import native
from ..utils.padding import bucket, fit_mask, grow_rows
from ..utils.transfer import to_device, to_host
from .store import VectorStore, serving_mirror

# bytes of (distance, row) candidates, and of the filtered select's
# survivor slots, one K12 call holds; larger batches run in query chunks,
# each of which reads its lists again (a B = 128 batch of the 1M tier at
# n_probe 16 fits in one)
_CAND_BYTES = 1 << 30
# batches of at least this many queries take K12's grouped route (a list
# read once a group of queries that probe it); smaller ones the per-query
# route, where lists are rarely shared and a block a (chunk, probe, query)
# keeps more loads in flight. On the H100, over bench.py's 1M-tier shapes
# (16 of 256 lists): per-query faster at B = 1, 2, 4 (190 / 327 / 414 us
# against 274 / 363 / 458), grouped from B = 8 (655 against 778 us;
# scripts/time_merge_ivf.py)
GROUP_MIN_B = 8
# csrc/ivf_scan.cu's task shape: queries a group, list entries a chunk
GROUP_QT, GROUP_RT = 32, 256
# ... and its filtered select: up to this k, at most this many survivors a
# query (8-byte keys) in its scratch
_BAR_MAX_K, _SURV_CAP = 32, 8192


@dataclass
class IVFLists:
    """The quantizer and the packed lists on the device: what K12 reads of
    an IVF index besides the mirror and the mask."""
    centroids: torch.Tensor  # [C, D] f32
    c_sq: torch.Tensor  # [C] f32
    tiles: torch.Tensor  # [C, L_pad] int32, each list packed at the front
    list_len: torch.Tensor  # [C] int32
    longest: np.ndarray  # [C] int64 (host): running sum, longest list first

    @classmethod
    def upload(cls, centroids: np.ndarray, tiles: np.ndarray,
               device: torch.device) -> "IVFLists":
        lens = (tiles >= 0).sum(1)
        cents = to_device(np.asarray(centroids, np.float32), device)
        return cls(cents, squared_norms(cents), to_device(tiles, device),
                   to_device(lens.astype(np.int32), device),
                   np.cumsum(np.sort(lens)[::-1]))

    def most_candidates(self, n_probe: int) -> int:
        """The most list rows any query probing ``n_probe`` lists scans."""
        return int(self.longest[min(n_probe, self.longest.size) - 1])


def ivf_scan_plain(x, x_sq, mask, lists: IVFLists, probe, q, k: int,
                   extra_mask=None, seed=None, metric: str = "euclidean",
                   c_lo: int = 0):
    """Plain version of K12's list scan from given probes (see
    :func:`ivf_scan`): probe by probe, masked_topk of each list merged
    into the running list by (distance, row), over the padded tiles."""
    b = q.shape[0]
    tiles = lists.tiles
    c_local, l_pad = tiles.shape
    if extra_mask is not None:
        mask = mask & extra_mask
    q_sq = (q * q).sum(-1)
    k_step = min(k, l_pad)
    vals = torch.full((b, k), INF, device=q.device)
    idx = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    if seed is not None:
        vals, idx = merge_topk_plain(vals, idx, seed[0][:, :k],
                                     seed[1][:, :k], k)
    if x.shape[0] == 0:  # no rows to gather: every list is empty
        return vals, idx
    for p in range(probe.shape[1]):
        local = probe[:, p].long() - c_lo
        owned = (probe[:, p] >= 0) & (local >= 0) & (local < c_local)
        cand = tiles[local.clamp(0, max(c_local - 1, 0))]  # [B, L_pad]
        valid = (cand >= 0) & (cand < x.shape[0]) & owned[:, None]
        safe = torch.where(valid, cand, torch.zeros_like(cand)).long()
        dots = torch.einsum("bd,bld->bl", q, x[safe].float())
        if metric == "euclidean":
            d = (q_sq[:, None] - 2.0 * dots + x_sq[safe]).clamp_min(0.0)
        elif metric == "cosine":
            denom = (q_sq[:, None] * x_sq[safe]).clamp_min(1e-30).sqrt()
            d = 1.0 - dots / denom
        else:  # dot
            d = -dots
        cvals, cpos = masked_topk_plain(d, valid & mask[safe], k_step)
        crow = torch.where(
            cpos >= 0,
            torch.gather(safe, 1, cpos.clamp_min(0).long()).to(torch.int32),
            torch.full_like(cpos, -1))
        vals, idx = merge_topk_plain(vals, idx, cvals, crow, k)
    return vals, idx


def ivf_groups_plain(probe, list_len, c_lo: int = 0):
    """Plain version of K12's work list (csrc/ivf_scan.cu's
    ivf_group_kernel) for probe [B, P] over the lists c_lo .. c_lo + C - 1
    of list_len [C]: a dict of ``slot`` [B, P] (each pair's candidate-slot
    offset: its query's earlier probes' owned lengths summed), ``n_lists``
    [B] (a query's list candidates), ``lstart`` [C + 1] and ``tstart`` [C +
    1] (exclusive sums of each list's pairs and tasks), ``pair_b`` and
    ``pair_slot`` (the pairs that scan rows, by list; the card orders a
    list's pairs by arrival, this version by query) and ``n_tasks``. A
    task is a group of <= GROUP_QT queries and a chunk of <= GROUP_RT rows
    of one list."""
    b, p = probe.shape
    c = list_len.shape[0]
    local = probe.long() - c_lo
    owned = (probe >= 0) & (local >= 0) & (local < c)
    lens = torch.where(owned, list_len.long()[local.clamp(0, max(c - 1, 0))],
                       torch.zeros_like(local))
    slot = torch.cumsum(lens, 1) - lens
    scans = lens > 0
    lid = torch.where(scans, local, torch.full_like(local, c))
    order = torch.argsort(lid.reshape(-1), stable=True)
    flat = lid.reshape(-1)[order]
    keep = flat < c
    cnt = torch.bincount(flat[keep], minlength=c)
    ll = list_len.long()
    tasks = torch.where((cnt > 0) & (ll > 0),
                        ((cnt + GROUP_QT - 1) // GROUP_QT)
                        * ((ll + GROUP_RT - 1) // GROUP_RT),
                        torch.zeros_like(cnt))
    zero = torch.zeros(1, dtype=torch.long, device=probe.device)
    lstart = torch.cat([zero, torch.cumsum(cnt, 0)])
    tstart = torch.cat([zero, torch.cumsum(tasks, 0)])
    return {"slot": slot, "n_lists": lens.sum(1), "lstart": lstart,
            "tstart": tstart, "pair_b": order[keep] // p,
            "pair_slot": slot.reshape(-1)[order[keep]],
            "n_tasks": int(tstart[-1])}


def ivf_scan(x, x_sq, mask, lists: IVFLists, probe, q, k: int,
             extra_mask=None, seed=None, metric: str = "euclidean",
             c_lo: int = 0, grouped: bool | None = None):
    """K12's list scan and top-k from given probes: probe [B, P] int32
    global list ids (-1: none), of which ``lists.tiles`` [C_local, L_pad]
    holds the lists c_lo .. c_lo + C_local - 1 (each packed at the front
    with rows of x, -1 padded); a probe outside that range scans nothing.
    x, x_sq, mask, extra_mask, seed and metric as in :func:`ivf_search`
    (``lists.centroids`` is not read). Returns (vals [B, k], rows [B, k])
    by (distance, row), +inf / -1 padded. K15's sharded IVF search runs it
    on each shard's lists (rows there are positions in the shard's packed
    rows). The plain version on CPU tensors, csrc/ivf_scan.cu on CUDA
    tensors: the grouped route (a list read once a group of up to
    GROUP_QT queries that probe it; at k <= 32 its scan sets a bar a query
    and the select sorts what passes it, the radix select taking a query
    only where more than 8,192 pass) from GROUP_MIN_B queries, the
    per-query route below (``grouped`` forces one); a query's candidates
    take at most the P longest lists' rows, so the candidate buffer is
    sized by those and queries go in chunks of at most _CAND_BYTES of it
    and of the survivor slots."""
    check_metric(metric)
    if x.device.type == "cpu":
        return ivf_scan_plain(x, x_sq, mask, lists, probe, q, k, extra_mask,
                              seed, metric, c_lo)
    if x.device.type != "cuda":
        raise ValueError(f"ivf_scan: unsupported device {x.device}")
    return _scan(x, x_sq, mask, lists, probe, q, k, extra_mask, seed,
                 metric, c_lo, grouped)[:2]


def _scan(x, x_sq, mask, lists, probe, q, k, extra_mask, seed, metric,
          c_lo, grouped):
    """The CUDA route of :func:`ivf_scan`; also returns the last chunk's
    group scratch (None on the per-query route), which still holds its
    work list (csrc/ivf_scan.cu's GroupScratch), and n_per."""
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    native.check(x, "x", torch.bfloat16 if bf16 else torch.float32, 2, dev)
    native.check(x_sq, "x_sq", torch.float32, 1, dev)
    native.check(mask, "mask", torch.bool, 1, dev)
    if extra_mask is not None:
        native.check(extra_mask, "extra_mask", torch.bool, 1, dev)
    native.check(lists.tiles, "tiles", torch.int32, 2, dev)
    native.check(lists.list_len, "list_len", torch.int32, 1, dev)
    native.check(probe, "probe", torch.int32, 2, dev)
    native.check(q, "q", torch.float32, 2, dev)
    b, d = q.shape
    c_local, l_pad = lists.tiles.shape
    n_probe = probe.shape[1]
    if x.shape[1] != d or k < 1 or probe.shape[0] != b or n_probe < 1:
        raise ValueError(
            f"ivf_scan: tiles {(c_local, l_pad)}, probe "
            f"{tuple(probe.shape)}, q {tuple(q.shape)}, x {tuple(x.shape)}, "
            f"k {k}")
    k_seed, seed_stride = 0, 1
    seed_d = seed_r = None
    if seed is not None:
        seed_d, seed_r = seed
        native.check(seed_d, "seed vals", torch.float32, 2, dev)
        native.check(seed_r, "seed rows", torch.int32, 2, dev)
        seed_stride = seed_d.shape[1]
        k_seed = min(k, seed_stride)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_r, None, None
    if grouped is None:
        grouped = b >= GROUP_MIN_B
    grouped = grouped and c_local > 0
    stride = max(1, lists.most_candidates(n_probe) + k_seed)
    surv = min(stride, _SURV_CAP) if grouped and k <= _BAR_MAX_K else 0
    qc = max(1, min(b, _CAND_BYTES // (8 * (stride + surv))))
    cand_d = torch.empty((qc, stride), dtype=torch.float32, device=dev)
    cand_r = torch.empty((qc, stride), dtype=torch.int32, device=dev)
    n_per = torch.empty(qc, dtype=torch.int32, device=dev)
    grp = None
    if grouped:
        grp = torch.empty(native.query(
            "ivf_scan", "fvdb_ivf_group_ints", [native.I] * 4 + [native.L],
            qc, n_probe, c_local, k, stride), dtype=torch.int32, device=dev)
    P, I, L = native.P, native.I, native.L
    fn = native.fn("ivf_scan", "fvdb_ivf_scan",
                   [P, I, I, P, P, P, P, I, P, P, I, I, I, P, I, I, I, P, P,
                    I, I, I, L, P, P, P, P, P, P, P, P])
    stream = native.stream_of(x)
    for lo in range(0, b, qc):
        hi = min(b, lo + qc)
        work = select_scratch("ivf_scan", hi - lo, k, dev)
        err = fn(x.data_ptr(), int(bf16), METRIC_CODE[metric],
                 x_sq.data_ptr(), mask.data_ptr(),
                 0 if extra_mask is None else extra_mask.data_ptr(),
                 lists.tiles.data_ptr(), l_pad, lists.list_len.data_ptr(),
                 probe[lo:hi].data_ptr(), n_probe, int(c_lo), c_local,
                 q[lo:hi].data_ptr(), hi - lo, d, x.shape[0],
                 0 if seed_d is None else seed_d[lo:hi].data_ptr(),
                 0 if seed_r is None else seed_r[lo:hi].data_ptr(),
                 seed_stride, k_seed, k, stride, cand_d.data_ptr(),
                 cand_r.data_ptr(), n_per.data_ptr(),
                 0 if grp is None else grp.data_ptr(), work.data_ptr(),
                 out_d[lo:hi].data_ptr(), out_r[lo:hi].data_ptr(), stream)
        if err:
            native.raise_on(err, "ivf_scan", "fvdb_ivf_scan")
        native.launches[native.counter("ivf_scan", bf16, metric)] += 1
    return out_d, out_r, grp, n_per[: min(b, qc)]


def ivf_search_plain(x, x_sq, mask, lists: IVFLists, q, k: int,
                     n_probe: int, extra_mask=None, seed=None,
                     metric: str = "euclidean"):
    """Plain version of K12: the reference's ivf_search_kernel(metric),
    probe by probe (masked_topk of each list, merged into the running list
    by (distance, row)), over the padded tiles. bf16 rows are upcast with
    the f32 query, as the reference's einsum computes. ``seed`` (vals,
    rows) [B, >=1] starts the running list with its first k entries instead
    of +inf, which is merge_topk(seed, ivf result)."""
    dc = pairwise_distance(q, lists.centroids, metric, lists.c_sq)  # [B, C]
    n_probe = min(n_probe, lists.centroids.shape[0])
    _, probe = masked_topk_plain(dc, None, n_probe)
    vals, idx = ivf_scan_plain(x, x_sq, mask, lists, probe, q, k, extra_mask,
                               seed, metric)
    return vals, idx, probe


def ivf_search(x, x_sq, mask, lists: IVFLists, q, k: int, n_probe: int,
               extra_mask=None, seed=None, metric: str = "euclidean"):
    """K12: batched n-probe search by ``metric`` (euclidean: squared L2;
    cosine: 1 - cos; dot: -q.x). x [N, D] f32 or bf16 (a bf16 mirror, upcast
    exactly; the query stays f32), x_sq [N] f32 (the mirror's norms), mask
    [N] bool (and ``extra_mask`` [N] bool, ANDed), ``lists`` the quantizer
    and tiles (row ids packed at the front of each list, -1 padded); q
    [B, D]. ``seed`` (vals, rows) [B, S] joins its first min(k, S) entries
    to the candidates (rows disjoint from the lists'). Returns (vals [B, k],
    rows [B, k], probe [B, P]): the k smallest by (distance, row), +inf / -1
    padded.

    The plain version on CPU tensors; on CUDA tensors K1 ranks the
    centroids by the metric (all of them, k = n_probe: ties go to the lower
    centroid, as ``lax.top_k`` does) and :func:`ivf_scan` (csrc/ivf_scan.cu)
    scans the probed lists and selects, or it raises."""
    check_metric(metric)
    if x.device.type == "cpu":
        return ivf_search_plain(x, x_sq, mask, lists, q, k, n_probe,
                                extra_mask, seed, metric)
    dev = x.device
    native.check(lists.centroids, "centroids", torch.float32, 2, dev)
    native.check(lists.c_sq, "c_sq", torch.float32, 1, dev)
    c = lists.tiles.shape[0]
    if lists.centroids.shape != (c, q.shape[1]):
        raise ValueError(
            f"ivf_search: centroids {tuple(lists.centroids.shape)}, tiles "
            f"{tuple(lists.tiles.shape)}, q {tuple(q.shape)}")
    _, probe = l2_topk(lists.centroids, lists.c_sq, None, q, min(n_probe, c),
                       metric=metric)
    vals, rows = ivf_scan(x, x_sq, mask, lists, probe, q, k, extra_mask, seed,
                          metric)
    return vals, rows, probe


class NotTrainedError(RuntimeError):
    pass


class TrainingError(ValueError):
    pass


@dataclass
class IVFConfig:
    n_clusters: int = 256
    n_probe: int = 16
    train_size: int = 10_000
    max_iterations: int = 25
    seed: int = 42


@dataclass
class TrainStats:
    iterations: int
    converged: bool
    final_error: float


class IVFIndex:
    """Inverted-file index over a shared VectorStore."""

    # rows per assignment launch: bounds the gathered [rows, D] transient
    _ASSIGN_CHUNK = 1_048_576

    def __init__(self, store: VectorStore, config: IVFConfig | None = None):
        self.store = store
        self.config = config or IVFConfig()
        self.centroids: np.ndarray | None = None  # [C, D] f32
        # row -> cluster id; -1 means "not a member of this index"
        self.assignments = np.full(store.capacity, -1, np.int32)
        self.trained = False
        self._tiles: np.ndarray | None = None
        self._tiles_version = -1
        self._version = 0
        # the device lists (IVFLists) keyed by this index's version, and
        # the standalone search's member mask keyed by both versions
        self._dev_lists: IVFLists | None = None
        self._dev_lists_version = -1
        self._dev_mask = None
        self._dev_mask_key = None

    # ------------------------------------------------------------- training
    def train(self, vectors: np.ndarray) -> TrainStats:
        """k-means train the coarse quantizer; does NOT insert the vectors."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2:
            raise TrainingError("training data must be [n, dim]")
        if vectors.shape[0] < self.config.n_clusters:
            raise TrainingError(
                f"need at least n_clusters={self.config.n_clusters} training "
                f"vectors, got {vectors.shape[0]}")
        if vectors.shape[1] != self.store.dim:
            raise TrainingError(
                f"training dim {vectors.shape[1]} != store dim {self.store.dim}")
        n = min(vectors.shape[0], self.config.train_size)
        # the same masked power-of-two padding as the reference, so both
        # train on the same [n_pad, D] sample
        n_pad = bucket(n, minimum=min(1024, n))
        if vectors.shape[0] > n:
            sel = np.random.default_rng(self.config.seed).choice(
                vectors.shape[0], n, replace=False)
            sample = vectors[np.sort(sel)]
        else:
            sample = vectors[:n]
        if n_pad > n:
            sample = np.concatenate(
                [sample, np.zeros((n_pad - n, sample.shape[1]), np.float32)])
        dev = self.store.torch_device
        res = kmeans_train_stepped(
            self.config.seed, to_device(sample, dev),
            torch.arange(n_pad, device=dev) < n,
            n_clusters=self.config.n_clusters,
            max_iterations=self.config.max_iterations)
        self.centroids = res.centroids.cpu().numpy()
        self.trained = True
        self._version += 1
        return TrainStats(res.iterations, res.converged, res.final_error)

    def set_trained(self, centroids: np.ndarray) -> None:
        """Install centroids directly (load path / tests); validates before
        mutating, and drops assignments past the new cluster count."""
        cents = np.asarray(centroids, np.float32)
        if cents.ndim != 2 or cents.shape[1] != self.store.dim:
            raise TrainingError("centroids must be [C, dim]")
        self.centroids = cents
        self.assignments[self.assignments >= cents.shape[0]] = -1
        self.trained = True
        self._version += 1

    # ------------------------------------------------------------- mutation
    def _ensure_capacity(self) -> None:
        if self.assignments.shape[0] < self.store.capacity:
            self.assignments = grow_rows(
                self.assignments, self.store.capacity, fill=-1)

    def insert_rows(self, rows: np.ndarray) -> None:
        """Assign store rows to their nearest centroid, gathering them from
        the device mirror (only row indices go up)."""
        if not self.trained:
            raise NotTrainedError("IVF index is not trained")
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        self._ensure_capacity()
        dev = self.store.torch_device
        cents = to_device(self.centroids, dev)
        mirror = serving_mirror(self.store)
        for lo in range(0, rows.size, self._ASSIGN_CHUNK):
            sub = rows[lo: lo + self._ASSIGN_CHUNK]
            # bf16 mirror rows are upcast exactly, then K6's f32 assignment
            vecs = mirror.x[to_device(sub, dev)].float()
            assign, _ = assign_clusters(vecs, cents)
            self.assignments[sub] = assign.cpu().numpy()
        self._version += 1

    def remove_rows(self, rows: np.ndarray) -> None:
        self._ensure_capacity()
        self.assignments[np.asarray(rows, np.int64)] = -1
        self._version += 1

    def member_rows(self) -> np.ndarray:
        return np.nonzero(self.member_mask())[0]

    def member_mask(self, n: int | None = None) -> np.ndarray:
        """[n or store.capacity] bool membership (non-mutating)."""
        assign = self.assignments  # local ref: growth replaces the object
        if n is None:
            n = max(self.store.capacity, assign.shape[0])
        m = np.zeros(n, bool)
        c = min(n, assign.shape[0])
        m[:c] = assign[:c] >= 0
        return m

    @property
    def active_count(self) -> int:
        act = self.store.active_mask()
        m = self.member_mask(act.shape[0])
        return int((m & act).sum())

    @property
    def deleted_count(self) -> int:
        deleted = self.store.deleted
        count = min(self.store.count, deleted.shape[0])
        m = self.member_mask(count)
        return int((m & deleted[:count]).sum())

    def vacuum(self) -> int:
        """Drop tombstoned/deleted rows from the lists. Returns count removed."""
        self._ensure_capacity()
        dead = np.zeros(self.assignments.shape[0], bool)
        dead[: self.store.count] = self.store.deleted[: self.store.count]
        removed = int(((self.assignments >= 0) & dead).sum())
        self.assignments[dead] = -1
        self._version += 1
        return removed

    def retrain(self, new_config: IVFConfig | None = None) -> TrainStats:
        """Collect the active members, train under the (new) config on the
        store's device and assign them again (the reference's retrain,
        src/ivf/operations.rs:148-193). The config is installed only once
        the members are known to be enough."""
        members = self.member_rows()
        act = self.store.active_mask()
        members = members[act[members]]
        cfg = new_config if new_config is not None else self.config
        if members.size < cfg.n_clusters:
            raise TrainingError("not enough active members to retrain")
        self.config = cfg
        stats = self.train(self.store.data[members])
        self.assignments[:] = -1
        self.insert_rows(members)
        return stats

    def export_centroids(self) -> np.ndarray:
        if not self.trained:
            raise NotTrainedError("IVF index is not trained")
        return self.centroids.copy()

    def import_centroids(self, centroids: np.ndarray) -> None:
        self.set_trained(centroids)

    # ---------------------------------------------------------------- tiles
    def _build_tiles(self) -> np.ndarray:
        """Pack assignments into padded [C, L_pad] row-id tiles (rows in
        increasing order within a list; L_pad a power of two >= 128)."""
        c = (self.config.n_clusters if self.centroids is None
             else self.centroids.shape[0])
        assign_arr = self.assignments  # one snapshot, then filter
        members = np.nonzero(assign_arr >= 0)[0]
        if members.size == 0:
            return np.full((c, 128), -1, np.int32)
        assign = assign_arr[members]
        ok = (assign >= 0) & (assign < c)
        members, assign = members[ok], assign[ok]
        if members.size == 0:
            return np.full((c, 128), -1, np.int32)
        counts = np.bincount(assign, minlength=c)
        l_pad = max(128, bucket(int(counts.max()), minimum=128))
        tiles = np.full((c, l_pad), -1, np.int32)
        order = np.argsort(assign, kind="stable")
        sorted_rows = members[order]
        sorted_assign = assign[order]
        starts = np.zeros(c + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.arange(sorted_rows.size) - starts[sorted_assign]
        tiles[sorted_assign, pos] = sorted_rows
        return tiles

    def tiles(self) -> np.ndarray:
        if self._tiles is None or self._tiles_version != self._version:
            # the version is read BEFORE building: a writer bumping it
            # mid-build must invalidate this build
            v = self._version
            t = self._build_tiles()
            self._tiles, self._tiles_version = t, v
        return self._tiles

    def device_lists(self) -> IVFLists:
        """The centroids and tiles on the device, uploaded once a version
        (the standalone search and the fused searcher share them)."""
        if not self.trained:
            raise NotTrainedError("IVF index is not trained")
        lists = self._dev_lists
        if lists is None or self._dev_lists_version != self._version:
            v = self._version  # read before building, as tiles() does
            lists = IVFLists.upload(self.centroids, self.tiles(),
                                    self.store.torch_device)
            self._dev_lists, self._dev_lists_version = lists, v
        return lists

    # ---------------------------------------------------------------- search
    def search_rows(self, queries: np.ndarray, k: int,
                    n_probe: int | None = None,
                    extra_mask: np.ndarray | None = None,
                    metric: str = "euclidean"):
        """Returns (distances [B, k], rows [B, k]): true euclidean
        distances, or cosine / negative-dot distances as they are
        (``finalize_distance``)."""
        if not self.trained:
            raise NotTrainedError("IVF index is not trained")
        check_metric(metric)
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        n_probe = n_probe if n_probe is not None else self.config.n_probe
        mirror = serving_mirror(self.store)
        # masks fit the mirror's row count
        n = int(mirror.x.shape[0])
        device = self.store.torch_device
        lists = self.device_lists()
        key = (self._version, self.store._version, n)
        if extra_mask is not None:  # per-call filter, on a fresh snapshot
            mask_dev = to_device(
                self.store.active_mask(n) & self.member_mask(n)
                & fit_mask(extra_mask, n), device)
        else:
            if self._dev_mask is None or self._dev_mask_key != key:
                self._dev_mask = to_device(
                    self.store.active_mask(n) & self.member_mask(n), device)
                self._dev_mask_key = key
            mask_dev = self._dev_mask
        vals, rows, _ = ivf_search(
            mirror.x, mirror.x_sq, mask_dev, lists, to_device(queries, device),
            bucket(k), n_probe, metric=metric)
        vals, rows = to_host(vals, rows)
        return finalize_distance(vals[:, :k], metric), rows[:, :k]

    def memory_usage_bytes(self) -> int:
        total = self.assignments.nbytes
        if self.centroids is not None:
            total += self.centroids.nbytes
        return int(total)
