"""Persistence: chunked manifest-v3 hybrid format + per-engine persisters.

The JAX package's ``storage/persistence.py`` over the port's index: the
same keys, manifests, sidecars and chunk bytes, so a save made by either
package loads in the other. The persisters take ``device`` (None: the card)
for the stores they build. A lazy load's materializer is a daemon thread
named ``fvdb-materialize``; on the card its device uploads go through a
:class:`MirrorStager` on a side stream, ordered before the first search
that reads the installed mirror by a CUDA event.

Rebuild of the reference persistence tier
(reference: src/hybrid/persistence.rs, src/hnsw/persistence.rs,
src/ivf/persistence.rs). Key mapping:
  - ``HybridPersister.save_index_chunked`` (hybrid/persistence.rs:188-277):
    collect vectors -> partition into chunk_size chunks (:315) -> chunk CBOR
    blobs under chunks/chunk-N.cbor (:340-372) -> HNSW/IVF manifests
    (:375-445) -> deleted ids into manifest (:234-238) -> manifest.json +
    state + graph + metadata. Chunks are dense array shards (not per-id CBOR
    maps) so a chunk uploads straight to device memory;
  - row->engine membership and IVF assignments are persisted exactly
    (state.cbor) instead of the reference's chunk-attribution hash heuristic
    (:448-468) and O(N·C·D) nearest-centroid reassignment on load (:593-656)
    — both listed in SURVEY §7 as quirks to fix;
  - the full HNSW graph is saved (hnsw_graph.cbor, analog of the reference's
    hnsw_nodes.cbor :261-271) with adjacency remapped to save-order
    positions, so load is O(N) with zero rebuild;
  - ``load_index_chunked`` (:497-693): manifest -> version check -> parallel
    chunk fetch (thread pool ~ the reference's tokio fan-out :539-570) ->
    graph install -> timestamps -> re-mark deleted (:684-690);
  - incremental save via per-chunk content hashes (analog of dirty-node /
    modified-cluster incremental saves, hnsw/persistence.rs:187-240,
    ivf/persistence.rs:267-297);
  - save_with_backup / restore_from_backup (hnsw/persistence.rs:242-305);
  - check_integrity -> missing-chunk RecoveryInfo (hnsw/persistence.rs:307-349,
    ivf count verification ivf/persistence.rs:206-265).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from .. import cbor
from ..core.chunk import (
    ChunkMetadata,
    HNSWManifest,
    IVFManifest,
    Manifest,
    VectorChunk,
    _pack_ids,
    _unpack_ids,
)
from ..core.object_store import NotFoundError, ObjectStore
from ..core.schema import MetadataSchema
from ..index.hybrid import HybridConfig, HybridIndex
from ..index.hnsw import HNSWConfig, HNSWIndex
from ..index.ivf import IVFConfig, IVFIndex
from ..index.store import VectorStore
from .chunk_loader import ChunkLoader

FORMAT_VERSION = 1  # binary payload version (manifest carries v3 semantics)


class PersistenceError(RuntimeError):
    pass


class IncompleteSaveError(PersistenceError):
    pass


@dataclass
class RecoveryInfo:
    expected_chunks: int
    found_chunks: int
    missing_chunks: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.missing_chunks


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _hybrid_config_json(cfg: HybridConfig) -> dict:
    return {
        "recent_threshold_secs": cfg.recent_threshold_secs,
        "migration_batch_size": cfg.migration_batch_size,
        "auto_migrate": cfg.auto_migrate,
        "min_ivf_training_size": cfg.min_ivf_training_size,
        "hnsw": {
            "m": cfg.hnsw.m, "m0": cfg.hnsw.m0,
            "ef_construction": cfg.hnsw.ef_construction,
            "ef_search": cfg.hnsw.ef_search,
            "level_p": cfg.hnsw.level_p, "max_level": cfg.hnsw.max_level,
            "seed": cfg.hnsw.seed,
        },
        "ivf": {
            "n_clusters": cfg.ivf.n_clusters, "n_probe": cfg.ivf.n_probe,
            "train_size": cfg.ivf.train_size,
            "max_iterations": cfg.ivf.max_iterations, "seed": cfg.ivf.seed,
        },
    }


def _maybe_stager(n_total: int, dim: int, device):
    """A MirrorStager when the loaded corpus will serve from a full-dim
    device mirror and TWO copies fit the budget transiently (staged blocks +
    the concatenated mirror coexist during install); None otherwise —
    beyond-flat regimes build their own (reduced-rank) mirror and must not
    have a full-dim one uploaded behind their back."""
    from ..utils import limits
    from ..utils.padding import grow_capacity

    dtype = limits.serving_dtype()
    cap = grow_capacity(max(int(n_total), 1))
    if cap > limits.effective_flat_threshold():
        return None
    bytes_row = dim * (2 if dtype == "bfloat16" else 4)
    if 2 * cap * bytes_row + (1 << 30) > limits.hbm_budget_bytes():
        return None
    from ..index.store import MirrorStager

    return MirrorStager(dtype, device)


def _hybrid_config_from_json(obj: dict) -> HybridConfig:
    h = obj.get("hnsw") or {}
    v = obj.get("ivf") or {}
    return HybridConfig(
        recent_threshold_secs=obj.get("recent_threshold_secs", 7 * 86400.0),
        migration_batch_size=obj.get("migration_batch_size", 100),
        auto_migrate=obj.get("auto_migrate", True),
        min_ivf_training_size=obj.get("min_ivf_training_size", 10),
        hnsw=HNSWConfig(**h) if h else HNSWConfig(),
        ivf=IVFConfig(**v) if v else IVFConfig(),
    )


class HybridPersister:
    """Chunked manifest-v3 save/load of a HybridIndex over an ObjectStore."""

    def __init__(self, store: ObjectStore, chunk_loader: ChunkLoader | None = None,
                 device=None):
        self.store = store
        self.loader = chunk_loader or ChunkLoader(store)
        self.device = device

    # ------------------------------------------------------------------ save
    def save_index_chunked(
        self,
        index: HybridIndex,
        session_id: str,
        chunk_size: int = 10_000,
        schema: MetadataSchema | None = None,
        incremental: bool = False,
    ) -> Manifest:
        index.wait_ready()  # a lazily-loaded index must be resident to save
        s = index.store
        # save reads levels/assignments by store row (owner context, so
        # mutation is fine); member_mask() no longer grows them as a side
        # effect, so grow explicitly before the row-indexed reads below
        index.hnsw._ensure_capacity()
        index.ivf._ensure_capacity()
        # global save order: allocated rows with live ids (tombstones
        # skipped), grouped for CHUNK LOCALITY — HNSW members first, then
        # IVF members grouped by cluster, then unindexed rows. A cluster's
        # rows land in a contiguous span of chunks, so a cold (lazy-load)
        # search can serve by fetching only the chunks its probe list
        # touches — the on-demand access pattern the reference's
        # ChunkLoader exists for (reference: src/storage/chunk_loader.rs,
        # src/hybrid/persistence.rs:497-570), instead of reading 1/n_probe
        # of EVERY chunk. Row-order saves (any permutation) load
        # identically; the layout below is recorded for cold serving.
        order = np.array(
            [r for r in range(s.count) if s.row_to_id[r] is not None], np.int64
        )
        n = order.size
        n_clusters = (index.ivf.centroids.shape[0]
                      if index.ivf.trained else 0)
        hnsw_m = index.hnsw.member_mask()[order] if n else np.zeros(0, bool)
        assign0 = (index.ivf.assignments[order] if index.ivf.trained
                   else np.full(n, -1, np.int32))
        # composite group key: HNSW -> -1 (first), IVF -> cluster id,
        # neither -> n_clusters (last); stable sort keeps row order inside
        # each group
        group = np.where(hnsw_m, -1,
                         np.where(assign0 >= 0, assign0, n_clusters))
        perm = np.argsort(group, kind="stable")
        order = order[perm]
        group = group[perm]
        ids = [s.row_to_id[r] for r in order]
        # contiguous position spans per group (for manifest.extra["layout"])
        hnsw_count = int(hnsw_m.sum())
        cluster_spans: dict = {}
        if n:
            bounds = np.flatnonzero(np.diff(group)) + 1
            starts = np.concatenate(([0], bounds))
            ends = np.concatenate((bounds, [n]))
            for st, en in zip(starts, ends):
                g = int(group[st])
                if 0 <= g < n_clusters:
                    cluster_spans[str(g)] = [int(st), int(en)]

        prev_hashes: dict = {}
        prev_chunk_ids: list = []
        try:
            prev = Manifest.from_json(
                self.store.get(f"{session_id}/manifest.json").decode()
            )
            prev_hashes = dict(prev.extra.get("chunk_hashes") or {})
            prev_chunk_ids = [c.chunk_id for c in prev.chunks]
        except Exception:
            pass
        if not incremental:
            prev_hashes = {}

        manifest = Manifest(chunk_size=chunk_size, total_vectors=int(n))
        chunk_hashes: dict = {}
        chunk_of_pos = np.zeros(n, np.int32)
        n_chunks = (n + chunk_size - 1) // chunk_size
        skipped = 0
        # byte offset of each chunk's raw f32 row block inside its CBOR
        # blob: the chunk encoder writes ``data`` last, so the payload is
        # the blob's tail — verified per chunk below (zero-copy frombuffer
        # compare), and recorded in the layout so a lazy cold search can
        # range-read ONLY the row spans its probe plan touches instead of
        # whole 15 MB chunks (VERDICT r4 #1: 58/100 chunks, 33 s first
        # search at 1M)
        data_offsets: list = []
        for ci in range(n_chunks):
            lo, hi = ci * chunk_size, min((ci + 1) * chunk_size, n)
            chunk_of_pos[lo:hi] = ci
            chunk_id = f"chunk-{ci}"
            chunk = VectorChunk(
                chunk_id, lo, hi - 1, ids[lo:hi], s.data[order[lo:hi]]
            )
            payload = chunk.to_cbor()
            off = len(payload) - chunk.data.nbytes
            # raw-byte compare, NOT float compare: array_equal treats NaN
            # as unequal-to-itself, so one NaN element would mark a
            # byte-identical tail -1 and silently disable the range fast
            # path for the whole load
            tail_ok = off >= 0 and payload[off:] == chunk.data.tobytes()
            data_offsets.append(int(off) if tail_ok else -1)
            h = _sha(payload)
            chunk_hashes[chunk_id] = h
            key = f"{session_id}/chunks/{chunk_id}.cbor"
            if incremental and prev_hashes.get(chunk_id) == h and self.store.exists(key):
                skipped += 1
            else:
                self.store.put(key, payload)
            manifest.add_chunk(
                ChunkMetadata(
                    chunk_id,
                    vector_count=hi - lo,
                    byte_size=len(payload),
                    id_range=(ids[lo], ids[hi - 1]) if hi > lo else None,
                )
            )

        # engine membership + timestamps + IVF assignments, save-order aligned
        hnsw_member = index.hnsw.member_mask()[order]
        ivf_assign = index.ivf.assignments[order] if index.ivf.trained else np.full(
            n, -1, np.int32
        )
        state = {
            "format_version": FORMAT_VERSION,
            "timestamps": s.timestamps[order].astype(np.float64),
            "hnsw_member": hnsw_member.astype(np.uint8),
            "ivf_assign": ivf_assign.astype(np.int32),
            # ids also live in the chunks; duplicating them here (packed,
            # ~20 bytes/row) lets lazy loads build the full id<->row mapping
            # without fetching any chunk
            "ids_packed": _pack_ids(ids),
        }
        self.store.put(f"{session_id}/state.cbor", cbor.dumps(state))

        # full HNSW graph (position space) for rebuild-free load
        member_pos = np.nonzero(hnsw_member)[0]
        if member_pos.size:
            graph = index.hnsw.export_graph(order[member_pos])
            graph["member_pos"] = member_pos.astype(np.int64)
            self.store.put(f"{session_id}/hnsw_graph.cbor", cbor.dumps(graph))

        # structures for the manifest (parity)
        hm = HNSWManifest(
            entry_point=s.id_of(index.hnsw.entry_point)
            if index.hnsw.entry_point >= 0
            else None
        )
        if member_pos.size:
            lv = index.hnsw.levels[order[member_pos]]
            for layer in range(int(lv.max()) + 1):
                hm.add_layer(layer, int((lv >= layer).sum()))
            if n <= 10_000:  # exact node->chunk map only for small indexes
                for p in member_pos:
                    hm.node_chunk_map[ids[p]] = f"chunk-{chunk_of_pos[p]}"
        manifest.hnsw_structure = hm
        if index.ivf.trained:
            im = IVFManifest(centroids=index.ivf.export_centroids())
            for c in range(im.num_centroids):
                in_c = np.nonzero(ivf_assign == c)[0]
                if in_c.size:
                    im.cluster_assignments[str(c)] = sorted(
                        {f"chunk-{chunk_of_pos[p]}" for p in in_c}
                    )
            manifest.ivf_structure = im

        deleted = index.get_deleted_vectors()
        manifest.deleted_vectors = deleted or None
        manifest.schema = schema
        manifest.extra = {
            "dim": s.dim,
            "hybrid_config": _hybrid_config_json(index.config),
            "chunk_hashes": chunk_hashes,
            "graph_saved": bool(member_pos.size),
            "chunks_skipped_incremental": skipped,
            # cluster-local save layout (position spans) — lets a lazy load
            # answer queries before materialization by fetching only the
            # chunks covering the HNSW members + probed clusters
            "layout": {
                "hnsw_span": [0, hnsw_count],
                "cluster_spans": cluster_spans,
                # -1 marks a chunk whose blob tail did not verify as the
                # raw f32 block (future format change); cold serving falls
                # back to whole-chunk fetches for those
                "data_offsets": data_offsets,
            },
        }
        manifest.validate()
        self.store.put(
            f"{session_id}/manifest.json", manifest.to_json().encode("utf-8")
        )
        # drop chunk files the new (possibly shrunken) manifest no longer
        # references — vacuumed indexes must not leave phantom chunks behind
        for stale in set(prev_chunk_ids) - set(chunk_hashes):
            try:
                self.store.delete(f"{session_id}/chunks/{stale}.cbor")
            except Exception:
                pass
        self.loader.cache.clear()  # stored chunks may differ from cached ones
        return manifest

    def save_incremental(self, index: HybridIndex, session_id: str,
                         chunk_size: int = 10_000,
                         schema: MetadataSchema | None = None) -> Manifest:
        return self.save_index_chunked(
            index, session_id, chunk_size, schema, incremental=True
        )

    # ------------------------------------------- non-chunked composite format
    def save_index(self, index: HybridIndex, path: str) -> None:
        """Non-chunked composite save: metadata + per-engine persisters under
        recent/ and historical/ (reference: src/hybrid/persistence.rs:142-175
        — metadata.cbor + timestamps.cbor + delegated HNSW/IVF saves).
        Timestamps live inside each engine's node payloads here."""
        index.wait_ready()
        has_hnsw = index.hnsw.num_nodes > 0
        has_ivf = index.ivf.trained
        meta = {
            "format_version": FORMAT_VERSION,
            "dim": index.store.dim,
            "hybrid_config": _hybrid_config_json(index.config),
            "has_hnsw": has_hnsw,
            "has_ivf": has_ivf,
        }
        self.store.put(f"{path}/metadata.cbor", cbor.dumps(meta))
        if has_hnsw:
            HNSWPersister(self.store, self.device).save_index(
                index.hnsw, f"{path}/recent")
        if has_ivf:
            IVFPersister(self.store, device=self.device).save_index(
                index.ivf, f"{path}/historical"
            )

    def load_index(self, path: str, config: HybridConfig | None = None):
        """Inverse of :meth:`save_index`. Returns a HybridIndex over one
        shared store (engines loaded standalone, then installed)."""
        try:
            meta = cbor.loads(self.store.get(f"{path}/metadata.cbor"))
        except NotFoundError:
            raise PersistenceError(f"no composite index at {path!r}") from None
        if config is None:
            config = _hybrid_config_from_json(meta.get("hybrid_config") or {})
        idx = HybridIndex(int(meta["dim"]), config, device=self.device)

        if meta.get("has_hnsw"):
            hstore, hidx = HNSWPersister(self.store, self.device).load_index(
                f"{path}/recent", config.hnsw
            )
            n = hstore.count
            if n:
                ids = [hstore.row_to_id[r] for r in range(n)]
                rows = idx.store.add_batch(
                    ids, hstore.data[:n], hstore.timestamps[:n]
                )
                idx.hnsw.install_graph(
                    rows, hidx.export_graph(np.arange(n, dtype=np.int64))
                )
                for r in np.nonzero(hstore.deleted[:n])[0]:
                    vid = hstore.row_to_id[r]
                    if vid is not None:
                        idx.store.mark_deleted(vid)
        if meta.get("has_ivf"):
            istore, iivf = IVFPersister(self.store, device=self.device).load_index(
                f"{path}/historical", config.ivf
            )
            idx.ivf.set_trained(iivf.centroids)
            n = istore.count
            if n:
                ids = [istore.row_to_id[r] for r in range(n)]
                rows = idx.store.add_batch(
                    ids, istore.data[:n], istore.timestamps[:n]
                )
                idx.ivf._ensure_capacity()
                idx.ivf.assignments[rows] = iivf.assignments[:n]
                idx.ivf._version += 1
                for r in np.nonzero(istore.deleted[:n])[0]:
                    vid = istore.row_to_id[r]
                    if vid is not None:
                        idx.store.mark_deleted(vid)
        idx.initialized = True
        return idx, meta

    # ------------------------------------------------------------------ load
    def load_manifest(self, session_id: str) -> Manifest:
        try:
            raw = self.store.get(f"{session_id}/manifest.json")
        except NotFoundError:
            raise PersistenceError(f"no manifest for session {session_id!r}") from None
        return Manifest.from_json(raw.decode("utf-8"))

    def load_index_chunked(
        self,
        session_id: str,
        config: HybridConfig | None = None,
        lazy: bool = False,
    ) -> tuple:
        """Returns (HybridIndex, Manifest).

        With ``lazy=True`` (and a save that recorded packed ids in
        state.cbor), the index returns after fetching only the small
        sidecars (manifest, state, graph — no vector chunks); chunk data
        streams into the store from background threads, and the first
        search blocks on ``HybridIndex.wait_ready()``. This is the
        fast-startup path the reference's lazyLoad option promised but
        left unimplemented (reference: bindings/node/src/session.rs:102-199,
        docs/IMPLEMENTATION_CHUNKED.md:44-50).
        """
        manifest = self.load_manifest(session_id)
        dim = int(manifest.extra.get("dim") or 0)
        if config is None:
            config = _hybrid_config_from_json(
                manifest.extra.get("hybrid_config") or {}
            )

        keys = [
            f"{session_id}/chunks/{c.chunk_id}.cbor" for c in manifest.chunks
        ]
        state = cbor.loads(self.store.get(f"{session_id}/state.cbor"))
        timestamps = np.asarray(state["timestamps"], np.float64)
        hnsw_member = np.asarray(state["hnsw_member"], np.uint8).astype(bool)
        ivf_assign = np.asarray(state["ivf_assign"], np.int32)
        ids_packed = state.get("ids_packed")

        deferred = lazy and ids_packed is not None
        stager = None
        # range fast path: with packed ids in the sidecar and save-time
        # verified data offsets over a range-capable store, chunk payloads
        # are read as RAW f32 byte ranges — no CBOR parse, no per-chunk id
        # decode. Measured at 1M x 384 the decode dominated full loads
        # (pure IO is 4-6 s of the 55-79 s eager load).
        layout0 = manifest.extra.get("layout") or {}
        data_offsets = layout0.get("data_offsets")
        chunk_rows = [c.vector_count for c in manifest.chunks]
        range_fast = (
            ids_packed is not None
            and dim > 0
            and data_offsets is not None
            and len(data_offsets) == len(keys)
            and all(int(o) >= 0 for o in data_offsets)
            and bool(getattr(self.store, "supports_range", False))
        )

        def _chunk_block(i: int) -> np.ndarray:
            """Chunk i's [rows_i, dim] f32 data, ranged when possible."""
            if range_fast:
                want = chunk_rows[i] * dim * 4
                raw = self.loader.fetch_range(
                    keys[i], int(data_offsets[i]), want)
                if len(raw) == want:
                    return np.frombuffer(raw, np.float32).reshape(-1, dim)
                # short read (blob changed underneath?): full decode path
            return self.loader.load_chunk(keys[i]).data

        if deferred:
            ids = _unpack_ids(ids_packed)
            blocks: list = []
        elif range_fast:
            # ids from the sidecar; chunk payloads as raw ranged reads —
            # through the loader pool on parallel (network) stores so the
            # fan-out the decode path had is kept
            ids = _unpack_ids(ids_packed)
            blocks = []
            live = [i for i in range(len(keys)) if chunk_rows[i] > 0]
            if getattr(self.store, "parallel_fetch", False) and len(live) > 1:
                fetched = self.loader._pool.map(_chunk_block, live)
            else:
                fetched = map(_chunk_block, live)
            for i, block in zip(live, fetched):
                if stager is None:
                    stager = _maybe_stager(manifest.total_vectors, dim,
                                           self.device)
                if stager is not None:
                    stager.add(i, block)
                blocks.append(block)
        else:
            # stream chunks in completion order and STAGE each block's
            # device transfer immediately (a side-stream upload): the corpus
            # upload overlaps the remaining fetch/decode work, so cold
            # serve-ready time is ~max(host load, device upload) instead of
            # their sum (VERDICT r2 #5 cold-start budget)
            slot_ids: list = [None] * len(keys)
            slot_data: list = [None] * len(keys)
            for i, c in self.loader.load_chunks_iter(keys):
                slot_ids[i] = c.ids
                slot_data[i] = c.data
                if c.data.shape[0]:
                    dim = dim or int(c.data.shape[1])
                    if stager is None:
                        stager = _maybe_stager(
                            manifest.total_vectors, dim, self.device)
                    if stager is not None:
                        stager.add(i, c.data)
            ids = []
            blocks = []
            for cids, cdata in zip(slot_ids, slot_data):
                ids.extend(cids)
                if cdata.shape[0]:
                    blocks.append(cdata)
        dim = dim or 1
        n = len(ids)
        if n != manifest.total_vectors:
            raise IncompleteSaveError(
                f"manifest promises {manifest.total_vectors} vectors, "
                f"chunks contain {n}"
            )

        idx = HybridIndex(dim, config, device=self.device)
        if deferred:
            # rows allocated (== save-order positions), data streamed below
            rows = (idx.store.register_rows(ids, timestamps)
                    if n else np.zeros(0, np.int32))
        else:
            # blocks copy straight into the pre-sized store — no corpus-
            # sized intermediate concat (first-touch faults dominate load)
            rows = (idx.store.add_blocks(ids, blocks, timestamps)
                    if n else np.zeros(0, np.int32))

        centroids = None
        if manifest.ivf_structure and manifest.ivf_structure.num_centroids:
            centroids = manifest.ivf_structure.centroids
            idx.ivf.set_trained(centroids)
            member = ivf_assign >= 0
            if member.any():
                idx.ivf._ensure_capacity()
                idx.ivf.assignments[rows[member]] = ivf_assign[member]
                idx.ivf._version += 1

        if manifest.extra.get("graph_saved"):
            graph = cbor.loads(self.store.get(f"{session_id}/hnsw_graph.cbor"))
            member_pos = np.asarray(graph.pop("member_pos"), np.int64)
            idx.hnsw.install_graph(rows[member_pos], graph)
        elif hnsw_member.any():
            idx.hnsw.insert_rows(rows[hnsw_member])  # rebuild fallback

        for vid in manifest.deleted_vectors or []:
            if idx.store.contains(vid):
                idx.store.mark_deleted(vid)
        idx.initialized = True
        if stager is not None and stager.rows == n:
            # publish the overlapped mirror AFTER every load-time version
            # bump so it stays valid for the first search
            stager.install(idx.store)

        if deferred and n:
            import threading

            # serve-before-resident: searches during materialization fetch
            # only the chunks their probe plan touches (index/cold.py) —
            # requires a layout-recording save (round-4+ format; older
            # saves simply block on wait_ready as before)
            layout = manifest.extra.get("layout")
            cold = None
            if layout:
                from ..index.cold import ColdServing

                cold = ColdServing(
                    idx, self.loader, keys, manifest.chunk_size,
                    layout.get("hnsw_span") or [0, 0],
                    layout.get("cluster_spans") or {}, n,
                    data_offsets=layout.get("data_offsets"),
                    dim=idx.store.dim,
                )
                idx.attach_cold(cold)

            event = threading.Event()
            idx.begin_materialize(event)
            loader = self.loader
            store = idx.store

            chunk_size = manifest.chunk_size
            serial = (cold is not None
                      and not getattr(self.store, "parallel_fetch", False))

            def _materialize() -> None:
                try:
                    lazy_stager = _maybe_stager(n, store.dim,
                                                store.torch_device)
                    if serial or range_fast:
                        # one chunk at a time in THIS thread: (a) yields the
                        # core to an on-demand search fetch between chunks,
                        # (b) skips chunks the search already filled, and
                        # (c) on a range-capable store reads each chunk's
                        # raw f32 block (no CBOR parse — decode dominated
                        # full loads at 1M). Order is row order, so a local
                        # disk streams sequentially; a parallel (network)
                        # store prefetches the next blocks through the
                        # loader pool while this one fills.
                        prefetch = {}
                        use_pool = (range_fast and not serial)
                        width = 4
                        next_submit = 0

                        def _top_up(lo: int) -> None:
                            # keep `width` fetches in flight past position
                            # lo, skipping search-filled chunks — popping a
                            # skipped chunk's future without a replacement
                            # collapsed the window to serial submit-then-
                            # wait after a skip burst
                            nonlocal next_submit
                            next_submit = max(next_submit, lo)
                            while (len(prefetch) < width
                                   and next_submit < len(keys)):
                                j = next_submit
                                next_submit += 1
                                if cold is not None and cold.is_filled(j):
                                    continue
                                prefetch[j] = loader._pool.submit(
                                    _chunk_block, j)

                        if use_pool:
                            _top_up(0)
                        for i in range(len(keys)):
                            if cold is not None:
                                cold.yield_to_searches()
                                if cold.is_filled(i):
                                    fut = prefetch.pop(i, None)
                                    if fut is not None:
                                        fut.cancel()  # not-started: no IO
                                    if use_pool:
                                        _top_up(i + 1)
                                    if lazy_stager is not None:
                                        lo = i * chunk_size
                                        hi = min(lo + chunk_size, n)
                                        lazy_stager.add(i, store.data[lo:hi])
                                    continue
                            if use_pool:
                                fut = prefetch.pop(
                                    i, None) or loader._pool.submit(
                                    _chunk_block, i)
                                _top_up(i + 1)
                                block = fut.result()
                            else:
                                block = _chunk_block(i)
                            store.fill_rows(i * chunk_size, block)
                            if cold is not None:
                                cold.mark_filled(i)
                            if lazy_stager is not None and block.shape[0]:
                                lazy_stager.add(i, block)
                    else:
                        # completion-order streaming through the loader
                        # pool: each chunk fills its recorded row range
                        # (start_idx == save-order row) and stages its
                        # device transfer immediately
                        for i, chunk in loader.load_chunks_iter(keys):
                            store.fill_rows(chunk.start_idx, chunk.data)
                            if cold is not None:
                                cold.mark_filled(i)
                            if lazy_stager is not None and chunk.data.shape[0]:
                                lazy_stager.add(i, chunk.data)
                    store.bump_version()
                    if lazy_stager is not None and lazy_stager.rows == n:
                        # first search after wait_ready() pays no corpus
                        # upload (same overlap as the eager path)
                        lazy_stager.install(store)
                except Exception as e:  # noqa: BLE001 - surfaced on wait_ready
                    idx._load_error = e
                finally:
                    event.set()

            threading.Thread(
                target=_materialize, name="fvdb-materialize", daemon=True
            ).start()
        return idx, manifest

    # ------------------------------------------------------------- integrity
    def check_integrity(self, session_id: str) -> RecoveryInfo:
        manifest = self.load_manifest(session_id)
        missing = [
            c.chunk_id
            for c in manifest.chunks
            if not self.store.exists(f"{session_id}/chunks/{c.chunk_id}.cbor")
        ]
        return RecoveryInfo(
            expected_chunks=manifest.num_chunks,
            found_chunks=manifest.num_chunks - len(missing),
            missing_chunks=missing,
        )

    # ---------------------------------------------------------------- backup
    def _session_keys(self, session_id: str) -> list:
        manifest = self.load_manifest(session_id)
        keys = [f"{session_id}/manifest.json", f"{session_id}/state.cbor"]
        if manifest.extra.get("graph_saved"):
            keys.append(f"{session_id}/hnsw_graph.cbor")
        keys += [f"{session_id}/chunks/{c.chunk_id}.cbor" for c in manifest.chunks]
        return keys

    def save_with_backup(self, index: HybridIndex, session_id: str,
                         chunk_size: int = 10_000) -> Manifest:
        """Back up the current save (if any) under backup/, then save."""
        try:
            self.backup(session_id)
        except PersistenceError:
            pass  # nothing to back up yet
        return self.save_index_chunked(index, session_id, chunk_size)

    def backup(self, session_id: str, prefix: str = "backup",
               compress: bool = False) -> list:
        """Copy the session's save under ``prefix/`` (optionally zstd-
        compressed — the reference's BackupBuilder carries backup_path +
        compress flags, client/rust.rs:224-264)."""
        import json as _json

        keys = self._session_keys(session_id)
        for key in keys:
            data = self.store.get(key)
            if compress:
                data = cbor.compress_zstd(data)
            self.store.put(f"{prefix}/{key}", data)
        self.store.put(
            f"{prefix}/{session_id}/backup_meta.json",
            _json.dumps({"compress": compress}).encode(),
        )
        return keys

    def restore_from_backup(self, session_id: str,
                            prefix: str = "backup") -> None:
        import json as _json

        compress = False
        try:
            meta = _json.loads(
                self.store.get(f"{prefix}/{session_id}/backup_meta.json")
            )
            compress = bool(meta.get("compress"))
        except Exception:
            pass

        def fetch(key: str) -> bytes:
            data = self.store.get(f"{prefix}/{key}")
            return cbor.decompress_zstd(data) if compress else data

        try:
            raw = fetch(f"{session_id}/manifest.json")
        except NotFoundError:
            raise PersistenceError(f"no backup for session {session_id!r}") from None
        manifest = Manifest.from_json(raw.decode("utf-8"))
        keys = [f"{session_id}/manifest.json", f"{session_id}/state.cbor"]
        if manifest.extra.get("graph_saved"):
            keys.append(f"{session_id}/hnsw_graph.cbor")
        keys += [f"{session_id}/chunks/{c.chunk_id}.cbor" for c in manifest.chunks]
        for key in keys:
            self.store.put(key, fetch(key))
        self.loader.cache.clear()


# ---------------------------------------------------------------------------
# Per-engine persisters (standalone engines over their own stores)
# ---------------------------------------------------------------------------


class HNSWPersister:
    """metadata.cbor + node data chunked 1000/file under nodes/
    (reference: src/hnsw/persistence.rs:77-185)."""

    NODES_PER_CHUNK = 1000

    def __init__(self, store: ObjectStore, device=None):
        self.store = store
        self.device = device

    def save_index(self, index: HNSWIndex, path: str,
                   incremental: bool = False) -> None:
        s = index.store
        order = index.member_rows()
        order = order[np.array([s.row_to_id[r] is not None for r in order], bool)] \
            if order.size else order
        ids = [s.row_to_id[r] for r in order]
        graph = index.export_graph(order)
        n = order.size
        n_chunks = (n + self.NODES_PER_CHUNK - 1) // self.NODES_PER_CHUNK

        prev_hashes: dict = {}
        prev_n_chunks = 0
        try:
            prev = cbor.loads(self.store.get(f"{path}/metadata.cbor"))
            prev_n_chunks = int(prev.get("n_chunks", 0))
            if incremental:
                prev_hashes = dict(prev.get("chunk_hashes") or {})
        except Exception:
            pass

        chunk_hashes: dict = {}
        for ci in range(n_chunks):
            lo = ci * self.NODES_PER_CHUNK
            hi = min(lo + self.NODES_PER_CHUNK, n)
            payload = cbor.dumps({
                "ids": ids[lo:hi],
                "vectors": s.data[order[lo:hi]],
                "timestamps": s.timestamps[order[lo:hi]],
            })
            name = f"chunk_{ci:04d}"
            h = _sha(payload)
            chunk_hashes[name] = h
            key = f"{path}/nodes/{name}.cbor"
            if prev_hashes.get(name) == h and self.store.exists(key):
                continue  # dirty-node incremental: unchanged chunk kept as-is
            self.store.put(key, payload)

        meta = {
            "format_version": FORMAT_VERSION,
            "dim": s.dim,
            "count": int(n),
            "n_chunks": int(n_chunks),
            "entry_pos": graph["entry_pos"],
            "max_level": graph["max_level"],
            "m": index.config.m,
            "m0": index.config.m0,
            "ef_construction": index.config.ef_construction,
            "deleted_ids": [
                s.row_to_id[r]
                for r in order[s.deleted[order]]
            ],
            "chunk_hashes": chunk_hashes,
        }
        self.store.put(f"{path}/metadata.cbor", cbor.dumps(meta))
        self.store.put(f"{path}/graph.cbor", cbor.dumps(graph))
        # shrinking saves (post-vacuum) must not leave phantom node chunks
        for ci in range(n_chunks, prev_n_chunks):
            try:
                self.store.delete(f"{path}/nodes/chunk_{ci:04d}.cbor")
            except Exception:
                pass

    def save_incremental(self, index: HNSWIndex, path: str) -> None:
        """Rewrite only node chunks whose content changed since the last save
        (reference dirty-node incremental save: hnsw/persistence.rs:187-240).
        metadata.cbor and graph.cbor are always rewritten — the graph mutates
        on any insert."""
        self.save_index(index, path, incremental=True)

    # ---------------------------------------------------------------- backup
    def _keys(self, path: str) -> list:
        meta = cbor.loads(self.store.get(f"{path}/metadata.cbor"))
        keys = [f"{path}/metadata.cbor", f"{path}/graph.cbor"]
        keys += [
            f"{path}/nodes/chunk_{ci:04d}.cbor"
            for ci in range(int(meta["n_chunks"]))
        ]
        return keys

    def save_with_backup(self, index: HNSWIndex, path: str) -> None:
        """Back up the current save (if any) under backup/, then save
        (reference: hnsw/persistence.rs:242-305)."""
        try:
            for key in self._keys(path):
                self.store.put(f"backup/{key}", self.store.get(key))
        except (NotFoundError, PersistenceError):
            pass  # nothing saved yet
        self.save_index(index, path)

    def restore_from_backup(self, path: str) -> None:
        try:
            meta_raw = self.store.get(f"backup/{path}/metadata.cbor")
        except NotFoundError:
            raise PersistenceError(f"no backup for {path!r}") from None
        meta = cbor.loads(meta_raw)
        keys = [f"{path}/metadata.cbor", f"{path}/graph.cbor"]
        keys += [
            f"{path}/nodes/chunk_{ci:04d}.cbor"
            for ci in range(int(meta["n_chunks"]))
        ]
        for key in keys:
            self.store.put(key, self.store.get(f"backup/{key}"))

    def load_index(self, path: str, config: HNSWConfig | None = None):
        """Returns (VectorStore, HNSWIndex)."""
        try:
            meta = cbor.loads(self.store.get(f"{path}/metadata.cbor"))
        except NotFoundError:
            raise PersistenceError(f"no HNSW index at {path!r}") from None
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise PersistenceError("unsupported format version")
        ids: list = []
        vecs = []
        ts = []
        for ci in range(int(meta["n_chunks"])):
            key = f"{path}/nodes/chunk_{ci:04d}.cbor"
            try:
                payload = cbor.loads(self.store.get(key))
            except NotFoundError:
                raise IncompleteSaveError(f"missing node chunk {key}") from None
            ids.extend(payload["ids"])
            vecs.append(np.asarray(payload["vectors"], np.float32))
            ts.append(np.asarray(payload["timestamps"], np.float64))
        if len(ids) != int(meta["count"]):
            raise IncompleteSaveError(
                f"expected {meta['count']} nodes, found {len(ids)}"
            )
        store = VectorStore(int(meta["dim"]), device=self.device)
        cfg = config or HNSWConfig(
            m=int(meta["m"]), m0=int(meta["m0"]),
            ef_construction=int(meta["ef_construction"]),
        )
        index = HNSWIndex(store, cfg)
        if ids:
            rows = store.add_batch(ids, np.concatenate(vecs), np.concatenate(ts))
            graph = cbor.loads(self.store.get(f"{path}/graph.cbor"))
            index.install_graph(rows, graph)
        for vid in meta.get("deleted_ids") or []:
            if store.contains(vid):
                store.mark_deleted(vid)
        return store, index

    def check_integrity(self, path: str) -> RecoveryInfo:
        meta = cbor.loads(self.store.get(f"{path}/metadata.cbor"))
        n_chunks = int(meta["n_chunks"])
        missing = [
            f"chunk_{ci:04d}"
            for ci in range(n_chunks)
            if not self.store.exists(f"{path}/nodes/chunk_{ci:04d}.cbor")
        ]
        return RecoveryInfo(n_chunks, n_chunks - len(missing), missing)


class IVFPersister:
    """metadata.cbor + centroids.cbor + per-cluster inverted list files with
    optional zstd (reference: src/ivf/persistence.rs:101-265)."""

    def __init__(self, store: ObjectStore, compress: bool = False,
                 device=None):
        self.store = store
        self.compress = compress
        self.device = device

    def _encode(self, obj) -> bytes:
        raw = cbor.dumps(obj)
        return cbor.compress_zstd(raw) if self.compress else raw

    def _decode(self, raw: bytes):
        return cbor.loads(cbor.decompress_zstd(raw))

    def save_index(self, index: IVFIndex, path: str) -> None:
        if not index.trained:
            raise PersistenceError("cannot save untrained IVF index")
        s = index.store
        c = index.centroids.shape[0]
        members = index.member_rows()
        members = members[
            np.array([s.row_to_id[r] is not None for r in members], bool)
        ] if members.size else members
        meta = {
            "format_version": FORMAT_VERSION,
            "dim": s.dim,
            "n_clusters": int(c),
            "n_probe": index.config.n_probe,
            "total_vectors": int(members.size),
            "compressed": self.compress,
            "deleted_ids": [s.row_to_id[r] for r in members[s.deleted[members]]],
        }
        self.store.put(f"{path}/metadata.cbor", cbor.dumps(meta))
        self.store.put(
            f"{path}/centroids.cbor", cbor.dumps(index.centroids)
        )
        assign = index.assignments[members]
        for ci in range(c):
            rows = members[assign == ci]
            payload = {
                "ids": [s.row_to_id[r] for r in rows],
                "vectors": s.data[rows],
                "timestamps": s.timestamps[rows],
            }
            self.store.put(
                f"{path}/inverted_lists/cluster_{ci:06d}.cbor",
                self._encode(payload),
            )

    def save_incremental(self, index: IVFIndex, path: str,
                         modified_clusters: list) -> None:
        """Rewrite the given clusters AND metadata.cbor (the reference
        re-serializes IVFMetadata first, ivf/persistence.rs:267-297) so the
        on-store total_vectors / deleted_ids stay consistent with the lists
        and a later load doesn't fail IncompleteSaveError."""
        s = index.store
        members = index.member_rows()
        members = members[
            np.array([s.row_to_id[r] is not None for r in members], bool)
        ] if members.size else members
        meta = {
            "format_version": FORMAT_VERSION,
            "dim": s.dim,
            "n_clusters": int(index.centroids.shape[0]),
            "n_probe": index.config.n_probe,
            "total_vectors": int(members.size),
            "compressed": self.compress,
            "deleted_ids": [s.row_to_id[r] for r in members[s.deleted[members]]],
        }
        self.store.put(f"{path}/metadata.cbor", cbor.dumps(meta))
        assign = index.assignments[members]
        for ci in modified_clusters:
            rows = members[assign == ci]
            payload = {
                "ids": [s.row_to_id[r] for r in rows],
                "vectors": s.data[rows],
                "timestamps": s.timestamps[rows],
            }
            self.store.put(
                f"{path}/inverted_lists/cluster_{ci:06d}.cbor",
                self._encode(payload),
            )

    def load_index(self, path: str, config: IVFConfig | None = None):
        """Returns (VectorStore, IVFIndex)."""
        try:
            meta = cbor.loads(self.store.get(f"{path}/metadata.cbor"))
        except NotFoundError:
            raise PersistenceError(f"no IVF index at {path!r}") from None
        centroids = np.asarray(
            cbor.loads(self.store.get(f"{path}/centroids.cbor")), np.float32
        )
        c = int(meta["n_clusters"])
        store = VectorStore(int(meta["dim"]), device=self.device)
        cfg = config or IVFConfig(n_clusters=c, n_probe=int(meta["n_probe"]))
        index = IVFIndex(store, cfg)
        index.set_trained(centroids)
        total = 0
        for ci in range(c):
            key = f"{path}/inverted_lists/cluster_{ci:06d}.cbor"
            try:
                payload = self._decode(self.store.get(key))
            except NotFoundError:
                raise IncompleteSaveError(f"missing cluster file {key}") from None
            ids = payload["ids"]
            if not ids:
                continue
            rows = store.add_batch(
                ids,
                np.asarray(payload["vectors"], np.float32),
                np.asarray(payload["timestamps"], np.float64),
            )
            index._ensure_capacity()
            index.assignments[rows] = ci
            total += len(ids)
        index._version += 1
        if total != int(meta["total_vectors"]):
            raise IncompleteSaveError(
                f"expected {meta['total_vectors']} vectors, loaded {total}"
            )
        for vid in meta.get("deleted_ids") or []:
            if store.contains(vid):
                store.mark_deleted(vid)
        return store, index

    def check_integrity(self, path: str) -> RecoveryInfo:
        meta = cbor.loads(self.store.get(f"{path}/metadata.cbor"))
        c = int(meta["n_clusters"])
        missing = [
            f"cluster_{ci:06d}"
            for ci in range(c)
            if not self.store.exists(f"{path}/inverted_lists/cluster_{ci:06d}.cbor")
        ]
        return RecoveryInfo(c, c - len(missing), missing)

    def migrate_index(self, path: str, new_config: IVFConfig,
                      out_path: str | None = None) -> None:
        """load -> retrain under new config (on the persister's device) ->
        save (reference: ivf/persistence.rs:351-395)."""
        store, index = self.load_index(path)
        index.retrain(new_config)
        self.save_index(index, out_path or path)
