"""VectorDBSession on the port: the SDK surface of the JAX package's
``api/session.py`` over the PyTorch HybridIndex.

Same validation, error codes, id hashing, metadata wrapping, filters
(columnar bitmask pushdown or oversampled post-filter), scores
(1 / (1 + distance)), deletes, schema, stats, vacuum and persistence
(``save_to_s5`` / ``load_user_vectors``: the chunked save, eager or lazy
loads, the sharded metadata map, the schema). ``create`` takes the object
store as there (None: the storage factory's, from the environment) and
``device=None``, which means the card; without one it raises, and a caller
that wants the CPU passes ``device="cpu"``. The REST server is not ported
yet.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .. import cbor
from ..core.columnar import ColumnarMetadata
from ..core.metadata_filter import FilterError, MetadataFilter
from ..core.object_store import NotFoundError, ObjectStore
from ..core.schema import MetadataSchema, SchemaError
from ..core.types import VectorId, distance_to_score
from ..index.hybrid import HybridConfig, HybridIndex
from ..index.store import DuplicateIdError
from ..storage.factory import StorageFactory, validate_seed_phrase
from ..storage.persistence import HybridPersister
from ..utils.device import resolve_device
from ..utils.padding import fit_mask
from ..utils.tracing import PerfMonitor

# error codes (parity: bindings/node/src/error.rs:9-51)
S5_ERROR = "S5_ERROR"
STORAGE_ERROR = "STORAGE_ERROR"
INDEX_ERROR = "INDEX_ERROR"
INVALID_CONFIG = "INVALID_CONFIG"
SESSION_ERROR = "SESSION_ERROR"
INVALID_INPUT = "INVALID_INPUT"
INVALID_DATA = "INVALID_DATA"


class VectorDBError(Exception):
    def __init__(self, message: str, code: str = SESSION_ERROR):
        super().__init__(message)
        self.message = message
        self.code = code


@dataclass
class VectorDBConfig:
    session_id: str
    s5_portal: str = "http://localhost:5522"
    user_seed_phrase: str = ""
    memory_budget_mb: int = 512
    debug: bool = False
    encrypt_at_rest: bool = True
    chunk_size: int = 10_000
    cache_size_mb: int = 150
    storage_mode: str | None = None  # mock | fs | real; None -> env
    fs_root: str | None = None
    hybrid: HybridConfig | None = None

    @classmethod
    def from_json(cls, obj: dict) -> "VectorDBConfig":
        return cls(
            session_id=obj.get("sessionId", ""),
            s5_portal=obj.get("s5Portal", "http://localhost:5522"),
            user_seed_phrase=obj.get("userSeedPhrase", ""),
            memory_budget_mb=int(obj.get("memoryBudgetMb", 512)),
            debug=bool(obj.get("debug", False)),
            encrypt_at_rest=bool(obj.get("encryptAtRest", True)),
            chunk_size=int(obj.get("chunkSize", 10_000)),
            cache_size_mb=int(obj.get("cacheSizeMb", 150)),
            storage_mode=obj.get("storageMode"),
            fs_root=obj.get("fsRoot"),
        )


@dataclass
class SearchOptions:
    threshold: float = 0.0
    include_vectors: bool = False
    filter: Any = None


@dataclass
class LoadOptions:
    lazy_load: bool = True
    memory_budget_mb: int | None = None


@dataclass
class SessionStats:
    vector_count: int
    memory_usage_mb: float
    index_type: str
    hnsw_vector_count: int
    ivf_vector_count: int
    hnsw_deleted_count: int
    ivf_deleted_count: int
    total_deleted_count: int

    def to_json(self) -> dict:
        return {
            "vectorCount": self.vector_count,
            "memoryUsageMb": self.memory_usage_mb,
            "indexType": self.index_type,
            "hnswVectorCount": self.hnsw_vector_count,
            "ivfVectorCount": self.ivf_vector_count,
            "hnswDeletedCount": self.hnsw_deleted_count,
            "ivfDeletedCount": self.ivf_deleted_count,
            "totalDeletedCount": self.total_deleted_count,
        }


@dataclass
class DeleteResult:
    deleted_count: int
    deleted_ids: list = field(default_factory=list)

    def to_json(self) -> dict:
        return {"deletedCount": self.deleted_count, "deletedIds": self.deleted_ids}


@dataclass
class VacuumStats:
    hnsw_removed: int
    ivf_removed: int
    total_removed: int

    def to_json(self) -> dict:
        return {
            "hnswRemoved": self.hnsw_removed,
            "ivfRemoved": self.ivf_removed,
            "totalRemoved": self.total_removed,
        }


IVF_TRAINING_BATCH = 10  # first N vectors train IVF (session.rs:365-378)


class VectorDBSession:
    """In-process session over a HybridIndex on one device and an
    ObjectStore."""

    def __init__(self, config: VectorDBConfig,
                 store: ObjectStore | None = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.object_store = store
        self.index: HybridIndex | None = None
        self.dim: int | None = None
        self.metadata_map: dict[str, Any] = {}  # internal id -> metadata
        self.schema: MetadataSchema | None = None
        self.destroyed = False
        self.monitor = PerfMonitor()
        self._persister = HybridPersister(store, device=self.device) \
            if store is not None else None
        # columnar projection of metadata for vectorized filter bitmasks
        # (row-aligned with index.store), plus a per-(filter, epoch) cache
        self.columnar = ColumnarMetadata()
        self._mask_cache: dict[str, tuple] = {}  # filter key -> (epoch, mask)

    # --------------------------------------------------------------- create
    @classmethod
    def create(cls, config: VectorDBConfig | dict,
               store: ObjectStore | None = None,
               device=None) -> "VectorDBSession":
        """Validate the config and open a session over ``store`` (None: the
        storage factory's for the configured mode) on ``device`` (None: the
        card; raises when there is none)."""
        if isinstance(config, dict):
            config = VectorDBConfig.from_json(config)
        if not config.session_id:
            raise VectorDBError("sessionId is required", INVALID_CONFIG)
        if config.chunk_size <= 0:
            raise VectorDBError("chunkSize must be positive", INVALID_CONFIG)
        if config.cache_size_mb <= 0:
            raise VectorDBError("cacheSizeMb must be positive", INVALID_CONFIG)
        mode = config.storage_mode or StorageFactory.config_from_env().mode
        if mode == "real":
            if not config.s5_portal:
                raise VectorDBError("s5Portal is required", INVALID_CONFIG)
            if not config.user_seed_phrase:
                raise VectorDBError("userSeedPhrase is required",
                                    INVALID_CONFIG)
            try:
                validate_seed_phrase(config.user_seed_phrase)
            except Exception as e:
                raise VectorDBError(str(e), INVALID_CONFIG) from e
        if store is None:
            scfg = StorageFactory.config_from_env()
            scfg.mode = mode
            scfg.portal_url = config.s5_portal or scfg.portal_url
            scfg.encrypt_at_rest = config.encrypt_at_rest
            scfg.seed_phrase = config.user_seed_phrase or scfg.seed_phrase
            if config.fs_root:
                scfg.fs_root = config.fs_root
            store = StorageFactory.create(scfg)
        return cls(config, store, device)

    def _check_alive(self) -> None:
        if self.destroyed:
            raise VectorDBError("session has been destroyed", SESSION_ERROR)

    # ---------------------------------------------------------------- ingest
    def add_vectors(self, vectors: list) -> None:
        """vectors: [{"id": str, "vector": [float], "metadata": any}, ...]"""
        self._check_alive()
        if not vectors:
            return
        ids, vecs, metas = [], [], []
        for v in vectors:
            if not isinstance(v, dict):
                raise VectorDBError(
                    "each vector entry must be an object with id/vector",
                    INVALID_INPUT)
            vid = v.get("id")
            emb = v.get("vector")
            if not vid or not isinstance(vid, str):
                raise VectorDBError("vector id must be a non-empty string",
                                    INVALID_INPUT)
            if emb is None or not hasattr(emb, "__len__") or len(emb) == 0:
                raise VectorDBError(f"vector for {vid!r} is empty or not a "
                                    "list", INVALID_INPUT)
            try:
                arr_v = np.asarray(emb, np.float32)
            except (TypeError, ValueError) as e:
                raise VectorDBError(
                    f"vector for {vid!r} contains non-numeric values",
                    INVALID_INPUT) from e
            if arr_v.ndim != 1 or not np.isfinite(arr_v).all():
                # a NaN/Inf row silently poisons every distance it touches
                raise VectorDBError(
                    f"vector for {vid!r} must be a flat list of finite "
                    "numbers", INVALID_INPUT)
            ids.append(vid)
            vecs.append(arr_v)
            metas.append(v.get("metadata"))

        if len(set(ids)) != len(ids):
            raise VectorDBError("duplicate ids within batch", INVALID_INPUT)

        # dimension capture / enforcement
        dims = {v.shape[0] for v in vecs}
        if len(dims) != 1:
            raise VectorDBError(f"inconsistent vector dimensions {sorted(dims)}",
                                INVALID_INPUT)
        d = int(dims.pop())
        if self.dim is not None and d != self.dim:
            raise VectorDBError(
                f"vector dimension {d} does not match index dimension {self.dim}",
                INVALID_INPUT,
            )
        arr = np.stack(vecs)

        # schema validation BEFORE creating or mutating the index: a
        # rejected first batch must not leave a permanently-initialized
        # empty index with a pinned dimension
        if self.schema is not None:
            for vid, meta in zip(ids, metas):
                try:
                    self.schema.validate(self._unwrap_user(meta))
                except SchemaError as e:
                    raise VectorDBError(
                        f"schema validation failed for {vid!r}: {e}", INVALID_DATA
                    ) from e

        # lazy first-batch init: first IVF_TRAINING_BATCH vectors train IVF.
        # Dimension pinning happens HERE, after all validation — a rejected
        # batch must not pin the session's dimension
        created_here = self.index is None
        if created_here:
            self.dim = d
            self.index = HybridIndex(self.dim, self.config.hybrid,
                                     device=self.device)
            self.index.initialize(arr[:IVF_TRAINING_BATCH])

        internal = [self._internal_id(vid) for vid in ids]
        try:
            rows = self.index.insert_batch(internal, arr)
        except DuplicateIdError as e:
            if created_here and self.index.store.count == 0:
                # roll the failed first batch back entirely
                self.index = None
                self.dim = None
            raise VectorDBError(str(e), INVALID_INPUT) from e

        for vid, iid, meta, row in zip(ids, internal, metas, rows):
            self.metadata_map[iid] = self._wrap_metadata(vid, meta)
            self.columnar.set_row(int(row), self._filterable_view(
                self.metadata_map[iid]))

    @staticmethod
    def _internal_id(user_id: str) -> str:
        # content-hash internal ids keyed by the FULL 32-byte digest (parity
        # with blake3 VectorId, core/types.rs:19-22 — there the truncated
        # vec_<8hex> form is display-only); originals preserved via
        # _originalId.  Truncating to 32 bits would make birthday collisions
        # near-certain at the advertised 1M-vector scale.
        return "vec_" + VectorId.from_string(user_id).to_hex()

    @staticmethod
    def _wrap_metadata(user_id: str, meta: Any) -> dict:
        if isinstance(meta, dict):
            out = dict(meta)
            out["_originalId"] = user_id
            return out
        # non-object metadata gets wrapped so _originalId fits alongside
        return {"_originalId": user_id, "_userMetadata": meta}

    @staticmethod
    def _unwrap_user(meta: Any) -> Any:
        if isinstance(meta, dict) and "_userMetadata" in meta:
            return meta["_userMetadata"]
        return meta

    def _user_metadata(self, internal_id: str):
        meta = self.metadata_map.get(internal_id)
        if meta is None:
            return {}
        out = dict(meta) if isinstance(meta, dict) else meta
        if isinstance(out, dict):
            out.pop("_originalId", None)
            if "_userMetadata" in out:
                return out["_userMetadata"]
        return out

    def _original_id(self, internal_id: str) -> str:
        meta = self.metadata_map.get(internal_id)
        if isinstance(meta, dict) and isinstance(meta.get("_originalId"), str):
            return meta["_originalId"]
        return internal_id

    def _resolve(self, user_id: str) -> str:
        """user id -> internal id; raises if unknown or soft-deleted (the
        reference's delete removes the id from its vector map, so a deleted
        vector reads as gone, rest.rs:572-597)."""
        iid = self._internal_id(user_id)
        if (self.index is not None and self.index.contains(iid)
                and not self.index.store.is_deleted(iid)):
            return iid
        raise VectorDBError(f"vector {user_id!r} not found", INVALID_INPUT)

    # ---------------------------------------------------------------- search
    @staticmethod
    def _validate_k(k) -> None:
        if not isinstance(k, (int, np.integer)) or isinstance(k, bool) \
                or k < 1 or k > 16_384:
            raise VectorDBError(
                f"k must be an integer in [1, 16384], got {k!r}",
                INVALID_INPUT)

    @staticmethod
    def _parse_filter(filter_json) -> "MetadataFilter":
        try:
            return MetadataFilter.from_json(filter_json)
        except FilterError as e:
            raise VectorDBError(f"invalid filter: {e}", INVALID_INPUT) from e

    def _validate_query(self, query_vector, batched: bool = False):
        """Typed validation of a query (or [B, D] batch). The dimension
        check applies only once the session has a pinned dimension."""
        try:
            q = np.asarray(query_vector, np.float32)
            if batched:
                q = np.atleast_2d(q)
        except (TypeError, ValueError) as e:
            raise VectorDBError("query vector contains non-numeric values",
                                INVALID_INPUT) from e
        if not np.isfinite(q).all():
            raise VectorDBError("query vector must contain finite numbers",
                                INVALID_INPUT)
        want_ndim = 2 if batched else 1
        if q.ndim != want_ndim or (
                self.dim is not None and q.shape[-1] != self.dim):
            raise VectorDBError(
                f"query dimension {q.shape} does not match index "
                f"dimension {self.dim}", INVALID_INPUT,
            )
        return q

    def search(self, query_vector, k: int, options: SearchOptions | dict | None = None) -> list:
        self._check_alive()
        if isinstance(options, dict):
            options = SearchOptions(
                threshold=float(options.get("threshold", 0.0)),
                include_vectors=bool(options.get("includeVectors", False)),
                filter=options.get("filter"),
            )
        options = options or SearchOptions()
        self._validate_k(k)
        # validate query + filter BEFORE the empty-index early return: the
        # error surface must not flip from silent-[] to INVALID_INPUT on
        # the session's first insert
        q = self._validate_query(query_vector)
        flt = (self._parse_filter(options.filter)
               if options.filter is not None else None)
        if self.index is None:
            return []
        t0 = time.perf_counter()
        if flt is not None:
            mask = self._filter_mask(options.filter, flt)
            if mask is not None:
                pairs = self.index.search_with_filter(q, k, flt, row_mask=mask)
            else:
                # non-lowerable predicate: the reference's oversample +
                # post-filter — O(k) matches() calls, never O(N)
                pairs = self.index.search_oversampled_post_filter(
                    q, k, self._row_predicate(flt)
                )
        else:
            pairs = self.index.search(q, k)
        out = []
        for iid, dist in pairs:
            score = distance_to_score(dist)
            if score < options.threshold:
                continue
            item = {
                "id": self._original_id(iid),
                "score": score,
                "metadata": self._user_metadata(iid),
            }
            if options.include_vectors:
                item["vector"] = [float(x) for x in self.index.get_vector(iid)]
            out.append(item)
        self.monitor.record((time.perf_counter() - t0) * 1000.0, len(out))
        return out

    def search_batch(self, queries, k: int, filter_json: Any = None) -> list:
        """Batched search: ONE device dispatch for B queries (the micro-
        batching entry the REST coalescer uses). Returns a list of per-query
        result lists shaped like :meth:`search` items, WITHOUT threshold /
        include_vectors applied (the caller post-applies per-request options).
        """
        return self.search_batch_dispatch(queries, k, filter_json)()

    def search_batch_dispatch(self, queries, k: int, filter_json: Any = None):
        """Dispatch half of :meth:`search_batch`: enqueue the device program
        and return a zero-arg ``finalize() -> list``. The coalescer dispatches
        the next coalesced batch before finalizing the previous one, so
        consecutive batches overlap the device round-trip instead of paying
        it serially (pipelined serving).
        """
        self._check_alive()
        self._validate_k(k)
        q = self._validate_query(queries, batched=True)
        flt = (self._parse_filter(filter_json)
               if filter_json is not None else None)
        if self.index is None:
            return lambda: [[] for _ in range(len(queries))]
        # capture the index for the closures below: the coalescer
        # deliberately interleaves other session ops (e.g. /session/load
        # swapping self.index) between dispatch and finalize — row indices
        # from THIS device program must map through THIS store
        idx = self.index
        n_real = q.shape[0]
        t0 = time.perf_counter()
        if flt is None:
            fin = idx.search_rows_dispatch(q, k)

            def per_query_fn():
                d, rows = fin()
                return [
                    idx._rows_to_results(d[i], rows[i])
                    for i in range(n_real)
                ]
        else:
            mask = self._filter_mask(filter_json, flt)
            if mask is not None:
                full = fit_mask(np.asarray(mask, bool), idx.store.capacity)
                fin = idx.search_rows_dispatch(q, k * 3, extra_mask=full)

                def per_query_fn():
                    d, rows = fin()
                    per_query = []
                    for i in range(n_real):
                        # enforce on the ROW array from the search snapshot
                        # (id->row re-resolution races vacuum / reinsert)
                        keep = (rows[i] >= 0) & full[np.maximum(rows[i], 0)]
                        di = np.where(keep, d[i], np.inf)
                        ri = np.where(keep, rows[i], -1)
                        per_query.append(
                            idx._rows_to_results(di, ri)[:k])
                    return per_query
            else:
                pred = self._row_predicate(flt)
                fin = idx.search_rows_dispatch(q, k * 3)

                def per_query_fn():
                    d, rows = fin()
                    return [
                        [(vid, dist)
                         for vid, dist in
                         idx._rows_to_results(d[i], rows[i])
                         if pred(vid)][:k]
                        for i in range(n_real)
                    ]

        # the metadata map object is swapped (not mutated) by session load;
        # capture it so finalize resolves ids against the dispatched state
        mmap = self.metadata_map

        def _orig_id(iid: str) -> str:
            meta = mmap.get(iid)
            if isinstance(meta, dict) and "_originalId" in meta:
                return meta["_originalId"]
            return iid

        def _user_meta(iid: str):
            meta = mmap.get(iid)
            if meta is None:
                return {}
            out = dict(meta) if isinstance(meta, dict) else meta
            if isinstance(out, dict):
                out.pop("_originalId", None)
                if "_userMetadata" in out:
                    return out["_userMetadata"]
            return out

        def finalize() -> list:
            per_query = per_query_fn()
            elapsed = (time.perf_counter() - t0) * 1000.0
            out = []
            for pairs in per_query:
                items = [
                    {
                        "id": _orig_id(iid),
                        "score": distance_to_score(dist),
                        "metadata": _user_meta(iid),
                        "_iid": iid,
                    }
                    for iid, dist in pairs
                ]
                out.append(items)
                self.monitor.record(elapsed, len(items))
            return out

        return finalize

    def _filter_mask(self, filter_json: Any, flt: MetadataFilter):
        """Row bitmask for a filter via the columnar index, cached per
        (filter, mutation epoch). None when the filter isn't lowerable."""
        try:
            key = json.dumps(filter_json, sort_keys=True, default=repr)
        except Exception:  # noqa: BLE001 - unhashable filter: skip the cache
            key = None
        epoch = self.columnar.epoch
        if key is not None:
            hit = self._mask_cache.get(key)
            if hit is not None and hit[0] == epoch:
                return hit[1]
        mask = self.columnar.mask(flt, self.index.store.count)
        if key is not None and mask is not None:
            if len(self._mask_cache) >= 128:
                self._mask_cache.pop(next(iter(self._mask_cache)))
            self._mask_cache[key] = (epoch, mask)
        return mask

    def _row_predicate(self, flt: MetadataFilter):
        def pred(iid: str) -> bool:
            meta = self._filterable_view(self.metadata_map.get(iid))
            return flt.matches(meta if meta is not None else {})
        return pred

    @staticmethod
    def _filterable_view(meta: Any):
        """Filters see user metadata fields (unwrapped), like the reference,
        which filters on the stored metadata object."""
        if isinstance(meta, dict) and "_userMetadata" in meta:
            return meta["_userMetadata"] if isinstance(meta["_userMetadata"], dict) else None
        return meta if isinstance(meta, dict) else None

    # ------------------------------------------------------------------ CRUD
    def delete_vector(self, user_id: str) -> None:
        self._check_alive()
        iid = self._resolve(user_id)
        if not self.index.delete(iid):
            raise VectorDBError(f"vector {user_id!r} already deleted", INVALID_INPUT)

    def delete_by_metadata(self, filter_obj: Any) -> DeleteResult:
        """Delete all vectors whose metadata matches (equality/array/dot
        semantics via the full filter language)."""
        self._check_alive()
        flt = self._parse_filter(filter_obj)
        if self.index is None:
            return DeleteResult(0, [])
        deleted = []
        s = self.index.store
        mask = self._filter_mask(filter_obj, flt)
        if mask is not None:
            # vectorized candidate selection via the columnar index
            live = ~s.deleted[: len(mask)]
            for row in np.nonzero(mask & live[: len(mask)])[0]:
                iid = s.row_to_id[row]
                if iid is not None and self.index.delete(iid):
                    deleted.append(self._original_id(iid))
            return DeleteResult(len(deleted), deleted)
        for iid, meta in list(self.metadata_map.items()):
            if not self.index.contains(iid) or self.index.store.is_deleted(iid):
                continue
            if flt.matches(self._filterable_view(meta) or {}):
                if self.index.delete(iid):
                    deleted.append(self._original_id(iid))
        return DeleteResult(len(deleted), deleted)

    def update_metadata(self, user_id: str, metadata: Any) -> None:
        """Replace metadata entirely (no merge); _originalId preserved."""
        self._check_alive()
        iid = self._resolve(user_id)
        if self.schema is not None:
            try:
                self.schema.validate(metadata)
            except SchemaError as e:
                raise VectorDBError(str(e), INVALID_DATA) from e
        self.metadata_map[iid] = self._wrap_metadata(user_id, metadata)
        self.columnar.set_row(
            self.index.store.row_of(iid),
            self._filterable_view(self.metadata_map[iid]),
        )

    def _rebuild_columnar(self) -> None:
        """Re-project every row's metadata (load / bulk-replace paths)."""
        self.columnar = ColumnarMetadata(capacity=self.index.store.capacity)
        self._mask_cache.clear()
        s = self.index.store
        for r in range(s.count):
            iid = s.row_to_id[r]
            if iid is not None:
                self.columnar.set_row(
                    r, self._filterable_view(self.metadata_map.get(iid)))

    # ----------------------------------------------------------- persistence
    def _require_store(self) -> None:
        if self._persister is None:
            raise VectorDBError("the session has no object store",
                                SESSION_ERROR)

    def save_to_s5(self) -> str:
        """The chunked save, the sharded metadata map and the schema under
        the session id, which is returned as the "CID" (parity:
        session.rs:636-695)."""
        self._check_alive()
        self._require_store()
        if self.index is None:
            raise VectorDBError("nothing to save", SESSION_ERROR)
        sid = self.config.session_id
        try:
            self._persister.save_index_chunked(
                self.index, sid, chunk_size=self.config.chunk_size,
                schema=self.schema)
            self._save_metadata_map(sid)
            if self.schema is not None:
                self.object_store.put(
                    f"{sid}/schema.json",
                    json.dumps(self.schema.to_json()).encode())
            else:
                # a cleared schema must not come back from the schema.json
                # of an earlier save
                try:
                    self.object_store.delete(f"{sid}/schema.json")
                except Exception:  # noqa: BLE001 - absent is fine
                    pass
        except VectorDBError:
            raise
        except Exception as e:  # noqa: BLE001
            raise VectorDBError(f"save failed: {e}", STORAGE_ERROR) from e
        return sid

    def load_user_vectors(self, cid: str,
                          options: LoadOptions | dict | None = None) -> None:
        """Load a saved session onto this session's device: eagerly, or
        lazily (``lazyLoad``, the default: the sidecars now, the rows in the
        background, searches answered meanwhile from on-demand fetches)."""
        self._check_alive()
        self._require_store()
        if isinstance(options, dict):
            options = LoadOptions(
                lazy_load=bool(options.get("lazyLoad",
                                           options.get("lazy_load", True))),
                memory_budget_mb=options.get("memoryBudgetMb"))
        opts = options or LoadOptions()
        try:
            index, manifest = self._persister.load_index_chunked(
                cid, lazy=opts.lazy_load)
        except Exception as e:  # noqa: BLE001
            raise VectorDBError(f"load failed: {e}", STORAGE_ERROR) from e
        self.index = index
        self.dim = index.store.dim
        self.metadata_map = self._load_metadata_map(cid)
        self.schema = manifest.schema
        if self.schema is None:
            try:
                self.schema = MetadataSchema.from_json(
                    json.loads(self.object_store.get(f"{cid}/schema.json")))
            except Exception:  # noqa: BLE001 - a save without a schema
                self.schema = None
        self._rebuild_columnar()

    def _save_metadata_map(self, sid: str) -> None:
        """metadata_map sharded into chunk_size-entry CBOR files, as the
        vector chunks are."""
        items = list(self.metadata_map.items())
        shard_size = max(self.config.chunk_size, 1)
        n_shards = (len(items) + shard_size - 1) // shard_size
        prev = 0
        try:
            prev = int(json.loads(self.object_store.get(
                f"{sid}/metadata/meta-manifest.json")).get("n_shards", 0))
        except Exception:  # noqa: BLE001 - no earlier save
            pass
        for si in range(n_shards):
            shard = dict(items[si * shard_size: (si + 1) * shard_size])
            self.object_store.put(f"{sid}/metadata/meta-{si}.cbor",
                                  cbor.dumps(shard))
        self.object_store.put(
            f"{sid}/metadata/meta-manifest.json",
            json.dumps({"n_shards": n_shards, "total": len(items)}).encode())
        for si in range(n_shards, prev):  # shrunken saves drop stale shards
            try:
                self.object_store.delete(f"{sid}/metadata/meta-{si}.cbor")
            except Exception:  # noqa: BLE001 - already gone
                pass

    def _load_metadata_map(self, cid: str) -> dict:
        try:
            manifest = json.loads(self.object_store.get(
                f"{cid}/metadata/meta-manifest.json"))
        except NotFoundError:
            manifest = None  # a save before the shards: the single blob
        if manifest is not None:
            # a present manifest promises its shards: a failed GET raises
            # rather than serving (and later saving) an empty map
            out: dict = {}
            for si in range(int(manifest.get("n_shards", 0))):
                try:
                    out.update(cbor.loads(self.object_store.get(
                        f"{cid}/metadata/meta-{si}.cbor")))
                except Exception as e:  # noqa: BLE001
                    raise VectorDBError(
                        f"metadata shard {si} of "
                        f"{manifest.get('n_shards')} failed to load: {e}",
                        STORAGE_ERROR) from e
            return out
        try:
            return cbor.loads(self.object_store.get(
                f"{cid}/metadata_map.cbor"))
        except NotFoundError:
            return {}  # a save without metadata

    # ----------------------------------------------------------------- misc
    def prewarm(self) -> float:
        """Upload the device state and run the serving kernel on a dummy
        query, so the first real request does not pay the corpus upload.
        Returns seconds spent; 0.0 before any index exists."""
        self._check_alive()
        if self.index is None:
            return 0.0
        return self.index.fused.prewarm()

    def get_stats(self) -> SessionStats:
        self._check_alive()
        if self.index is None:
            return SessionStats(0, 0.0, "none", 0, 0, 0, 0, 0)
        st = self.index.stats()
        mem_mb = self.index.memory_usage_bytes() / (1024 * 1024)
        return SessionStats(
            vector_count=st.total_vectors,
            memory_usage_mb=round(mem_mb, 2),
            index_type="hybrid" if st.ivf_trained else "hnsw",
            hnsw_vector_count=st.recent_vectors,
            ivf_vector_count=st.historical_vectors,
            hnsw_deleted_count=st.deleted_recent,
            ivf_deleted_count=st.deleted_historical,
            total_deleted_count=st.deleted_recent + st.deleted_historical,
        )

    def set_schema(self, schema_json: Any = None) -> None:
        self._check_alive()
        if schema_json is None:
            self.schema = None
            return
        try:
            self.schema = MetadataSchema.from_json(schema_json)
        except SchemaError as e:
            raise VectorDBError(str(e), INVALID_DATA) from e

    def vacuum(self) -> VacuumStats:
        self._check_alive()
        if self.index is None:
            return VacuumStats(0, 0, 0)
        removed_ids = self.index.get_deleted_vectors()
        removed_rows = [self.index.store.row_of(iid) for iid in removed_ids]
        stats = self.index.vacuum()
        for iid, row in zip(removed_ids, removed_rows):
            self.metadata_map.pop(iid, None)
            self.columnar.clear_row(row)
        return VacuumStats(
            hnsw_removed=stats["hnsw_removed"],
            ivf_removed=stats["ivf_removed"],
            total_removed=stats["total_removed"],
        )

    def destroy(self) -> None:
        self.index = None  # releases the device state
        self.metadata_map = {}
        self.columnar = ColumnarMetadata()
        self._mask_cache.clear()
        self.destroyed = True
