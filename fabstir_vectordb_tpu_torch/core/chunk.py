"""Chunked-storage data model: VectorChunk, ChunkMetadata, manifests.

A copy of the JAX package's ``core/chunk.py``.

Format parity with the reference's chunk/manifest layer
(reference: src/core/chunk.rs):
  - ``VectorChunk``: {chunk_id, start_idx, end_idx, vectors} (:38-97). The
    reference stores a CBOR HashMap<VectorId, Vec<f32>>; our TPU-native chunk
    keeps ids and a dense row-major f32 array (ids[i] <-> data[i]) so a chunk
    uploads to HBM as one contiguous shard — same information, array layout.
  - ``ChunkMetadata``: {chunk_id, cid, vector_count, byte_size, id range}
    (:105-145).
  - ``HNSWManifest``: entry point, per-layer counts, node->chunk map (:160-193).
  - ``IVFManifest``: inline centroids, cluster->chunk_ids (:201-229).
  - Top-level ``Manifest`` v3 JSON with deleted_vectors + optional schema and
    forward-version rejection (:237-342, MANIFEST_VERSION=3 :30).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .. import cbor
from .schema import MetadataSchema

MANIFEST_VERSION = 3
DEFAULT_CHUNK_SIZE = 10_000


class ChunkError(ValueError):
    pass


def _pack_ids(ids: list) -> bytes:
    """Length-prefixed UTF-8 packing (u32 LE length per id). Handles any
    unicode id including separators/NULs."""
    import struct

    parts = []
    for vid in ids:
        raw = vid.encode("utf-8")
        parts.append(struct.pack("<I", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _unpack_ids(blob: bytes) -> list:
    import struct

    out = []
    pos, end = 0, len(blob)
    while pos < end:
        (n,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        out.append(blob[pos: pos + n].decode("utf-8"))
        pos += n
    return out


@dataclass
class VectorChunk:
    """A shard of ~chunk_size vectors, stored as a dense [n, dim] f32 array."""

    chunk_id: str
    start_idx: int
    end_idx: int
    ids: list  # list[str] user-facing ids, row-aligned with data
    data: np.ndarray  # [n, dim] float32

    def __post_init__(self):
        self.data = np.asarray(self.data, dtype=np.float32)
        if self.data.ndim != 2:
            raise ChunkError("chunk data must be [n, dim]")
        if len(self.ids) != self.data.shape[0]:
            raise ChunkError(
                f"ids ({len(self.ids)}) and data rows ({self.data.shape[0]}) mismatch"
            )

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def dim(self) -> int:
        return int(self.data.shape[1]) if self.data.size else 0

    def get_vector(self, vid: str) -> np.ndarray | None:
        try:
            return self.data[self.ids.index(vid)]
        except ValueError:
            return None

    def to_cbor(self) -> bytes:
        return cbor.dumps(
            {
                "format": "fvdb-chunk",
                "version": 2,
                "chunk_id": self.chunk_id,
                "start_idx": self.start_idx,
                "end_idx": self.end_idx,
                # v2: one length-prefixed UTF-8 blob. Decoding 10K separate
                # CBOR text strings in the pure-python codec cost ~0.4s per
                # chunk (~40us each); one byte string is a single decode.
                "ids_packed": _pack_ids(self.ids),
                "dim": self.dim,
                "data": self.data,
            }
        )

    @classmethod
    def from_cbor(cls, raw: bytes) -> "VectorChunk":
        try:
            obj = cbor.loads(raw)
        except cbor.CborError as e:
            raise ChunkError(f"chunk decode failed: {e}") from e
        if not isinstance(obj, dict) or obj.get("format") != "fvdb-chunk":
            raise ChunkError("not a vector chunk payload")
        data = np.asarray(obj["data"], dtype=np.float32)
        if data.ndim == 1:
            dim = int(obj.get("dim") or 0)
            data = data.reshape(-1, dim) if dim else data.reshape(0, 0)
        if "ids_packed" in obj:
            ids = _unpack_ids(obj["ids_packed"])
        else:  # v1 chunks: plain list of strings
            ids = list(obj["ids"])
        return cls(
            chunk_id=obj["chunk_id"],
            start_idx=int(obj["start_idx"]),
            end_idx=int(obj["end_idx"]),
            ids=ids,
            data=data,
        )

    def overlaps_with(self, other: "VectorChunk") -> bool:
        return not (self.end_idx < other.start_idx or other.end_idx < self.start_idx)


@dataclass
class ChunkMetadata:
    chunk_id: str
    vector_count: int
    byte_size: int
    cid: str | None = None
    id_range: tuple | None = None  # (first_id, last_id)

    def to_json(self) -> dict:
        return {
            "chunk_id": self.chunk_id,
            "cid": self.cid,
            "vector_count": self.vector_count,
            "byte_size": self.byte_size,
            "vector_id_range": list(self.id_range) if self.id_range else None,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ChunkMetadata":
        rng = obj.get("vector_id_range")
        return cls(
            chunk_id=obj["chunk_id"],
            cid=obj.get("cid"),
            vector_count=int(obj.get("vector_count", 0)),
            byte_size=int(obj.get("byte_size", 0)),
            id_range=tuple(rng) if rng else None,
        )


@dataclass
class HNSWManifest:
    """HNSW structure summary persisted in the manifest."""

    entry_point: str | None
    layers: list = field(default_factory=list)  # [{layer_id, node_count}]
    node_chunk_map: dict = field(default_factory=dict)  # id -> chunk_id

    def add_layer(self, layer_id: int, node_count: int) -> None:
        self.layers.append({"layer_id": layer_id, "node_count": node_count})

    def to_json(self) -> dict:
        return {
            "entry_point": self.entry_point,
            "layers": self.layers,
            "node_chunk_map": self.node_chunk_map,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "HNSWManifest":
        return cls(
            entry_point=obj.get("entry_point"),
            layers=list(obj.get("layers") or []),
            node_chunk_map=dict(obj.get("node_chunk_map") or {}),
        )


@dataclass
class IVFManifest:
    """IVF structure summary: centroids inline, cluster -> chunk ids."""

    centroids: np.ndarray  # [C, D] f32 (empty array if untrained)
    cluster_assignments: dict = field(default_factory=dict)  # cluster_id(str) -> [chunk ids]

    def __post_init__(self):
        self.centroids = np.asarray(self.centroids, dtype=np.float32)

    @property
    def num_centroids(self) -> int:
        return int(self.centroids.shape[0]) if self.centroids.size else 0

    def to_json(self) -> dict:
        return {
            "centroids": self.centroids.tolist(),
            "cluster_assignments": {
                str(k): list(v) for k, v in self.cluster_assignments.items()
            },
        }

    @classmethod
    def from_json(cls, obj: dict) -> "IVFManifest":
        cents = np.asarray(obj.get("centroids") or [], dtype=np.float32)
        if cents.ndim == 1 and cents.size == 0:
            cents = cents.reshape(0, 0)
        return cls(
            centroids=cents,
            cluster_assignments={
                str(k): list(v)
                for k, v in (obj.get("cluster_assignments") or {}).items()
            },
        )


@dataclass
class Manifest:
    """Top-level chunked-index manifest (format v3, JSON)."""

    chunk_size: int = DEFAULT_CHUNK_SIZE
    total_vectors: int = 0
    version: int = MANIFEST_VERSION
    chunks: list = field(default_factory=list)  # list[ChunkMetadata]
    hnsw_structure: HNSWManifest | None = None
    ivf_structure: IVFManifest | None = None
    deleted_vectors: list | None = None  # soft-deleted ids (v3+)
    schema: MetadataSchema | None = None  # optional validation schema (v3+)
    extra: dict = field(default_factory=dict)  # engine-private extensions

    def add_chunk(self, meta: ChunkMetadata) -> None:
        self.chunks.append(meta)

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def get_chunk(self, chunk_id: str) -> ChunkMetadata | None:
        for c in self.chunks:
            if c.chunk_id == chunk_id:
                return c
        return None

    def chunk_ids(self) -> list:
        return [c.chunk_id for c in self.chunks]

    def validate(self) -> None:
        seen = set()
        for c in self.chunks:
            if c.chunk_id in seen:
                raise ChunkError(f"Duplicate chunk ID: {c.chunk_id}")
            seen.add(c.chunk_id)

    def to_json(self) -> str:
        obj: dict[str, Any] = {
            "version": self.version,
            "chunk_size": self.chunk_size,
            "total_vectors": self.total_vectors,
            "chunks": [c.to_json() for c in self.chunks],
            "hnsw_structure": self.hnsw_structure.to_json()
            if self.hnsw_structure
            else None,
            "ivf_structure": self.ivf_structure.to_json()
            if self.ivf_structure
            else None,
        }
        if self.deleted_vectors is not None:
            obj["deleted_vectors"] = list(self.deleted_vectors)
        if self.schema is not None:
            obj["schema"] = self.schema.to_json()
        if self.extra:
            obj["extra"] = self.extra
        return json.dumps(obj, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        try:
            obj = json.loads(text)
        except json.JSONDecodeError as e:
            raise ChunkError(f"manifest parse error: {e}") from e
        version = int(obj.get("version", 1))
        if version > MANIFEST_VERSION:
            raise ChunkError(
                f"Invalid version: expected {MANIFEST_VERSION}, found {version}"
            )
        m = cls(
            chunk_size=int(obj.get("chunk_size", DEFAULT_CHUNK_SIZE)),
            total_vectors=int(obj.get("total_vectors", 0)),
            version=MANIFEST_VERSION,  # auto-upgrade older versions on load
            chunks=[ChunkMetadata.from_json(c) for c in (obj.get("chunks") or [])],
            deleted_vectors=list(obj["deleted_vectors"])
            if obj.get("deleted_vectors") is not None
            else None,
            extra=dict(obj.get("extra") or {}),
        )
        if obj.get("hnsw_structure"):
            m.hnsw_structure = HNSWManifest.from_json(obj["hnsw_structure"])
        if obj.get("ivf_structure"):
            m.ivf_structure = IVFManifest.from_json(obj["ivf_structure"])
        if obj.get("schema"):
            m.schema = MetadataSchema.from_json(obj["schema"])
        return m
