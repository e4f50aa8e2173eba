"""Core identifier / embedding / result types.

A copy of the JAX package's ``core/types.py``.

Feature parity with the reference's core types (reference: src/core/types.rs):
  - ``VectorId``: 32-byte content hash of the user-provided string id,
    displayed as ``vec_<8 hex>``; the original string is NOT recoverable from
    it, so the session layer preserves originals in metadata ``_originalId``
    (src/core/types.rs:19-34). The reference uses blake3; we use blake2b-256
    (stdlib) — same contract: deterministic, collision-resistant, one-way.
  - ``Embedding`` with cosine similarity / euclidean distance
    (src/core/types.rs:79-120).
  - ``SearchResult`` ordered by distance, with deduplication keeping the best
    score per id (src/core/types.rs:206-224).

In the TPU engine itself, vectors are rows of dense arrays and ids are row
indices; these types live at the API boundary only.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np


class VectorId:
    """Content-addressed vector identifier (32-byte digest of a user string)."""

    __slots__ = ("digest",)

    def __init__(self, digest: bytes):
        if len(digest) != 32:
            raise ValueError("VectorId digest must be 32 bytes")
        self.digest = digest

    @classmethod
    def from_string(cls, s: str) -> "VectorId":
        return cls(hashlib.blake2b(s.encode("utf-8"), digest_size=32).digest())

    @classmethod
    def from_hex(cls, h: str) -> "VectorId":
        return cls(bytes.fromhex(h))

    def to_hex(self) -> str:
        return self.digest.hex()

    def __str__(self) -> str:  # display form: vec_<first 8 hex chars>
        return f"vec_{self.digest.hex()[:8]}"

    def __repr__(self) -> str:
        return f"VectorId({self})"

    def __eq__(self, other) -> bool:
        return isinstance(other, VectorId) and self.digest == other.digest

    def __hash__(self) -> int:
        return hash(self.digest)


@dataclass
class Embedding:
    """A dense embedding with basic similarity helpers."""

    values: np.ndarray

    def __post_init__(self):
        self.values = np.asarray(self.values, dtype=np.float32)

    @property
    def dimension(self) -> int:
        return int(self.values.shape[-1])

    def cosine_similarity(self, other: "Embedding") -> float:
        a, b = self.values, other.values
        denom = float(np.linalg.norm(a) * np.linalg.norm(b))
        if denom == 0.0:
            return 0.0
        return float(np.dot(a, b) / denom)

    def euclidean_distance(self, other: "Embedding") -> float:
        return float(np.linalg.norm(self.values - other.values))


@dataclass
class Vector:
    """A stored vector: id + embedding + optional metadata."""

    id: VectorId
    embedding: Embedding
    metadata: Any = None


@dataclass(order=False)
class SearchResult:
    """A search hit; orders by ascending distance."""

    id: str
    distance: float
    score: float = 0.0
    metadata: Any = None
    vector: list | None = None

    def __lt__(self, other: "SearchResult") -> bool:
        return self.distance < other.distance


def deduplicate_results(results: Iterable[SearchResult]) -> list[SearchResult]:
    """Keep the best (smallest distance) result per id, preserving sort order."""
    best: dict[str, SearchResult] = {}
    for r in results:
        cur = best.get(r.id)
        if cur is None or r.distance < cur.distance:
            best[r.id] = r
    return sorted(best.values())


def distance_to_score(distance: float) -> float:
    """The SDK scoring rule: score = 1 / (1 + distance).

    (reference: bindings/node/src/session.rs:225-293 and
    src/api/rest.rs:599-677 use the same mapping.)
    """
    return 1.0 / (1.0 + float(distance))


# ---------------------------------------------------------------------------
# Domain metadata types (video / NFT / S5). JSON-dict round-tripping with the
# reference's serde field names, including camelCase aliases on input.
# ---------------------------------------------------------------------------


@dataclass
class VideoMetadata:
    """Video attributes attached to a stored vector
    (reference: src/core/types.rs:153-188)."""

    video_id: str = ""
    title: str = ""
    description: str | None = None
    tags: list[str] = field(default_factory=list)
    duration_seconds: int = 0
    upload_timestamp: float = 0.0
    model_name: str = ""
    extra: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "video_id": self.video_id,
            "title": self.title,
            "description": self.description,
            "tags": list(self.tags),
            "duration_seconds": self.duration_seconds,
            "upload_timestamp": self.upload_timestamp,
            "model_name": self.model_name,
            "extra": dict(self.extra),
        }

    @classmethod
    def from_json(cls, d: dict) -> "VideoMetadata":
        return cls(
            video_id=d.get("video_id", ""),
            title=d.get("title", ""),
            description=d.get("description"),
            tags=list(d.get("tags", [])),
            duration_seconds=int(d.get("duration_seconds", 0)),
            upload_timestamp=float(d.get("upload_timestamp", 0.0)),
            model_name=d.get("model_name", ""),
            extra=dict(d.get("extra", {})),
        )


@dataclass
class VideoNFTMetadata:
    """NFT-domain video metadata with camelCase input aliases
    (reference: src/types/mod.rs:33-63 — serde aliases mintDateTime,
    posterImage, userPub; ``type`` is a reserved word there too)."""

    address: str = ""
    attributes: list[dict] = field(default_factory=list)  # [{key, value}]
    description: str | None = None
    genre: list[str] = field(default_factory=list)
    id: str = ""
    image: str = ""
    mint_date_time: str = ""
    name: str = ""
    poster_image: str | None = None
    summary: str | None = None
    supply: int | None = None
    symbol: str | None = None
    type: str = ""
    uri: str | None = None
    user_pub: str | None = None
    video: str | None = None
    animation_url: str | None = None

    _ALIASES = {
        "mint_date_time": ("mint_date_time", "mintDateTime"),
        "poster_image": ("poster_image", "posterImage"),
        "user_pub": ("user_pub", "userPub"),
    }

    def to_json(self) -> dict:
        # snake_case canonical output; None optionals omitted (serde
        # skip_serializing_if behavior).
        out = {
            "address": self.address,
            "attributes": list(self.attributes),
            "genre": list(self.genre),
            "id": self.id,
            "image": self.image,
            "mint_date_time": self.mint_date_time,
            "name": self.name,
            "type": self.type,
        }
        for key in ("description", "poster_image", "summary", "supply",
                    "symbol", "uri", "user_pub", "video", "animation_url"):
            val = getattr(self, key)
            if val is not None:
                out[key] = val
        return out

    @classmethod
    def from_json(cls, d: dict) -> "VideoNFTMetadata":
        def pick(*names, default=None):
            for n in names:
                if n in d:
                    return d[n]
            return default

        return cls(
            address=d.get("address", ""),
            attributes=list(d.get("attributes", [])),
            description=d.get("description"),
            genre=list(d.get("genre", [])),
            id=d.get("id", ""),
            image=d.get("image", ""),
            mint_date_time=pick("mint_date_time", "mintDateTime", default=""),
            name=d.get("name", ""),
            poster_image=pick("poster_image", "posterImage"),
            summary=d.get("summary"),
            supply=d.get("supply"),
            symbol=d.get("symbol"),
            type=d.get("type", ""),
            uri=d.get("uri"),
            user_pub=pick("user_pub", "userPub"),
            video=d.get("video"),
            animation_url=pick("animation_url", "animationUrl"),
        )


@dataclass
class S5Metadata:
    """Metadata of a blob stored on S5 (reference: src/types/mod.rs:76-83)."""

    cid: str
    size: int
    mime_type: str
    created_at: int
    encryption: str | None = None

    def to_json(self) -> dict:
        return {
            "cid": self.cid,
            "size": self.size,
            "mime_type": self.mime_type,
            "created_at": self.created_at,
            "encryption": self.encryption,
        }

    @classmethod
    def from_json(cls, d: dict) -> "S5Metadata":
        return cls(
            cid=d["cid"],
            size=int(d["size"]),
            mime_type=d.get("mime_type", ""),
            created_at=int(d.get("created_at", 0)),
            encryption=d.get("encryption"),
        )
