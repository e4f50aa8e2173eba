"""Host-side types, metadata filters, columnar masks, schema, chunks,
caches and object stores: copies of the JAX package's modules of the same
names (none of them uses a device)."""
from .types import (
    VectorId,
    Embedding,
    Vector,
    SearchResult,
    deduplicate_results,
    VideoMetadata,
    VideoNFTMetadata,
    S5Metadata,
)
from .metadata_filter import MetadataFilter, FilterError, get_field
from .schema import MetadataSchema, SchemaError
from .chunk import (
    VectorChunk,
    ChunkMetadata,
    HNSWManifest,
    IVFManifest,
    Manifest,
    ChunkError,
    MANIFEST_VERSION,
)
from .chunk_cache import ChunkCache, CacheMetrics
from .object_store import (
    ObjectStore,
    MemoryObjectStore,
    FileSystemObjectStore,
    CachedObjectStore,
    RetryObjectStore,
    BatchObjectStore,
    CircuitBreaker,
    CircuitOpenError,
    StorageError,
)

__all__ = [
    "VectorId", "Embedding", "Vector", "SearchResult", "deduplicate_results",
    "VideoMetadata", "VideoNFTMetadata", "S5Metadata",
    "MetadataFilter", "FilterError", "get_field",
    "MetadataSchema", "SchemaError",
    "VectorChunk", "ChunkMetadata", "HNSWManifest", "IVFManifest", "Manifest",
    "ChunkError", "MANIFEST_VERSION",
    "ChunkCache", "CacheMetrics",
    "ObjectStore", "MemoryObjectStore", "FileSystemObjectStore",
    "CachedObjectStore", "RetryObjectStore", "BatchObjectStore",
    "CircuitBreaker", "CircuitOpenError", "StorageError",
]
