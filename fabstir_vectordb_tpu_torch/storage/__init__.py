"""Chunked persistence, the chunk loader, S5 drivers and encryption: the
JAX package's ``storage/`` over the port's index (the host modules are
copies; ``persistence.py`` builds the port's stores on its device)."""
from .chunk_loader import ChunkLoader
from .encryption import EncryptedObjectStore, derive_key
from .s5 import S5ObjectStore, S5Client, CidMapObjectStore
from .factory import StorageFactory, StorageConfig
from .persistence import HybridPersister, HNSWPersister, IVFPersister, PersistenceError

__all__ = [
    "ChunkLoader",
    "EncryptedObjectStore",
    "derive_key",
    "S5ObjectStore",
    "S5Client",
    "CidMapObjectStore",
    "StorageFactory",
    "StorageConfig",
    "HybridPersister",
    "HNSWPersister",
    "IVFPersister",
    "PersistenceError",
]
