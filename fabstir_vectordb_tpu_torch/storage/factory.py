"""Env-driven storage construction.

A copy of the JAX package's ``storage/factory.py``.

Parity with the reference S5StorageFactory (reference:
src/storage/s5_storage_factory.rs:22-176): STORAGE_MODE/S5_MODE selection,
mock/real/filesystem backends, S5_MOCK_SERVER_URL, S5_PORTAL_URL,
S5_CONNECTION_TIMEOUT, S5_RETRY_ATTEMPTS, S5_ENCRYPT_AT_REST, seed phrase
from env or file (permission warning on group/world-readable files),
12/24-word validation, and secret-free config summaries.
"""
from __future__ import annotations

import os
import stat
from dataclasses import dataclass

from ..core.object_store import (
    CachedObjectStore,
    FileSystemObjectStore,
    MemoryObjectStore,
    ObjectStore,
    RetryObjectStore,
    StorageError,
)
from ..utils.tracing import get_logger
from .encryption import EncryptedObjectStore, derive_key
from .s5 import S5ObjectStore

log = get_logger(__name__)


@dataclass
class StorageConfig:
    mode: str = "mock"  # mock | real | fs
    mock_url: str = "http://localhost:5522"
    portal_url: str = "http://localhost:5522"
    fs_root: str = "./vectordb-data"
    seed_phrase: str | None = None
    timeout: float = 30.0
    retries: int = 3
    encrypt_at_rest: bool = True

    def summary(self) -> dict:
        """Loggable summary without secrets."""
        return {
            "mode": self.mode,
            "portal_url": self.portal_url if self.mode == "real" else None,
            "fs_root": self.fs_root if self.mode == "fs" else None,
            "timeout": self.timeout,
            "retries": self.retries,
            "encrypt_at_rest": self.encrypt_at_rest,
            "seed_phrase": "***" if self.seed_phrase else None,
        }


def validate_seed_phrase(phrase: str) -> None:
    words = phrase.split()
    if len(words) not in (12, 24):
        raise StorageError(
            f"seed phrase must be 12 or 24 words, got {len(words)}"
        )


def _load_seed_phrase() -> str | None:
    path = os.environ.get("S5_SEED_PHRASE_FILE")
    if path:
        st = os.stat(path)
        if st.st_mode & (stat.S_IRGRP | stat.S_IROTH):
            log.warning("seed phrase file %s is group/world readable", path)
        with open(path) as f:
            phrase = f.read().strip()
        validate_seed_phrase(phrase)
        return phrase
    phrase = os.environ.get("S5_SEED_PHRASE")
    if phrase:
        validate_seed_phrase(phrase)
        return phrase
    return None


class StorageFactory:
    @staticmethod
    def config_from_env() -> StorageConfig:
        mode = (
            os.environ.get("STORAGE_MODE")
            or os.environ.get("S5_MODE")
            or "mock"
        ).lower()
        return StorageConfig(
            mode=mode,
            mock_url=os.environ.get("S5_MOCK_SERVER_URL", "http://localhost:5522"),
            portal_url=os.environ.get("S5_PORTAL_URL", "http://localhost:5522"),
            fs_root=os.environ.get("FS_STORAGE_ROOT", "./vectordb-data"),
            seed_phrase=_load_seed_phrase(),
            timeout=float(os.environ.get("S5_CONNECTION_TIMEOUT", "30000")) / 1000.0,
            retries=int(os.environ.get("S5_RETRY_ATTEMPTS", "3")),
            encrypt_at_rest=os.environ.get("S5_ENCRYPT_AT_REST", "true").lower()
            != "false",
        )

    @staticmethod
    def create(config: StorageConfig | None = None) -> ObjectStore:
        cfg = config or StorageFactory.config_from_env()
        log.info("storage config: %s", cfg.summary())
        if cfg.mode == "mock":
            return MemoryObjectStore()
        if cfg.mode == "fs":
            store: ObjectStore = FileSystemObjectStore(cfg.fs_root)
            if cfg.encrypt_at_rest and cfg.seed_phrase:
                store = EncryptedObjectStore(store, derive_key(cfg.seed_phrase))
            return CachedObjectStore(
                RetryObjectStore(store, max_retries=cfg.retries)
            )
        if cfg.mode == "real":
            return S5ObjectStore(
                cfg.portal_url,
                timeout=cfg.timeout,
                retries=cfg.retries,
                encrypt_at_rest=cfg.encrypt_at_rest,
            )
        raise StorageError(f"unknown storage mode {cfg.mode!r}")

    @staticmethod
    def create_from_env() -> ObjectStore:
        """Real storage from env, mock fallback on failure (reference:
        src/api/rest.rs:234-289 falls back to mock)."""
        try:
            return StorageFactory.create()
        except Exception as e:  # noqa: BLE001
            log.warning("storage init failed (%s); falling back to mock", e)
            return MemoryObjectStore()
