"""Encryption-at-rest for persisted payloads.

A copy of the JAX package's ``storage/encryption.py``.

The reference delegates encryption to the S5 service via the
``X-S5-Encryption: xchacha20-poly1305`` header (reference:
src/storage/enhanced_s5_storage.rs:92-93,153-155,412-414). For non-S5
backends (filesystem, memory) we provide a store decorator doing AEAD
locally: ChaCha20-Poly1305 (IETF, 12-byte nonce) from the ``cryptography``
package, with the key derived from the user's seed phrase — matching the
reference's "encrypted with the user's blockchain-derived seed" contract.

Wire format: magic "FVE1" | nonce(12) | ciphertext+tag. The key path is
bound as associated data so blobs can't be swapped between keys.
"""
from __future__ import annotations

import hashlib
import os

from ..core.object_store import ObjectStore, StorageError, _DecoratorStore

try:
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    HAVE_AEAD = True
except Exception:  # pragma: no cover
    HAVE_AEAD = False

_MAGIC = b"FVE1"


def derive_key(seed_phrase: str, salt: str = "fabstir-vectordb") -> bytes:
    """32-byte key from a seed phrase (scrypt; deterministic per phrase)."""
    return hashlib.scrypt(
        seed_phrase.encode("utf-8"),
        salt=salt.encode("utf-8"),
        n=2**14, r=8, p=1, dklen=32,
    )


class EncryptedObjectStore(_DecoratorStore):
    """AEAD encrypt/decrypt decorator around any ObjectStore."""

    # A byte range of the CIPHERTEXT is useless to callers expecting
    # plaintext bytes, and the AEAD tag covers the whole blob — so ranges
    # here decrypt the full object and slice (correct, no IO savings).
    supports_range = False

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        return self.get(key)[offset: offset + length]

    def __init__(self, inner: ObjectStore, key: bytes,
                 allow_plaintext: bool = False):
        if not HAVE_AEAD:  # pragma: no cover
            raise StorageError("cryptography package unavailable; cannot encrypt")
        if len(key) != 32:
            raise ValueError("key must be 32 bytes")
        self.inner = inner
        self.allow_plaintext = allow_plaintext
        self._aead = ChaCha20Poly1305(key)

    def put(self, key: str, data: bytes) -> None:
        nonce = os.urandom(12)
        ct = self._aead.encrypt(nonce, bytes(data), key.encode("utf-8"))
        self.inner.put(key, _MAGIC + nonce + ct)

    def get(self, key: str) -> bytes:
        blob = self.inner.get(key)
        if blob[:4] != _MAGIC:
            # An unauthenticated blob in an encrypted store is an integrity
            # failure by default — silently accepting it would let anyone
            # with write access to the underlying store bypass the AEAD.
            # Legacy plaintext migration must be opted into explicitly.
            if self.allow_plaintext:
                return blob
            raise StorageError(
                f"object {key!r} is not FVE1-encrypted (pass "
                f"allow_plaintext=True to read legacy plaintext objects)"
            )
        nonce, ct = blob[4:16], blob[16:]
        try:
            return self._aead.decrypt(nonce, ct, key.encode("utf-8"))
        except Exception as e:
            raise StorageError(f"decryption failed for {key}") from e

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def list_keys(self, prefix: str = "") -> list:
        return self.inner.list_keys(prefix)

    def exists(self, key: str) -> bool:
        return self.inner.exists(key)
