"""Identifier and score types at the API boundary (copied from the JAX
package's ``core/types.py``, as far as the session uses them).

``VectorId`` is the 32-byte content hash of a user-provided string id (the
reference uses blake3; blake2b-256 here, as in the JAX package): the session
keys rows by it and keeps the original string in ``_originalId``.
"""
from __future__ import annotations

import hashlib


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


def distance_to_score(distance: float) -> float:
    """The SDK scoring rule: score = 1 / (1 + distance).

    (reference: bindings/node/src/session.rs:225-293 and
    src/api/rest.rs:599-677 use the same mapping.)
    """
    return 1.0 / (1.0 + float(distance))
