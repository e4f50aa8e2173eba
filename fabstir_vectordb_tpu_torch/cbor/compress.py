"""zstd compression helpers for persisted payloads.

Mirrors the reference's optional zstd level-3 compression of inverted lists
(reference: src/ivf/persistence.rs:101-117,158-164 and src/cbor helpers).
Falls back to zlib if the zstandard module is unavailable; payloads are
prefixed with a 4-byte magic identifying the codec so either side can read.
"""
from __future__ import annotations

_MAGIC_ZSTD = b"FVZ1"
_MAGIC_ZLIB = b"FVL1"

try:
    import zstandard as _zstd

    _HAVE_ZSTD = True
except Exception:  # pragma: no cover
    _HAVE_ZSTD = False

import zlib


def compress_zstd(data: bytes, level: int = 3) -> bytes:
    if _HAVE_ZSTD:
        return _MAGIC_ZSTD + _zstd.ZstdCompressor(level=level).compress(data)
    return _MAGIC_ZLIB + zlib.compress(data, level)


def decompress_zstd(data: bytes) -> bytes:
    if data[:4] == _MAGIC_ZSTD:
        if not _HAVE_ZSTD:  # pragma: no cover
            raise RuntimeError("zstd payload but zstandard module unavailable")
        return _zstd.ZstdDecompressor().decompress(data[4:])
    if data[:4] == _MAGIC_ZLIB:
        return zlib.decompress(data[4:])
    return data  # uncompressed legacy payload
