"""CBOR (RFC 8949) encoder/decoder (a copy of the JAX package's
``cbor/codec.py``: both packages write the same bytes).

TPU-native equivalent of the reference's CBOR codec (reference: src/cbor/
encoder.rs:11-61, decoder.rs:9-46, serde_cbor usage throughout persistence).
Persistence payloads (chunks, metadata, manifests' binary parts) are CBOR so
the on-disk format stays self-describing and language-neutral.

Supported model: None/bool/int/float/str/bytes/list/dict (text keys),
numpy scalars/arrays (arrays encode as tagged byte strings, tag 80-87 RFC 8746
typed arrays for f32/f64/int32/int64, little-endian), and pass-through
semantic tags. The JAX package may use a C++ accelerator when built; this
module is the portable fallback and the format definition.
"""
from __future__ import annotations

import math
import struct
from io import BytesIO

import numpy as np


class CborError(ValueError):
    pass


# RFC 8746 typed-array tags (little-endian variants).
_TAG_U8 = 64
_TAG_U16LE = 69
_TAG_U32LE = 70
_TAG_U64LE = 71
_TAG_I8 = 72
_TAG_I16LE = 77
_TAG_I32LE = 78
_TAG_I64LE = 79
_TAG_F32LE = 85
_TAG_F64LE = 86

_DTYPE_TO_TAG = {
    np.dtype(np.uint8): _TAG_U8,
    np.dtype(np.uint16): _TAG_U16LE,
    np.dtype(np.uint32): _TAG_U32LE,
    np.dtype(np.uint64): _TAG_U64LE,
    np.dtype(np.int8): _TAG_I8,
    np.dtype(np.int16): _TAG_I16LE,
    np.dtype(np.int32): _TAG_I32LE,
    np.dtype(np.int64): _TAG_I64LE,
    np.dtype(np.float32): _TAG_F32LE,
    np.dtype(np.float64): _TAG_F64LE,
}
_TAG_TO_DTYPE = {v: k for k, v in _DTYPE_TO_TAG.items()}

# Our multidim-array convention: tag 40 (RFC 8746 multi-dim array, row-major)
# wrapping [shape, typed-array].
_TAG_MULTIDIM = 40


def _write_head(out: BytesIO, major: int, value: int) -> None:
    if value < 24:
        out.write(bytes([(major << 5) | value]))
    elif value < 1 << 8:
        out.write(bytes([(major << 5) | 24, value]))
    elif value < 1 << 16:
        out.write(bytes([(major << 5) | 25]) + value.to_bytes(2, "big"))
    elif value < 1 << 32:
        out.write(bytes([(major << 5) | 26]) + value.to_bytes(4, "big"))
    else:
        out.write(bytes([(major << 5) | 27]) + value.to_bytes(8, "big"))


def _encode(out: BytesIO, obj) -> None:
    if obj is None:
        out.write(b"\xf6")
    elif obj is True:
        out.write(b"\xf5")
    elif obj is False:
        out.write(b"\xf4")
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        v = int(obj)
        if v >= 0:
            _write_head(out, 0, v)
        else:
            _write_head(out, 1, -1 - v)
    elif isinstance(obj, (float, np.floating)):
        f = float(obj)
        if math.isnan(f):
            out.write(b"\xf9\x7e\x00")
        else:
            out.write(b"\xfb" + struct.pack(">d", f))
    elif isinstance(obj, bytes):
        _write_head(out, 2, len(obj))
        out.write(obj)
    elif isinstance(obj, bytearray):
        _encode(out, bytes(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _write_head(out, 3, len(data))
        out.write(data)
    elif isinstance(obj, np.ndarray):
        dt = obj.dtype
        if dt not in _DTYPE_TO_TAG:
            raise CborError(f"unsupported ndarray dtype {dt}")
        payload = np.ascontiguousarray(obj)
        if obj.ndim == 1:
            _write_head(out, 6, _DTYPE_TO_TAG[dt])
            raw = payload.tobytes()
            _write_head(out, 2, len(raw))
            out.write(raw)
        else:
            _write_head(out, 6, _TAG_MULTIDIM)
            _write_head(out, 4, 2)
            _encode(out, list(obj.shape))
            _encode(out, payload.reshape(-1))
    elif isinstance(obj, (list, tuple)):
        _write_head(out, 4, len(obj))
        for item in obj:
            _encode(out, item)
    elif isinstance(obj, dict):
        _write_head(out, 5, len(obj))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise CborError(f"map keys must be text, got {type(k).__name__}")
            _encode(out, k)
            _encode(out, v)
    else:
        raise CborError(f"cannot encode {type(obj).__name__}")


def dumps(obj) -> bytes:
    out = BytesIO()
    _encode(out, obj)
    return out.getvalue()


class _Decoder:
    def __init__(self, data: bytes, copy_arrays: bool = True):
        self.data = data
        self.pos = 0
        # copy_arrays=False returns typed arrays as READ-ONLY views over
        # the input buffer (zero-copy). Measured at 1M rows the copy is
        # NOT a load bottleneck (the bytes are touched again when blocks
        # copy into the store — total load time was unchanged), so every
        # production path keeps the safe owning default; the option exists
        # for consumers that never rewrite the decoded arrays.
        self.copy_arrays = copy_arrays

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CborError("truncated CBOR input")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def _head(self):
        b = self._take(1)[0]
        major, info = b >> 5, b & 0x1F
        if major == 7 and info in (25, 26, 27):
            # Float payload: leave bytes in place for _simple to read.
            return major, info
        if info < 24:
            return major, info
        if info == 24:
            return major, self._take(1)[0]
        if info == 25:
            return major, int.from_bytes(self._take(2), "big")
        if info == 26:
            return major, int.from_bytes(self._take(4), "big")
        if info == 27:
            return major, int.from_bytes(self._take(8), "big")
        if info == 31:
            return major, -1  # indefinite
        raise CborError(f"reserved additional info {info}")

    def decode(self):
        major, value = self._head()
        if major == 0:
            return value
        if major == 1:
            return -1 - value
        if major == 2:
            if value == -1:
                return self._indefinite_bytes()
            return bytes(self._take(value))
        if major == 3:
            if value == -1:
                return self._indefinite_text()
            return self._take(value).decode("utf-8")
        if major == 4:
            if value == -1:
                out = []
                while not self._at_break():
                    out.append(self.decode())
                return out
            return [self.decode() for _ in range(value)]
        if major == 5:
            out = {}
            if value == -1:
                while not self._at_break():
                    k = self.decode()
                    out[k] = self.decode()
                return out
            for _ in range(value):
                k = self.decode()
                out[k] = self.decode()
            return out
        if major == 6:
            return self._tagged(value)
        if major == 7:
            return self._simple(value)
        raise CborError(f"bad major type {major}")

    def _at_break(self) -> bool:
        if self.pos < len(self.data) and self.data[self.pos] == 0xFF:
            self.pos += 1
            return True
        return False

    def _indefinite_bytes(self) -> bytes:
        chunks = []
        while not self._at_break():
            major, value = self._head()
            if major != 2:
                raise CborError("bad indefinite byte string chunk")
            chunks.append(self._take(value))
        return b"".join(chunks)

    def _indefinite_text(self) -> str:
        chunks = []
        while not self._at_break():
            major, value = self._head()
            if major != 3:
                raise CborError("bad indefinite text chunk")
            chunks.append(self._take(value))
        return b"".join(chunks).decode("utf-8")

    def _tagged(self, tag: int):
        if tag in _TAG_TO_DTYPE:
            raw = self.decode()
            if not isinstance(raw, bytes):
                raise CborError("typed array tag must wrap a byte string")
            arr = np.frombuffer(raw, dtype=_TAG_TO_DTYPE[tag])
            return arr.copy() if self.copy_arrays else arr
        if tag == _TAG_MULTIDIM:
            pair = self.decode()
            if not isinstance(pair, list) or len(pair) != 2:
                raise CborError("multidim tag must wrap [shape, array]")
            shape, flat = pair
            return np.asarray(flat).reshape(shape)
        # Unknown semantic tag: return the inner value.
        return self.decode()

    def _simple(self, value: int):
        if value == 20:
            return False
        if value == 21:
            return True
        if value in (22, 23):
            return None
        if value == 25:  # half float
            return float(np.frombuffer(self._take(2), dtype=">f2")[0])
        if value == 26:
            return struct.unpack(">f", self._take(4))[0]
        if value == 27:
            return struct.unpack(">d", self._take(8))[0]
        raise CborError(f"unsupported simple value {value}")


def loads(data: bytes, copy_arrays: bool = True):
    dec = _Decoder(data, copy_arrays=copy_arrays)
    obj = dec.decode()
    return obj
