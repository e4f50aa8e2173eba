from .codec import dumps, loads, CborError
from .compress import compress_zstd, decompress_zstd

__all__ = ["dumps", "loads", "CborError", "compress_zstd", "decompress_zstd"]
