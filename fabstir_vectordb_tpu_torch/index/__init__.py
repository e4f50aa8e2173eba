"""The engines (flat, IVF, HNSW, hybrid, fused, tiered, cold) and the
VectorStore, on PyTorch."""
from .store import VectorStore
from .flat import FlatIndex
from .ivf import IVFIndex, IVFConfig
from .hnsw import HNSWIndex, HNSWConfig
from .hybrid import HybridIndex, HybridConfig, SearchConfig
from .tiered import TieredFlatSearcher, MultiDeviceTieredSearcher

__all__ = [
    "VectorStore",
    "FlatIndex",
    "IVFIndex",
    "IVFConfig",
    "HNSWIndex",
    "HNSWConfig",
    "HybridIndex",
    "HybridConfig",
    "SearchConfig",
    "TieredFlatSearcher",
    "MultiDeviceTieredSearcher",
]
