"""fabstir-vectordb on PyTorch and CUDA: the port of ``fabstir_vectordb_tpu``.

The JAX package stays the reference; this package computes the same things
with PyTorch on an NVIDIA GPU, with hand-written CUDA kernels (``csrc/``)
where the reference ran fused device programs:
  index/      VectorStore, HNSW insert path, IVF, flat + fused search, hybrid
  ops/        distances, top-k (+ the fused L2 top-k kernel), k-means
  core/       types, metadata filters, columnar masks, schema (copies)
  api/        VectorDBSession
  convert.py  carries a JAX-built index's state across as numpy arrays
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from .api.session import VectorDBConfig, VectorDBError, VectorDBSession
from .index.hnsw import HNSWConfig, HNSWIndex
from .index.hybrid import HybridConfig, HybridIndex, SearchConfig
from .index.ivf import IVFConfig, IVFIndex
from .index.store import VectorStore

__all__ = [
    "VectorDBSession", "VectorDBConfig", "VectorDBError", "HybridIndex",
    "HybridConfig", "SearchConfig", "IVFIndex", "IVFConfig", "HNSWIndex",
    "HNSWConfig", "VectorStore",
]
