"""fabstir-vectordb on PyTorch and CUDA: the port of ``fabstir_vectordb_tpu``.

The JAX package stays the reference; this package computes the same things
with PyTorch on an NVIDIA GPU, with hand-written CUDA kernels (``csrc/``)
where the reference ran fused device programs:
  index/      VectorStore, HNSW insert path, IVF, flat + fused search, hybrid
  ops/        distances, top-k (+ the fused L2 top-k kernel), k-means,
              quantization
  core/       types, metadata filters, columnar masks, schema, chunks,
              caches, object stores (copies)
  storage/    chunked persistence (eager and lazy loads), chunk loader,
              S5 drivers, encryption
  cbor/       the CBOR codec (a copy)
  api/        VectorDBSession
  parallel/   sharded search, training, build and persistence over a
              shard mesh (one device, or torch.distributed)
  convert.py  carries a JAX-built index's state across as numpy arrays
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from .api.session import VectorDBConfig, VectorDBError, VectorDBSession
from .index import (
    FlatIndex,
    HNSWConfig,
    HNSWIndex,
    HybridConfig,
    HybridIndex,
    IVFConfig,
    IVFIndex,
    SearchConfig,
    VectorStore,
)

__version__ = "0.5.0"

__all__ = [
    "VectorDBSession", "VectorDBConfig", "VectorDBError", "HybridIndex",
    "HybridConfig", "SearchConfig", "FlatIndex", "IVFIndex", "IVFConfig",
    "HNSWIndex", "HNSWConfig", "VectorStore", "__version__",
]
