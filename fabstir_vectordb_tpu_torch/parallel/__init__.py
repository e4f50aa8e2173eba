"""The multi-shard layer (K15): sharded search, Lloyd, build and
reshardable persistence over a shard mesh on one device or over
``torch.distributed`` (the JAX package's ``parallel/``)."""
from .mesh import DATA_AXIS, DistMesh, LocalMesh, make_mesh, cpu_mesh
from .sharded import (
    sharded_flat_search,
    sharded_projected_search,
    sharded_ivf_search,
    sharded_lloyd_step,
    sharded_kmeans_train,
    sharded_hnsw_search,
    sharded_hybrid_search,
    ShardedIVFState,
    shard_ivf_state,
    ShardedHNSWState,
    shard_hnsw_state,
)
from .ingest import ShardedBuilder, sharded_assign_clusters
from .persistence import (
    save_sharded_flat,
    load_sharded_flat,
    save_sharded_ivf,
    load_sharded_ivf,
    ShardedPersistenceError,
)

__all__ = [
    "ShardedBuilder",
    "sharded_assign_clusters",
    "save_sharded_flat",
    "load_sharded_flat",
    "save_sharded_ivf",
    "load_sharded_ivf",
    "ShardedPersistenceError",
    "make_mesh",
    "cpu_mesh",
    "sharded_flat_search",
    "sharded_projected_search",
    "sharded_ivf_search",
    "sharded_lloyd_step",
    "sharded_kmeans_train",
    "sharded_hnsw_search",
    "sharded_hybrid_search",
    "ShardedIVFState",
    "shard_ivf_state",
    "ShardedHNSWState",
    "shard_hnsw_state",
]
