"""Distances, top-k selection, k-means and quantization on PyTorch, with
hand-written CUDA kernels on the card."""
from .distance import (
    pairwise_sq_l2,
    pairwise_dot,
    pairwise_cosine_dist,
    pairwise_distance,
    squared_norms,
    inner_product_to_cosine,
    angular_distance,
    METRICS,
)
from .topk import masked_topk, merge_topk, chunked_topk, StreamingTopK
from .kmeans import (kmeans_pp_init, lloyd_step, kmeans_train,
                     kmeans_train_stepped, assign_clusters)

__all__ = [
    "pairwise_sq_l2",
    "pairwise_dot",
    "pairwise_cosine_dist",
    "pairwise_distance",
    "squared_norms",
    "METRICS",
    "inner_product_to_cosine",
    "angular_distance",
    "masked_topk",
    "merge_topk",
    "chunked_topk",
    "StreamingTopK",
    "kmeans_pp_init",
    "lloyd_step",
    "kmeans_train",
    "kmeans_train_stepped",
    "assign_clusters",
]
