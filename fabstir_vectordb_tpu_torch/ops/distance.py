"""Batched distances as plain PyTorch (the JAX package's ``ops/distance.py``).

Conventions as there: "euclidean" is *squared* L2 inside the engine (the
API takes the square root), "cosine" is 1 - cos, "dot" is the negative
inner product (smaller is better everywhere). The f32 products run in full
f32: the device policy turns TF32 off (``utils.device``).

The reference's ``compute_dtype=bfloat16`` (a bf16 serving mirror) is
``round_query`` here: bf16 rows are upcast exactly and the query is rounded
to bf16 in the product only, with f32 accumulation; |q|^2 comes from the
f32 query and x_sq stays as given (the f32 host rows' norms).
"""
from __future__ import annotations

import numpy as np
import torch

METRICS = ("euclidean", "cosine", "dot")


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, shape [N]."""
    x = x.float()
    return (x * x).sum(-1)


def pairwise_dot(q: torch.Tensor, x: torch.Tensor,
                 round_query: bool = False) -> torch.Tensor:
    """Inner products: [B, D] x [N, D] -> [B, N] in f32 (bf16 rows upcast;
    ``round_query`` rounds q to bf16 first)."""
    qd = q.to(torch.bfloat16).float() if round_query else q.float()
    return qd @ x.float().T


def pairwise_sq_l2(q: torch.Tensor, x: torch.Tensor,
                   x_sq: torch.Tensor | None = None,
                   round_query: bool = False) -> torch.Tensor:
    """[B, N] squared euclidean distances via |q|^2 - 2 q.x + |x|^2,
    clamped at 0."""
    if x_sq is None:
        x_sq = squared_norms(x)
    q_sq = squared_norms(q)
    d = q_sq[:, None] - 2.0 * pairwise_dot(q, x, round_query) + x_sq[None, :]
    return d.clamp_min(0.0)


def pairwise_cosine_dist(q: torch.Tensor, x: torch.Tensor,
                         x_sq: torch.Tensor | None = None,
                         round_query: bool = False) -> torch.Tensor:
    """Cosine distances 1 - cos(q, x); a zero-norm row is at distance 1."""
    if x_sq is None:
        x_sq = squared_norms(x)
    q_sq = squared_norms(q)
    denom = (q_sq[:, None] * x_sq[None, :]).clamp_min(1e-30).sqrt()
    return 1.0 - pairwise_dot(q, x, round_query) / denom


def pairwise_distance(q: torch.Tensor, x: torch.Tensor,
                      metric: str = "euclidean",
                      x_sq: torch.Tensor | None = None,
                      round_query: bool = False) -> torch.Tensor:
    """Dispatch on metric; euclidean returns *squared* L2."""
    if metric == "euclidean":
        return pairwise_sq_l2(q, x, x_sq, round_query)
    if metric == "cosine":
        return pairwise_cosine_dist(q, x, x_sq, round_query)
    if metric == "dot":
        return -pairwise_dot(q, x, round_query)
    raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")


def check_metric(metric: str) -> str:
    if metric not in METRICS:
        raise ValueError(
            f"unknown metric {metric!r}; expected one of {METRICS}")
    return metric


def finalize_distance(d: np.ndarray, metric: str) -> np.ndarray:
    """The user-facing distance of an engine distance (numpy, as the
    engines return them): the square root of a squared euclidean one
    (clamped at 0), cosine and dot as they are."""
    if metric != "euclidean":
        return d
    return np.sqrt(np.maximum(d, 0.0))


def inner_product_to_cosine(ip, a: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """A raw inner product as cosine similarity; 0 where either vector has
    zero norm."""
    denom = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)
    ip = torch.as_tensor(ip, dtype=denom.dtype)
    return torch.where(denom > 0, ip / denom.clamp_min(1e-30),
                       torch.zeros_like(denom))


def angular_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """arccos of the clamped cosine similarity, in [0, pi]."""
    ip = (a * b).sum(-1)
    cos = inner_product_to_cosine(ip, a, b)
    return torch.arccos(cos.clamp(-1.0, 1.0))


# the metrics' codes in the kernels' C interface (csrc/common.cuh)
METRIC_CODE = {"euclidean": 0, "cosine": 1, "dot": 2}
