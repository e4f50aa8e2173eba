"""Batched distances as plain PyTorch (the JAX package's ``ops/distance.py``).

Conventions as there: "euclidean" is *squared* L2 inside the engine (the
API takes the square root), "cosine" is 1 - cos, "dot" is the negative
inner product (smaller is better everywhere). The f32 products run in full
f32: the device policy turns TF32 off (``utils.device``).
"""
from __future__ import annotations

import torch

METRICS = ("euclidean", "cosine", "dot")


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, shape [N]."""
    x = x.float()
    return (x * x).sum(-1)


def pairwise_sq_l2(q: torch.Tensor, x: torch.Tensor,
                   x_sq: torch.Tensor | None = None,
                   round_query: bool = False) -> torch.Tensor:
    """[B, N] squared euclidean distances via |q|^2 - 2 q.x + |x|^2,
    clamped at 0. bf16 rows are upcast exactly; ``round_query`` rounds q to
    bf16 in the product only (the reference's compute_dtype=bfloat16:
    |q|^2 from the f32 q, x_sq as given, f32 accumulation)."""
    if x_sq is None:
        x_sq = squared_norms(x)
    q_sq = squared_norms(q)
    qd = q.to(torch.bfloat16).float() if round_query else q.float()
    d = q_sq[:, None] - 2.0 * (qd @ x.float().T) + x_sq[None, :]
    return d.clamp_min(0.0)


def pairwise_distance(q: torch.Tensor, x: torch.Tensor,
                      metric: str = "euclidean",
                      x_sq: torch.Tensor | None = None) -> torch.Tensor:
    if metric == "euclidean":
        return pairwise_sq_l2(q, x, x_sq)
    if metric == "cosine":
        if x_sq is None:
            x_sq = squared_norms(x)
        q_sq = squared_norms(q)
        denom = (q_sq[:, None] * x_sq[None, :]).clamp_min(1e-30).sqrt()
        return 1.0 - (q.float() @ x.float().T) / denom
    if metric == "dot":
        return -(q.float() @ x.float().T)
    raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
