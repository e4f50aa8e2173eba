"""PCA projection for reduced-rank serving, host numpy (a copy of the JAX
package's ``ops/projection.py``).

L2 distances are translation-invariant, so mean-centering before projection
loses nothing; the top-r eigenbasis is the best r-dim linear map in
expected squared distance distortion. The searcher fits its own projection
in ``index/fused.py`` (it needs the eigenvalues for the auto rank); these
are the standalone helpers.
"""
from __future__ import annotations

import numpy as np


def pca_basis(sample: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """PCA of ``sample`` [S, D]: (mu [D] f32, eigenvalues [D] descending,
    eigenvectors [D, D] as columns in the same order), from the f32
    covariance solved in f64."""
    sample = np.asarray(sample, np.float32)
    mu = sample.mean(axis=0)
    xc = sample - mu
    cov = (xc.T @ xc).astype(np.float64)  # [D, D]; f64 eigh for stability
    evals, evecs = np.linalg.eigh(cov)  # ascending
    return mu.astype(np.float32), evals[::-1], evecs[:, ::-1]


def fit_pca(sample: np.ndarray, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """Fit a PCA projection on ``sample`` [S, D].

    Returns (mu [D] f32, p [D, rank] f32) — project with ``(x - mu) @ p``.
    Rank is clamped to min(D, S).
    """
    s, d = np.shape(sample)
    rank = max(1, min(rank, d, s))
    mu, _, basis = pca_basis(sample)
    return mu, np.ascontiguousarray(basis[:, :rank], np.float32)


def project(x: np.ndarray, mu: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Project rows: [N, D] -> [N, rank] (host BLAS; chunked to bound RSS)."""
    x = np.asarray(x, np.float32)
    out = np.empty((x.shape[0], p.shape[1]), np.float32)
    chunk = 1_048_576
    for lo in range(0, x.shape[0], chunk):
        out[lo: lo + chunk] = (x[lo: lo + chunk] - mu) @ p
    return out
