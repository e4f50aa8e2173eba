"""IVF (inverted-file) index: k-means coarse quantizer + membership.

The JAX package's ``index/ivf.py`` as far as the flat-regime slice needs
it: training (k-means, K6), centroid install, assignment of rows to lists,
removal, membership masks and counters. The probed list scan
(``ivf_search_kernel``), list tiles and balancing come with the pruned
serving regime.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kmeans import assign_clusters, kmeans_train_stepped
from ..utils.padding import bucket, grow_rows
from ..utils.transfer import to_device
from .store import VectorStore, serving_mirror


class NotTrainedError(RuntimeError):
    pass


class TrainingError(ValueError):
    pass


@dataclass
class IVFConfig:
    n_clusters: int = 256
    n_probe: int = 16
    train_size: int = 10_000
    max_iterations: int = 25
    seed: int = 42


@dataclass
class TrainStats:
    iterations: int
    converged: bool
    final_error: float


class IVFIndex:
    """Inverted-file index over a shared VectorStore."""

    # rows per assignment launch: bounds the gathered [rows, D] transient
    _ASSIGN_CHUNK = 1_048_576

    def __init__(self, store: VectorStore, config: IVFConfig | None = None):
        self.store = store
        self.config = config or IVFConfig()
        self.centroids: np.ndarray | None = None  # [C, D] f32
        # row -> cluster id; -1 means "not a member of this index"
        self.assignments = np.full(store.capacity, -1, np.int32)
        self.trained = False
        self._version = 0

    # ------------------------------------------------------------- training
    def train(self, vectors: np.ndarray) -> TrainStats:
        """k-means train the coarse quantizer; does NOT insert the vectors."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2:
            raise TrainingError("training data must be [n, dim]")
        if vectors.shape[0] < self.config.n_clusters:
            raise TrainingError(
                f"need at least n_clusters={self.config.n_clusters} training "
                f"vectors, got {vectors.shape[0]}")
        if vectors.shape[1] != self.store.dim:
            raise TrainingError(
                f"training dim {vectors.shape[1]} != store dim {self.store.dim}")
        n = min(vectors.shape[0], self.config.train_size)
        # the same masked power-of-two padding as the reference, so both
        # train on the same [n_pad, D] sample
        n_pad = bucket(n, minimum=min(1024, n))
        if vectors.shape[0] > n:
            sel = np.random.default_rng(self.config.seed).choice(
                vectors.shape[0], n, replace=False)
            sample = vectors[np.sort(sel)]
        else:
            sample = vectors[:n]
        if n_pad > n:
            sample = np.concatenate(
                [sample, np.zeros((n_pad - n, sample.shape[1]), np.float32)])
        dev = self.store.device
        res = kmeans_train_stepped(
            self.config.seed, to_device(sample, dev),
            torch.arange(n_pad, device=dev) < n,
            n_clusters=self.config.n_clusters,
            max_iterations=self.config.max_iterations)
        self.centroids = res.centroids.cpu().numpy()
        self.trained = True
        self._version += 1
        return TrainStats(res.iterations, res.converged, res.final_error)

    def set_trained(self, centroids: np.ndarray) -> None:
        """Install centroids directly (load path / tests); validates before
        mutating, and drops assignments past the new cluster count."""
        cents = np.asarray(centroids, np.float32)
        if cents.ndim != 2 or cents.shape[1] != self.store.dim:
            raise TrainingError("centroids must be [C, dim]")
        self.centroids = cents
        self.assignments[self.assignments >= cents.shape[0]] = -1
        self.trained = True
        self._version += 1

    # ------------------------------------------------------------- mutation
    def _ensure_capacity(self) -> None:
        if self.assignments.shape[0] < self.store.capacity:
            self.assignments = grow_rows(
                self.assignments, self.store.capacity, fill=-1)

    def insert_rows(self, rows: np.ndarray) -> None:
        """Assign store rows to their nearest centroid, gathering them from
        the device mirror (only row indices go up)."""
        if not self.trained:
            raise NotTrainedError("IVF index is not trained")
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        self._ensure_capacity()
        dev = self.store.device
        cents = to_device(self.centroids, dev)
        mirror = serving_mirror(self.store)
        for lo in range(0, rows.size, self._ASSIGN_CHUNK):
            sub = rows[lo: lo + self._ASSIGN_CHUNK]
            vecs = mirror.x[to_device(sub, dev)]
            assign, _ = assign_clusters(vecs, cents)
            self.assignments[sub] = assign.cpu().numpy()
        self._version += 1

    def remove_rows(self, rows: np.ndarray) -> None:
        self._ensure_capacity()
        self.assignments[np.asarray(rows, np.int64)] = -1
        self._version += 1

    def member_mask(self, n: int | None = None) -> np.ndarray:
        """[n or store.capacity] bool membership (non-mutating)."""
        assign = self.assignments  # local ref: growth replaces the object
        if n is None:
            n = max(self.store.capacity, assign.shape[0])
        m = np.zeros(n, bool)
        c = min(n, assign.shape[0])
        m[:c] = assign[:c] >= 0
        return m

    @property
    def active_count(self) -> int:
        act = self.store.active_mask()
        m = self.member_mask(act.shape[0])
        return int((m & act).sum())

    @property
    def deleted_count(self) -> int:
        deleted = self.store.deleted
        count = min(self.store.count, deleted.shape[0])
        m = self.member_mask(count)
        return int((m & deleted[:count]).sum())

    def vacuum(self) -> int:
        """Drop tombstoned/deleted rows from the lists. Returns count removed."""
        self._ensure_capacity()
        dead = np.zeros(self.assignments.shape[0], bool)
        dead[: self.store.count] = self.store.deleted[: self.store.count]
        removed = int(((self.assignments >= 0) & dead).sum())
        self.assignments[dead] = -1
        self._version += 1
        return removed

    def memory_usage_bytes(self) -> int:
        total = self.assignments.nbytes
        if self.centroids is not None:
            total += self.centroids.nbytes
        return int(total)
