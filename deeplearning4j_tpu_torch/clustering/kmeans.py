"""K-means clustering, batched on the card (counterpart of
deeplearning4j_tpu/clustering/kmeans.py).

Parity: nearestneighbor-core clustering/kmeans/KMeansClustering.java +
the BaseClusteringAlgorithm strategy loop (iterate until max iterations
or the centres stop moving). Each Lloyd iteration is a handful of
device ops — assignment through the pairwise distance matrix, the
centroid update as a one-hot matmul (a fixed summation order, no
atomics) — instead of the reference's per-point loops. k-means++
seeding draws from a NumPy generator, as the JAX package's does, so a
seed picks the same centres on the card, on the CPU and in the JAX
package (up to a draw that lands within rounding of a boundary of the
f32 distance weights).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.distances import (
    as_points,
    pairwise_distance,
)


@dataclass
class Cluster:
    center: np.ndarray
    point_indices: List[int] = field(default_factory=list)


@dataclass
class ClusterSet:
    clusters: List[Cluster]
    assignments: np.ndarray    # [N] cluster index per point
    inertia: float             # sum of squared distances to centers

    @property
    def centers(self) -> np.ndarray:
        return np.stack([c.center for c in self.clusters])


def _lloyd_step(points, centers, metric):
    """One Lloyd iteration: (new centres, assignment, inertia, shift)."""
    d = pairwise_distance(points, centers, metric)
    dmin, assign = torch.min(d, dim=1)   # first index on ties
    k = centers.shape[0]
    one_hot = torch.nn.functional.one_hot(assign, k).to(points.dtype)
    sums = one_hot.T @ points                                # [k,D]
    counts = torch.sum(one_hot, dim=0)[:, None]
    new_centers = torch.where(counts > 0,
                              sums / torch.clamp_min(counts, 1.0), centers)
    inertia = (torch.sum(dmin ** 2) if metric == "euclidean"
               else torch.sum(dmin))
    shift = torch.max(torch.linalg.norm(new_centers - centers, dim=1))
    return new_centers, assign, inertia, shift


class KMeansClustering:
    """`KMeansClustering.setup(k, max_iterations, metric)` then
    `apply(points)` (ref KMeansClustering.setup/applyTo). `device` is
    where the Lloyd steps run (None: the card)."""

    def __init__(self, k: int, max_iterations: int = 100,
                 metric: str = "euclidean", tol: float = 1e-4,
                 seed: int = 0, device=None):
        self.k = int(k)
        self.max_iterations = max_iterations
        self.metric = metric
        self.tol = tol
        self.seed = seed
        self.device = device

    @classmethod
    def setup(cls, k: int, max_iterations: int = 100,
              metric: str = "euclidean", **kw) -> "KMeansClustering":
        return cls(k, max_iterations, metric, **kw)

    def _init_centers(self, pts: torch.Tensor) -> np.ndarray:
        """k-means++ seeding on the points' device; the draws come from
        `np.random.default_rng(seed)` (the JAX package's sequence)."""
        rng = np.random.default_rng(self.seed)
        n = pts.shape[0]
        chosen = [int(rng.integers(n))]
        d2_min = None
        for _ in range(1, self.k):
            # the min over all chosen centres, kept incrementally (an
            # elementwise min is exact, so this equals the full min)
            d2_new = pairwise_distance(pts, pts[chosen[-1:]],
                                       "sqeuclidean")[:, 0]
            d2_min = (d2_new if d2_min is None
                      else torch.minimum(d2_min, d2_new))
            d2 = d2_min.cpu().numpy()
            total = float(d2.sum())
            if total <= 1e-12:
                # all remaining points coincide with a chosen center
                # (duplicates): fall back to uniform choice
                chosen.append(int(rng.integers(n)))
                continue
            chosen.append(int(rng.choice(n, p=d2 / total)))
        return pts[chosen].cpu().numpy()

    def apply(self, points) -> ClusterSet:
        pts = as_points(points, self.device)
        if pts.shape[0] < self.k:
            raise ValueError(
                f"k={self.k} but only {pts.shape[0]} points")
        centers = torch.as_tensor(self._init_centers(pts), device=pts.device)
        assign = None
        inertia = np.inf
        for _ in range(self.max_iterations):
            centers, assign, inertia, shift = _lloyd_step(
                pts, centers, self.metric)
            if float(shift) < self.tol:
                break
        assign = assign.cpu().numpy()
        centers = centers.cpu().numpy()
        clusters = [Cluster(center=centers[i],
                            point_indices=list(np.where(assign == i)[0]))
                    for i in range(self.k)]
        return ClusterSet(clusters=clusters, assignments=assign,
                          inertia=float(inertia))
