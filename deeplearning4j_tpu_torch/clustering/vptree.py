"""VPTree: exact metric-tree nearest-neighbor search (host-side; a copy
of deeplearning4j_tpu/clustering/vptree.py).

Parity: nearestneighbor-core clustering/vptree/VPTree.java — vantage
point tree with median-radius split, priority-queue k-NN search with
triangle-inequality pruning. Kept host-side/NumPy: single-query exact
search is pointer-chasing, which is the one shape the card's path
(distances.knn) does NOT cover; batch workloads should use that
instead."""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

_HOST_METRICS = {
    "euclidean": lambda a, b: float(np.linalg.norm(a - b)),
    "manhattan": lambda a, b: float(np.sum(np.abs(a - b))),
    "cosine": lambda a, b: float(
        1.0 - np.dot(a, b)
        / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)),
}


class _Node:
    __slots__ = ("index", "radius", "inside", "outside")

    def __init__(self, index, radius=0.0, inside=None, outside=None):
        self.index = index
        self.radius = radius
        self.inside = inside
        self.outside = outside


class VPTree:
    """Build O(N log N), exact k-NN query with pruning.

    `items`: [N, D] array. `metric`: euclidean | manhattan | cosine
    (ref VPTree.java distance functions)."""

    def __init__(self, items, metric: str = "euclidean", seed: int = 0):
        self.items = np.asarray(items, np.float64)
        if self.items.ndim != 2:
            raise ValueError("VPTree needs an [N, D] matrix")
        if metric not in _HOST_METRICS:
            raise ValueError(
                f"unknown metric '{metric}'; known {sorted(_HOST_METRICS)}")
        self.metric = metric
        self._dist = _HOST_METRICS[metric]
        self._rng = np.random.default_rng(seed)
        self.root = self._build(list(range(len(self.items))))

    def _build(self, idxs) -> Optional[_Node]:
        if not idxs:
            return None
        if len(idxs) == 1:
            return _Node(idxs[0])
        vp_pos = self._rng.integers(0, len(idxs))
        vp = idxs[vp_pos]
        rest = [i for j, i in enumerate(idxs) if j != vp_pos]
        dists = np.array([self._dist(self.items[vp], self.items[i])
                          for i in rest])
        radius = float(np.median(dists))
        inside = [i for i, d in zip(rest, dists) if d <= radius]
        outside = [i for i, d in zip(rest, dists) if d > radius]
        return _Node(vp, radius, self._build(inside), self._build(outside))

    def search(self, query, k: int = 1):
        """Exact k nearest neighbors. Returns (indices, distances),
        nearest first (ref VPTree.java search)."""
        query = np.asarray(query, np.float64)
        k = min(k, len(self.items))
        heap: list = []   # max-heap via negated distance
        tau = [np.inf]

        def visit(node):
            if node is None:
                return
            d = self._dist(query, self.items[node.index])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d <= node.radius:
                visit(node.inside)
                if d + tau[0] > node.radius:   # ball crosses the shell
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.radius:
                    visit(node.inside)

        visit(self.root)
        pairs = sorted((-nd, i) for nd, i in heap)
        return ([i for _, i in pairs], [d for d, _ in pairs])
