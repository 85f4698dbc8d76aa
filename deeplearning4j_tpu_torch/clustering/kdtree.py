"""KDTree: axis-aligned space-partitioning tree (host-side; a copy of
deeplearning4j_tpu/clustering/kdtree.py).

Parity: nearestneighbor-core kdtree/KDTree.java — insert, nearest
neighbor, and k-NN with hyperplane pruning. Euclidean only, like the
reference's HyperRect-based implementation."""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np


class _KDNode:
    __slots__ = ("point", "index", "left", "right")

    def __init__(self, point, index):
        self.point = point
        self.index = index
        self.left: Optional["_KDNode"] = None
        self.right: Optional["_KDNode"] = None


class KDTree:
    def __init__(self, dims: int):
        self.dims = int(dims)
        self.root: Optional[_KDNode] = None
        self.size = 0

    def insert(self, point, index: Optional[int] = None) -> int:
        """Insert a point; returns its index (ref KDTree.insert)."""
        point = np.asarray(point, np.float64)
        if point.shape != (self.dims,):
            raise ValueError(f"expected a {self.dims}-d point, "
                             f"got shape {point.shape}")
        if index is None:
            index = self.size
        node = _KDNode(point, index)
        self.size += 1
        if self.root is None:
            self.root = node
            return index
        cur, depth = self.root, 0
        while True:
            axis = depth % self.dims
            if point[axis] < cur.point[axis]:
                if cur.left is None:
                    cur.left = node
                    return index
                cur = cur.left
            else:
                if cur.right is None:
                    cur.right = node
                    return index
                cur = cur.right
            depth += 1

    def knn(self, query, k: int = 1):
        """Exact k-NN: (indices, distances) nearest first."""
        if self.root is None:
            return [], []
        query = np.asarray(query, np.float64)
        heap: list = []
        k = min(k, self.size)

        # explicit stack (insertion-order trees can be N deep; Python
        # recursion would overflow on sorted inserts)
        stack = [(self.root, 0, False)]
        while stack:
            node, depth, is_far = stack.pop()
            if node is None:
                continue
            if is_far:
                # deferred far-side: re-check the prune radius now
                _, parent_diff = is_far
                if len(heap) == k and abs(parent_diff) >= -heap[0][0]:
                    continue
            d = float(np.linalg.norm(query - node.point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            axis = depth % self.dims
            diff = query[axis] - node.point[axis]
            near, far = ((node.left, node.right) if diff < 0
                         else (node.right, node.left))
            # LIFO: push far first so near is fully explored before far
            stack.append((far, depth + 1, (True, diff)))
            stack.append((near, depth + 1, False))
        pairs = sorted((-nd, i) for nd, i in heap)
        return ([i for _, i in pairs], [d for d, _ in pairs])

    def nn(self, query):
        idx, dist = self.knn(query, 1)
        return (idx[0], dist[0]) if idx else (None, None)
