"""Random-walk sequence generators over a Graph.

The port's counterpart (host-only NumPy; a copy of
deeplearning4j_tpu/graph/walks.py: the same walks from the same seed).

Parity: deeplearning4j-graph graph/iterator/RandomWalkIterator.java
(uniform next-hop, NoEdgeHandling SELF_LOOP_ON_DISCONNECTED) and
WeightedRandomWalkIterator.java (weight-proportional next-hop).
Each walk is a list of vertex indices, usable directly as a
"sentence" for SequenceVectors/DeepWalk."""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph


class RandomWalkIterator:
    """Uniform random walks of fixed length starting at every vertex
    (optionally repeated `walks_per_vertex` times)."""

    def __init__(self, graph: Graph, walk_length: int,
                 walks_per_vertex: int = 1, seed: int = 0,
                 weighted: bool = False):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.walks_per_vertex = int(walks_per_vertex)
        self.seed = seed
        self.weighted = weighted

    def _next_hop(self, rng, v: int) -> Optional[int]:
        edges = self.graph.edges_from(v)
        if not edges:
            return v   # SELF_LOOP_ON_DISCONNECTED
        if self.weighted:
            w = np.array([e.weight for e in edges], np.float64)
            s = w.sum()
            if s <= 0:
                return edges[rng.integers(len(edges))].to
            return edges[rng.choice(len(edges), p=w / s)].to
        return edges[rng.integers(len(edges))].to

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        n = self.graph.num_vertices()
        for _ in range(self.walks_per_vertex):
            order = rng.permutation(n)
            for start in order:
                walk = [int(start)]
                v = int(start)
                for _ in range(self.walk_length - 1):
                    v = self._next_hop(rng, v)
                    walk.append(int(v))
                yield walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """ref WeightedRandomWalkIterator.java — next hop proportional to
    edge weight."""

    def __init__(self, graph: Graph, walk_length: int,
                 walks_per_vertex: int = 1, seed: int = 0):
        super().__init__(graph, walk_length, walks_per_vertex, seed,
                         weighted=True)


class Node2VecWalkIterator(RandomWalkIterator):
    """Second-order biased walks (Grover & Leskovec node2vec; the
    reference's models/node2vec/ walk role): hop weight from v given the
    previous vertex t is edge_weight x (1/p if returning to t, 1 if the
    candidate neighbors t, else 1/q)."""

    def __init__(self, graph: Graph, walk_length: int,
                 walks_per_vertex: int = 1, p: float = 1.0, q: float = 1.0,
                 seed: int = 0):
        super().__init__(graph, walk_length, walks_per_vertex, seed)
        self.p = float(p)
        self.q = float(q)
        self._nbrs = {v: set(graph.connected_vertices(v))
                      for v in range(graph.num_vertices())}

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        n = self.graph.num_vertices()
        for _ in range(self.walks_per_vertex):
            for start in rng.permutation(n):
                walk = [int(start)]
                prev = None
                v = int(start)
                for _ in range(self.walk_length - 1):
                    edges = self.graph.edges_from(v)
                    if not edges:
                        walk.append(v)   # SELF_LOOP_ON_DISCONNECTED
                        continue
                    w = np.empty(len(edges), np.float64)
                    for i, e in enumerate(edges):
                        bias = 1.0
                        if prev is not None:
                            if e.to == prev:
                                bias = 1.0 / self.p
                            elif e.to in self._nbrs[prev]:
                                bias = 1.0
                            else:
                                bias = 1.0 / self.q
                        w[i] = max(e.weight, 0.0) * bias
                    s = w.sum()
                    nxt = (edges[rng.integers(len(edges))].to if s <= 0
                           else edges[rng.choice(len(edges), p=w / s)].to)
                    prev, v = v, int(nxt)
                    walk.append(v)
                yield walk
