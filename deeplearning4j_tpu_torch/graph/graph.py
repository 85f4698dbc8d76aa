"""In-memory (di)graph with optional edge weights.

The port's counterpart (host-only; a copy of
deeplearning4j_tpu/graph/graph.py).

Parity: deeplearning4j-graph graph/graph/Graph.java (IGraph API —
vertices, addEdge, getConnectedVertices, degree) with vertex payloads
(api/Vertex.java) and weighted edges (api/Edge.java)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional


@dataclass
class Vertex:
    idx: int
    value: Any = None


@dataclass
class Edge:
    frm: int
    to: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    """ref Graph.java — adjacency-list graph over integer vertex ids."""

    def __init__(self, n_vertices: int, directed: bool = False,
                 values: Optional[List[Any]] = None):
        if n_vertices <= 0:
            raise ValueError("graph needs at least one vertex")
        self.directed = directed
        self.vertices = [Vertex(i, values[i] if values else None)
                         for i in range(n_vertices)]
        self._adj: Dict[int, List[Edge]] = {i: [] for i in range(n_vertices)}

    def num_vertices(self) -> int:
        return len(self.vertices)

    def add_edge(self, frm: int, to: int, weight: float = 1.0):
        self._check(frm)
        self._check(to)
        e = Edge(frm, to, weight, self.directed)
        self._adj[frm].append(e)
        if not self.directed:
            self._adj[to].append(Edge(to, frm, weight, False))
        return e

    def _check(self, v: int):
        if not 0 <= v < len(self.vertices):
            raise ValueError(
                f"vertex {v} out of range [0, {len(self.vertices)})")

    def edges_from(self, v: int) -> List[Edge]:
        self._check(v)
        return list(self._adj[v])

    def connected_vertices(self, v: int) -> List[int]:
        """ref Graph.getConnectedVertices."""
        return [e.to for e in self.edges_from(v)]

    def degree(self, v: int) -> int:
        self._check(v)
        return len(self._adj[v])
