"""Delimited edge-list loaders.

The port's counterpart (host-only; a copy of
deeplearning4j_tpu/graph/loader.py).

Parity: deeplearning4j-graph data/GraphLoader.java +
EdgeLineProcessor/WeightedEdgeLineProcessor — 'from<sep>to[<sep>weight]'
lines, '#' comments skipped."""

from __future__ import annotations

from deeplearning4j_tpu_torch.graph.graph import Graph


def _lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def load_delimited_edge_list(path: str, n_vertices: int,
                             delimiter: str = ",",
                             directed: bool = False) -> Graph:
    g = Graph(n_vertices, directed=directed)
    for line in _lines(path):
        parts = line.split(delimiter)
        if len(parts) < 2:
            raise ValueError(f"bad edge line: {line!r}")
        g.add_edge(int(parts[0]), int(parts[1]))
    return g


def load_weighted_edge_list(path: str, n_vertices: int,
                            delimiter: str = ",",
                            directed: bool = False) -> Graph:
    g = Graph(n_vertices, directed=directed)
    for line in _lines(path):
        parts = line.split(delimiter)
        if len(parts) < 3:
            raise ValueError(f"bad weighted edge line: {line!r}")
        g.add_edge(int(parts[0]), int(parts[1]), float(parts[2]))
    return g
