"""The port's graph package (deeplearning4j_tpu_torch/graph/) on its own,
on the CPU: the counterparts of tests/test_graph_module.py (ref:
deeplearning4j-graph test suites — graph construction, random walks,
DeepWalk and Node2Vec embedding quality), the trainers with
device="cpu". tests/test_torch_nlp_parity.py holds the walks and the
embeddings against the JAX package."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.graph import (
    DeepWalk,
    Graph,
    RandomWalkIterator,
    WeightedRandomWalkIterator,
    load_delimited_edge_list,
    load_weighted_edge_list,
)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_graph_basics():
    g = Graph(4)
    g.add_edge(0, 1)
    g.add_edge(1, 2, weight=2.0)
    assert g.num_vertices() == 4
    assert sorted(g.connected_vertices(1)) == [0, 2]
    assert g.degree(1) == 2
    assert g.degree(3) == 0
    with pytest.raises(ValueError, match="out of range"):
        g.add_edge(0, 9)


def test_directed_graph():
    g = Graph(3, directed=True)
    g.add_edge(0, 1)
    assert g.connected_vertices(0) == [1]
    assert g.connected_vertices(1) == []


def test_edge_list_loaders(tmp_path):
    p = tmp_path / "edges.csv"
    p.write_text("# comment\n0,1\n1,2\n2,0\n")
    g = load_delimited_edge_list(str(p), 3)
    assert g.degree(0) == 2
    pw = tmp_path / "wedges.csv"
    pw.write_text("0,1,0.5\n1,2,2.5\n")
    gw = load_weighted_edge_list(str(pw), 3)
    assert gw.edges_from(1)[0].weight in (0.5, 2.5)


def test_random_walks_cover_graph():
    g = Graph(6)
    for i in range(5):
        g.add_edge(i, i + 1)
    walks = list(RandomWalkIterator(g, walk_length=5, walks_per_vertex=2,
                                    seed=1))
    assert len(walks) == 12
    assert all(len(w) == 5 for w in walks)
    # consecutive vertices are actually adjacent
    for w in walks:
        for a, b in zip(w, w[1:]):
            assert b in g.connected_vertices(a) or a == b


def test_walk_self_loop_on_disconnected():
    g = Graph(3)
    g.add_edge(0, 1)
    walks = list(RandomWalkIterator(g, walk_length=4, seed=0))
    w2 = next(w for w in walks if w[0] == 2)   # isolated vertex
    assert w2 == [2, 2, 2, 2]


def test_weighted_walk_prefers_heavy_edges():
    g = Graph(3)
    g.add_edge(0, 1, weight=100.0)
    g.add_edge(0, 2, weight=0.01)
    hits = {1: 0, 2: 0}
    for w in WeightedRandomWalkIterator(g, walk_length=2,
                                        walks_per_vertex=60, seed=3):
        if w[0] == 0:
            hits[w[1]] += 1
    assert hits[1] > hits[2] * 5


def test_deepwalk_neighbors_embed_close():
    """Two cliques joined by one bridge edge: same-clique vertices must
    rank nearer than cross-clique (ref DeepWalk quality tests)."""
    n = 10
    g = Graph(n)
    for i in range(5):
        for j in range(i + 1, 5):
            g.add_edge(i, j)
            g.add_edge(i + 5, j + 5)
    g.add_edge(4, 5)   # bridge

    dw = (DeepWalk.Builder().vector_size(16).window_size(3)
          .learning_rate(0.05).seed(7).device("cpu").build())
    dw.fit_graph(g, walk_length=20, walks_per_vertex=20)

    v = dw.get_vertex_vector(0)
    assert v.shape == (16,)
    same = np.mean([dw.similarity(0, j) for j in range(1, 5)])
    other = np.mean([dw.similarity(0, j) for j in range(6, 10)])
    assert same > other
    nearest = dw.verts_nearest(0, top_n=4)
    assert len(set(nearest) & {1, 2, 3, 4}) >= 3


def test_node2vec_biased_walks_and_embeddings():
    from deeplearning4j_tpu_torch.graph import Node2Vec, Node2VecWalkIterator

    n = 10
    g = Graph(n)
    for i in range(5):
        for j in range(i + 1, 5):
            g.add_edge(i, j)
            g.add_edge(i + 5, j + 5)
    g.add_edge(4, 5)

    # low q -> exploratory (DFS-ish); walks stay valid paths
    walks = list(Node2VecWalkIterator(g, walk_length=10,
                                      walks_per_vertex=2, p=0.5, q=2.0,
                                      seed=2))
    assert len(walks) == 20
    for w in walks:
        for a, b in zip(w, w[1:]):
            assert b in g.connected_vertices(a) or a == b

    nv = Node2Vec(p=0.5, q=2.0, vector_size=16, window_size=3,
                  learning_rate=0.05, seed=4, device="cpu")
    nv.fit_graph(g, walk_length=20, walks_per_vertex=20)
    same = np.mean([nv.similarity(0, j) for j in range(1, 5)])
    other = np.mean([nv.similarity(0, j) for j in range(6, 10)])
    assert same > other
