"""Node2Vec: p/q-biased random walks + skip-gram vertex embeddings
(counterpart of deeplearning4j_tpu/graph/node2vec.py).

Parity: deeplearning4j-nlp models/node2vec/ (the reference's
Node2Vec sits on its SequenceVectors like this one) with the biased
walk policy from the node2vec paper; reuses DeepWalk's training path."""

from __future__ import annotations

from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walks import Node2VecWalkIterator


class Node2Vec(DeepWalk):
    """DeepWalk with second-order p/q-biased walks."""

    def __init__(self, p: float = 1.0, q: float = 1.0, **kw):
        super().__init__(**kw)
        self.p = p
        self.q = q

    def fit_graph(self, graph: Graph, walk_length: int = 40,
                  walks_per_vertex: int = 5) -> "Node2Vec":
        self.initialize(graph)
        walks = Node2VecWalkIterator(
            graph, walk_length, walks_per_vertex,
            p=self.p, q=self.q, seed=self.seed)
        return self.fit(walks)
