"""DeepWalk: graph vertex embeddings via random walks + skip-gram
(counterpart of deeplearning4j_tpu/graph/deepwalk.py).

Parity: deeplearning4j-graph graph/models/deepwalk/DeepWalk.java —
random-walk corpus (RandomWalkIterator) fed to a skip-gram trainer with
hierarchical softmax over a vertex Huffman tree (GraphHuffman.java).

Reuses the SequenceVectors trainer (the steps Word2Vec uses: the scan
tier below 2048 vertices, the dense tier's HS skip-gram body above) with
vertex ids as tokens — the reference's bespoke GraphHuffman/gradient code
collapses into the shared path (build_huffman + the HS steps). The walks
run on the host; the tables train on `device` (None: CUDA)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walks import RandomWalkIterator
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors


class DeepWalk:
    """ref DeepWalk.Builder: vectorSize, windowSize, learningRate;
    initialize(graph) + fit(walk_iterator) or the one-call
    fit_graph(graph, walk_length, walks_per_vertex)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, epochs: int = 1,
                 use_hierarchic_softmax: bool = True, negative: int = 0,
                 seed: int = 0, device=None):
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.use_hs = use_hierarchic_softmax
        self.negative = negative
        self.seed = seed
        self.device = device
        self._sv: Optional[SequenceVectors] = None
        self.graph: Optional[Graph] = None

    class Builder:
        def __init__(self):
            self._kw = {}

        def vector_size(self, v):
            self._kw["vector_size"] = v
            return self

        def window_size(self, v):
            self._kw["window_size"] = v
            return self

        def learning_rate(self, v):
            self._kw["learning_rate"] = v
            return self

        def seed(self, v):
            self._kw["seed"] = v
            return self

        def device(self, v):
            """Where the tables train (None: CUDA; "cpu" as asked)."""
            self._kw["device"] = v
            return self

        def build(self) -> "DeepWalk":
            return DeepWalk(**self._kw)

    # ----------------------------------------------------------------- api
    def initialize(self, graph: Graph) -> "DeepWalk":
        self.graph = graph
        self._sv = SequenceVectors(
            layer_size=self.vector_size, window=self.window_size,
            negative=self.negative,
            use_hierarchic_softmax=self.use_hs,
            min_word_frequency=1, learning_rate=self.learning_rate,
            epochs=self.epochs, seed=self.seed, device=self.device)
        return self

    def fit(self, walks) -> "DeepWalk":
        """Train on an iterator of walks (lists of vertex indices)
        (ref DeepWalk.fit(GraphWalkIterator))."""
        if self._sv is None:
            raise ValueError("call initialize(graph) first")
        self._sv.fit([[str(v) for v in walk] for walk in walks])
        return self

    def fit_graph(self, graph: Graph, walk_length: int = 40,
                  walks_per_vertex: int = 5) -> "DeepWalk":
        self.initialize(graph)
        walks = RandomWalkIterator(graph, walk_length,
                                   walks_per_vertex, seed=self.seed)
        return self.fit(walks)

    # ------------------------------------------------------------- vectors
    def get_vertex_vector(self, v: int) -> np.ndarray:
        vec = self._sv.get_word_vector(str(v))
        if vec is None:
            raise KeyError(f"vertex {v} not in the trained vocabulary")
        return vec

    def similarity(self, a: int, b: int) -> float:
        return self._sv.similarity(str(a), str(b))

    def verts_nearest(self, v: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in
                self._sv.words_nearest(str(v), top_n=top_n)]
