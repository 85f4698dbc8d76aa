"""Graph embeddings (counterpart of deeplearning4j_tpu/graph/): the
graph, its loaders and random walks stay host NumPy, as in the JAX
package; DeepWalk and Node2Vec train on the device through
nlp.SequenceVectors."""

from deeplearning4j_tpu_torch.graph.graph import Graph, Vertex, Edge  # noqa: F401
from deeplearning4j_tpu_torch.graph.loader import (  # noqa: F401
    load_delimited_edge_list,
    load_weighted_edge_list,
)
from deeplearning4j_tpu_torch.graph.walks import (  # noqa: F401
    Node2VecWalkIterator,
    RandomWalkIterator,
    WeightedRandomWalkIterator,
)
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk  # noqa: F401
from deeplearning4j_tpu_torch.graph.node2vec import Node2Vec  # noqa: F401
