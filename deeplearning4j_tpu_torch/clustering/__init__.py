"""Clustering (counterpart of deeplearning4j_tpu/clustering/): batched
distances and k-NN, the host VP and KD trees, k-means, t-SNE and the
nearest-neighbour server."""

from deeplearning4j_tpu_torch.clustering.distances import (  # noqa: F401
    knn,
    pairwise_distance,
)
from deeplearning4j_tpu_torch.clustering.vptree import VPTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.kmeans import (  # noqa: F401
    Cluster,
    ClusterSet,
    KMeansClustering,
)
from deeplearning4j_tpu_torch.clustering.tsne import Tsne  # noqa: F401
from deeplearning4j_tpu_torch.clustering.server import (  # noqa: F401
    NearestNeighborsClient,
    NearestNeighborsServer,
)
