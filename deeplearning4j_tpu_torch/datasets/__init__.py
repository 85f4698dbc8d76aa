"""Datasets (counterpart of deeplearning4j_tpu/datasets/): DataSet
containers and the iterators the training engine consumes. Fetchers,
normalizers and record readers wait (ROADMAP queue 10)."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    AsyncDataSetIterator,
    DataSetIterator,
    DevicePrefetchIterator,
    ListDataSetIterator,
)
