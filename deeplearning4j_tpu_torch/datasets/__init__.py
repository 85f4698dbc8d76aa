"""Datasets (counterpart of deeplearning4j_tpu/datasets/): DataSet
containers, iterators (with async prefetch and device staging), fetchers,
normalizers and record readers."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    AsyncDataSetIterator,
    BenchmarkDataSetIterator,
    DataSetIterator,
    DevicePrefetchIterator,
    EarlyTerminationDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
)
from deeplearning4j_tpu_torch.datasets.fetchers import (  # noqa: F401
    CifarDataSetIterator,
    CurvesDataSetIterator,
    IrisDataSetIterator,
    LFWDataSetIterator,
    MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.normalizers import (  # noqa: F401
    ImagePreProcessingScaler,
    NormalizerMinMaxScaler,
    NormalizerStandardize,
    VGG16ImagePreProcessor,
)
from deeplearning4j_tpu_torch.datasets.records import (  # noqa: F401
    CSVRecordReader,
    CSVSequenceRecordReader,
    CollectionRecordReader,
    CollectionSequenceRecordReader,
    RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)
