from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.network import (  # noqa: F401
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (  # noqa: F401
    ComputationGraphConfiguration,
    GraphBuilder,
)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (  # noqa: F401
    DuplicateToTimeSeriesVertex,
    ElementWiseVertex,
    L2NormalizeVertex,
    L2Vertex,
    LastTimeStepVertex,
    MergeVertex,
    PoolHelperVertex,
    PreprocessorVertex,
    ReshapeVertex,
    ScaleVertex,
    ShiftVertex,
    StackVertex,
    SubsetVertex,
    UnstackVertex,
)
