from deeplearning4j_tpu_torch.nn.layers.base import Layer, BaseLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.core import (  # noqa: F401
    ActivationLayer,
    DenseLayer,
    GlobalPoolingLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.conv import (  # noqa: F401
    ConvolutionLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalization  # noqa: F401
