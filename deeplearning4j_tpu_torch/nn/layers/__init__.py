from deeplearning4j_tpu_torch.nn.layers.base import Layer, BaseLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.core import (  # noqa: F401
    ActivationLayer,
    DenseLayer,
    DropoutLayer,
    GlobalPoolingLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.conv import (  # noqa: F401
    ConvolutionLayer,
    LocalResponseNormalization,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalization  # noqa: F401
