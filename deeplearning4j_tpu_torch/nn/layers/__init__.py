from deeplearning4j_tpu_torch.nn.layers.base import Layer, BaseLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.core import (  # noqa: F401
    ActivationLayer,
    CenterLossOutputLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    GlobalPoolingLayer,
    LossLayer,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.conv import (  # noqa: F401
    Convolution1DLayer,
    ConvolutionLayer,
    LocalResponseNormalization,
    Subsampling1DLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalization  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.recurrent import (  # noqa: F401
    LSTM,
    GravesBidirectionalLSTM,
    GravesLSTM,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import AutoEncoder  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.rbm import RBM  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.variational import (  # noqa: F401
    VariationalAutoencoder,
)
