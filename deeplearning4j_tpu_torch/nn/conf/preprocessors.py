"""InputPreProcessors (counterpart of deeplearning4j_tpu/nn/conf/preprocessors.py).

Only the two adapters that `infer_preprocessor` yields for feed-forward
and convolutional graphs are ported in this slice: flatten (NHWC ->
[B, H*W*C]) and unflatten. The recurrent adapters arrive with the
recurrent layers.
"""

from __future__ import annotations

from dataclasses import dataclass

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeConvolutionalFlat,
)


class InputPreProcessor:
    def preprocess(self, x):
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        d.update(self.__dict__)
        return d


@dataclass(frozen=True)
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, H, W, C] -> [B, H*W*C]."""

    height: int
    width: int
    channels: int

    def preprocess(self, x):
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type):
        return InputType.feed_forward(self.height * self.width * self.channels)


@dataclass(frozen=True)
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[B, H*W*C] -> [B, H, W, C]. Also accepts already-4D input unchanged."""

    height: int
    width: int
    channels: int

    def preprocess(self, x):
        if x.ndim == 4:
            return x
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


PREPROCESSORS = {c.__name__: c for c in [CnnToFeedForwardPreProcessor,
                                         FeedForwardToCnnPreProcessor]}


def preprocessor_from_dict(d: dict) -> InputPreProcessor:
    d = dict(d)
    kind = d.pop("type")
    if kind not in PREPROCESSORS:
        raise ValueError(
            f"Preprocessor '{kind}' is not ported yet. "
            f"Ported: {sorted(PREPROCESSORS)}")
    return PREPROCESSORS[kind](**d)


def infer_preprocessor(prev_type: InputType, layer) -> InputPreProcessor | None:
    """The JAX package's auto-insertion rules, for the ported layers:
      convolutionalFlat input + conv-like/BN layer -> unflatten
      convolutional output + dense/output layer           -> flatten
    """
    from deeplearning4j_tpu_torch.nn.layers.conv import (
        ConvolutionLayer,
        LocalResponseNormalization,
        SubsamplingLayer,
        ZeroPaddingLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalization

    if isinstance(prev_type, InputTypeConvolutionalFlat):
        if isinstance(layer, (ConvolutionLayer, SubsamplingLayer,
                              ZeroPaddingLayer, LocalResponseNormalization,
                              BatchNormalization)):
            return FeedForwardToCnnPreProcessor(
                prev_type.height, prev_type.width, prev_type.channels)
        return None
    if isinstance(prev_type, InputTypeConvolutional):
        if isinstance(layer, (DenseLayer, OutputLayer)):
            return CnnToFeedForwardPreProcessor(
                prev_type.height, prev_type.width, prev_type.channels)
    return None
