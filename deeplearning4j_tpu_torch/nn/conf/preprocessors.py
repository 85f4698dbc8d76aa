"""InputPreProcessors (counterpart of deeplearning4j_tpu/nn/conf/preprocessors.py).

Shape adapters between layer families (conv NHWC, recurrent [B, T, C],
feed-forward [B, C]), the per-example normalizers, and a chain of them.
Each carries the feature mask across its reshape (`feed_forward_mask`);
`infer_preprocessor` inserts the adapters the JAX package inserts.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeConvolutionalFlat,
    InputTypeFeedForward,
)


class InputPreProcessor:
    def preprocess(self, x):
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def feed_forward_mask(self, mask, input_type):
        return mask

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


def _example_axes(x):
    return tuple(range(1, x.ndim))


def _std(x, axes):
    """Population std over `axes` (jnp.std's ddof=0), floored at 1e-12."""
    return torch.clamp_min(torch.std(x, dim=axes, keepdim=True,
                                     correction=0), 1e-12)


@dataclass(frozen=True)
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, T, C] -> [B*T, C] (per-timestep dense processing)."""

    def preprocess(self, x):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, input_type):
        return InputType.feed_forward(input_type.size)

    def feed_forward_mask(self, mask, input_type):
        return None if mask is None else mask.reshape(-1)


@dataclass(frozen=True)
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[B*T, C] -> [B, T, C]; needs a static T."""

    timeseries_length: int

    def preprocess(self, x):
        return x.reshape(-1, self.timeseries_length, x.shape[-1])

    def output_type(self, input_type):
        return InputType.recurrent(input_type.size, self.timeseries_length)

    def feed_forward_mask(self, mask, input_type):
        return None if mask is None else mask.reshape(
            -1, self.timeseries_length)


@dataclass(frozen=True)
class CnnToRnnPreProcessor(InputPreProcessor):
    """[B, H, W, C] -> [B, T=H, W*C]: rows become timesteps."""

    height: int
    width: int
    channels: int

    def preprocess(self, x):
        B, H, W, C = x.shape
        return x.reshape(B, H, W * C)

    def output_type(self, input_type):
        return InputType.recurrent(self.width * self.channels, self.height)


@dataclass(frozen=True)
class RnnToCnnPreProcessor(InputPreProcessor):
    """[B, T, C] -> [B*T, H, W, C'] with H*W*C' == C."""

    height: int
    width: int
    channels: int

    def preprocess(self, x):
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)

    def feed_forward_mask(self, mask, input_type):
        return None if mask is None else mask.reshape(-1)


@dataclass(frozen=True)
class ZeroMeanPrePreProcessor(InputPreProcessor):
    """Subtract each example's mean."""

    def preprocess(self, x):
        return x - torch.mean(x, dim=_example_axes(x), keepdim=True)

    def output_type(self, input_type):
        return input_type


@dataclass(frozen=True)
class UnitVarianceProcessor(InputPreProcessor):
    """Divide by each example's (population) std."""

    def preprocess(self, x):
        return x / _std(x, _example_axes(x))

    def output_type(self, input_type):
        return input_type


@dataclass(frozen=True)
class ZeroMeanAndUnitVariancePreProcessor(InputPreProcessor):
    """Standardize each example."""

    def preprocess(self, x):
        axes = _example_axes(x)
        return (x - torch.mean(x, dim=axes, keepdim=True)) / _std(x, axes)

    def output_type(self, input_type):
        return input_type


@dataclass(frozen=True)
class BinomialSamplingPreProcessor(InputPreProcessor):
    """Binarize activations in [0, 1]: a deterministic threshold at 0.5
    (preprocessors run outside the dropout generator's order)."""

    def preprocess(self, x):
        return (x > 0.5).to(x.dtype)

    def output_type(self, input_type):
        return input_type


class ComposableInputPreProcessor(InputPreProcessor):
    """A chain of preprocessors applied in order."""

    def __init__(self, *preprocessors: InputPreProcessor):
        self.preprocessors = list(preprocessors)

    def preprocess(self, x):
        for p in self.preprocessors:
            x = p.preprocess(x)
        return x

    def output_type(self, input_type):
        for p in self.preprocessors:
            input_type = p.output_type(input_type)
        return input_type

    def feed_forward_mask(self, mask, input_type):
        for p in self.preprocessors:
            mask = p.feed_forward_mask(mask, input_type)
        return mask

    def to_dict(self) -> dict:
        return {"type": "ComposableInputPreProcessor",
                "preprocessors": [p.to_dict() for p in self.preprocessors]}


PREPROCESSORS = {c.__name__: c for c in [
    CnnToFeedForwardPreProcessor,
    FeedForwardToCnnPreProcessor,
    RnnToFeedForwardPreProcessor,
    FeedForwardToRnnPreProcessor,
    CnnToRnnPreProcessor,
    RnnToCnnPreProcessor,
    ZeroMeanPrePreProcessor,
    UnitVarianceProcessor,
    ZeroMeanAndUnitVariancePreProcessor,
    BinomialSamplingPreProcessor,
]}


def preprocessor_from_dict(d: dict) -> InputPreProcessor:
    d = dict(d)
    kind = d.pop("type")
    if kind == "ComposableInputPreProcessor":
        return ComposableInputPreProcessor(
            *[preprocessor_from_dict(p) for p in d["preprocessors"]])
    if kind not in PREPROCESSORS:
        raise ValueError(f"Unknown preprocessor '{kind}'. Known: "
                         f"{sorted(PREPROCESSORS)}")
    return PREPROCESSORS[kind](**d)


def infer_preprocessor(prev_type: InputType, layer) -> InputPreProcessor | None:
    """The JAX package's auto-insertion rules:
      convolutionalFlat input + conv-like/BN layer  -> unflatten to NHWC
      convolutional output + dense/output/embedding -> flatten
      convolutional output + recurrent layer        -> rows as timesteps
      feed-forward output + recurrent layer         -> error (needs an
                                                       explicit length)
    A dense layer over recurrent input runs per timestep natively."""
    from deeplearning4j_tpu_torch.nn.layers.conv import (
        ConvolutionLayer,
        LocalResponseNormalization,
        SubsamplingLayer,
        ZeroPaddingLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.core import (
        DenseLayer,
        EmbeddingLayer,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalization
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RECURRENT_LAYERS

    conv_like = (ConvolutionLayer, SubsamplingLayer, ZeroPaddingLayer,
                 LocalResponseNormalization, BatchNormalization)
    if isinstance(prev_type, InputTypeConvolutionalFlat):
        if isinstance(layer, conv_like):
            return FeedForwardToCnnPreProcessor(
                prev_type.height, prev_type.width, prev_type.channels)
        return None
    if isinstance(prev_type, InputTypeConvolutional):
        if isinstance(layer, (DenseLayer, OutputLayer, EmbeddingLayer)):
            return CnnToFeedForwardPreProcessor(
                prev_type.height, prev_type.width, prev_type.channels)
        if isinstance(layer, RECURRENT_LAYERS):
            return CnnToRnnPreProcessor(
                prev_type.height, prev_type.width, prev_type.channels)
        return None
    if isinstance(prev_type, InputTypeFeedForward) and isinstance(
            layer, RECURRENT_LAYERS):
        raise ValueError(
            "Cannot feed feed-forward activations into a recurrent layer "
            "without a FeedForwardToRnnPreProcessor with explicit length")
    return None
