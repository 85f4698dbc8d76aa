"""Core feed-forward layers (counterpart of deeplearning4j_tpu/nn/layers/core.py):
Dense, Activation, Dropout, Output (with its per-example loss) and
GlobalPooling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeFeedForward,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, Layer
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.nn.weights import init_weights


def _dense_params(layer, gen, dtype):
    W = init_weights(layer.weight_init, gen, (layer.n_in, layer.n_out),
                     fan_in=layer.n_in, fan_out=layer.n_out, dtype=dtype)
    b = torch.full((layer.n_out,), layer.bias_init, dtype=dtype)
    return {"W": W, "b": b}


@dataclass(kw_only=True)
class DenseLayer(BaseLayer):
    """Fully connected layer: y = act(x @ W + b)."""

    def set_n_in(self, input_type: InputType) -> None:
        if isinstance(input_type, (InputTypeFeedForward, InputTypeRecurrent)):
            self.n_in = input_type.size
        else:
            raise ValueError(
                f"DenseLayer needs feed-forward input, got {input_type}")

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, InputTypeRecurrent):
            return InputType.recurrent(self.n_out, input_type.timeseries_length)
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return _dense_params(self, gen, dtype)

    def apply(self, params, x, *, train=False, rng=None, state=None):
        x = self._maybe_dropout_input(x, train, rng)
        y = x @ params["W"] + params["b"]
        return get_activation(self.activation)(y), state


@dataclass(kw_only=True)
class ActivationLayer(Layer):
    """Applies an activation function elementwise (no params)."""

    activation: str = "relu"

    def apply(self, params, x, *, train=False, rng=None, state=None):
        return get_activation(self.activation)(x), state


@dataclass(kw_only=True)
class DropoutLayer(Layer):
    """Standalone inverted-dropout layer (identity at inference)."""

    dropout: float = 0.5

    def apply(self, params, x, *, train=False, rng=None, state=None):
        return self._maybe_dropout_input(x, train, rng), state


@dataclass(kw_only=True)
class BaseOutputLayer(BaseLayer):
    loss: str = "mcxent"
    activation: Optional[str] = "softmax"

    def compute_per_example_loss(self, labels, pre_output, mask=None):
        return get_loss(self.loss)(labels, pre_output, self.activation, mask)

    def pre_output(self, params, x):
        return x @ params["W"] + params["b"]

    def per_example_loss_from_input(self, params, x, labels, mask=None):
        """Loss seen from the layer's input activations."""
        return self.compute_per_example_loss(
            labels, self.pre_output(params, x), mask=mask)


@dataclass(kw_only=True)
class OutputLayer(BaseOutputLayer):
    """Dense + loss head for classification/regression."""

    def set_n_in(self, input_type: InputType) -> None:
        if isinstance(input_type, InputTypeFeedForward):
            self.n_in = input_type.size
        else:
            raise ValueError(f"OutputLayer needs flat input, got {input_type}")

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return _dense_params(self, gen, dtype)

    def apply(self, params, x, *, train=False, rng=None, state=None):
        x = self._maybe_dropout_input(x, train, rng)
        return get_activation(self.activation)(self.pre_output(params, x)), state


@dataclass(kw_only=True)
class GlobalPoolingLayer(Layer):
    """Global pooling over time ([B,T,C] -> [B,C]) or space
    ([B,H,W,C] -> [B,C]). pooling_type: max | avg | sum | pnorm."""

    pooling_type: str = "max"
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, InputTypeRecurrent):
            return InputType.feed_forward(input_type.size)
        if isinstance(input_type, InputTypeConvolutional):
            return InputType.feed_forward(input_type.channels)
        return input_type

    def apply(self, params, x, *, train=False, rng=None, state=None):
        if x.ndim == 3:
            axes = (1,)
        elif x.ndim == 4:
            axes = (1, 2)
        else:
            raise ValueError(f"GlobalPooling needs rank 3 or 4 input, got {tuple(x.shape)}")
        pt = self.pooling_type.lower()
        if pt == "max":
            return torch.amax(x, dim=axes), state
        if pt == "sum":
            return torch.sum(x, dim=axes), state
        if pt == "avg":
            denom = 1.0
            for a in axes:
                denom *= x.shape[a]
            return torch.sum(x, dim=axes) / denom, state
        if pt == "pnorm":
            p = float(self.pnorm)
            return torch.sum(torch.abs(x) ** p, dim=axes) ** (1.0 / p), state
        raise ValueError(f"Unknown pooling type {self.pooling_type}")
