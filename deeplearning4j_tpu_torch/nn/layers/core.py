"""Core layers (counterpart of deeplearning4j_tpu/nn/layers/core.py):
Dense, Activation, Dropout, Embedding (a gather of rows of W), the output
heads with their per-example losses (Output, CenterLossOutput, RnnOutput
per timestep, Loss without weights) and mask-aware GlobalPooling.
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
from deeplearning4j_tpu_torch.parallel.tensor_parallel import linear


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

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        x = self._maybe_dropout_input(x, train, rng)
        y = linear(x, params["W"], params["b"], self.n_out)
        return get_activation(self.activation)(y), state


@dataclass(kw_only=True)
class ActivationLayer(Layer):
    """Applies an activation function elementwise (no params)."""

    activation: str = "relu"

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        return get_activation(self.activation)(x), state


@dataclass(kw_only=True)
class DropoutLayer(Layer):
    """Standalone inverted-dropout layer (identity at inference)."""

    dropout: float = 0.5

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        return self._maybe_dropout_input(x, train, rng), state


@dataclass(kw_only=True)
class EmbeddingLayer(BaseLayer):
    """Lookup table: integer indices [B] or [B, 1] -> rows of W [B, nOut]
    plus b; a gather, not a one-hot product."""

    activation: Optional[str] = "identity"

    def set_n_in(self, input_type: InputType) -> None:
        if isinstance(input_type, InputTypeFeedForward):
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return _dense_params(self, gen, dtype)

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        idx = x.to(torch.long)   # truncates toward zero, as astype does
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        y = params["W"][idx] + params["b"]
        return get_activation(self.activation)(y), state


@dataclass(kw_only=True)
class BaseOutputLayer(BaseLayer):
    loss: str = "mcxent"
    activation: Optional[str] = "softmax"

    def compute_per_example_loss(self, labels, pre_output, mask=None):
        return get_loss(self.loss)(labels, pre_output, self.activation, mask)

    def pre_output(self, params, x):
        return linear(x, params["W"], params["b"], self.n_out)

    def per_example_loss_from_input(self, params, x, labels, mask=None):
        """Loss seen from the layer's input activations."""
        return self.compute_per_example_loss(
            labels, self.pre_output(params, x), mask=mask)


@dataclass(kw_only=True)
class OutputLayer(BaseOutputLayer):
    """Dense + loss head for classification/regression."""

    def set_n_in(self, input_type: InputType) -> None:
        if isinstance(input_type, InputTypeRecurrent):
            raise ValueError(
                "OutputLayer got recurrent [B, T, C] input; use RnnOutputLayer "
                "for per-timestep outputs, or insert a "
                "RnnToFeedForwardPreProcessor / GlobalPoolingLayer first")
        if isinstance(input_type, InputTypeFeedForward):
            self.n_in = input_type.size
        else:
            raise ValueError(f"OutputLayer needs flat input, got {input_type}")

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return _dense_params(self, gen, dtype)

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        x = self._maybe_dropout_input(x, train, rng)
        return get_activation(self.activation)(self.pre_output(params, x)), state


@dataclass(kw_only=True)
class CenterLossOutputLayer(OutputLayer):
    """Softmax + center loss: L = L_softmax + lambda * alpha * 0.5 *
    ||f - c_y||^2, the centers [nOut, nIn] trained by the same gradient
    step (the JAX package's formulation)."""

    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_params(self, gen, input_type, dtype=torch.float32):
        p = _dense_params(self, gen, dtype)
        p["centers"] = torch.zeros((self.n_out, self.n_in), dtype=dtype)
        return p

    def per_example_loss_from_input(self, params, x, labels, mask=None):
        base = self.compute_per_example_loss(
            labels, self.pre_output(params, x), mask=mask)
        lab2d = labels if labels.ndim == 2 else labels.reshape(
            -1, labels.shape[-1])
        x2d = x if x.ndim == 2 else x.reshape(-1, x.shape[-1])
        # mixed dtypes (f32 labels, bf16 centers and features under the
        # bf16 policy) promote to the wider one, as jnp's matmul does
        dt = torch.promote_types(lab2d.dtype, params["centers"].dtype)
        cy = lab2d.to(dt) @ params["centers"].to(dt)     # [B, nIn]
        center = (0.5 * torch.sum((x2d - cy) ** 2, dim=-1)).reshape(
            base.shape)
        if mask is not None:
            m = mask if mask.ndim == base.ndim else mask.reshape(base.shape)
            center = center * m
        return base + self.lambda_ * self.alpha * center


@dataclass(kw_only=True)
class RnnOutputLayer(BaseOutputLayer):
    """Per-timestep output head over [B, T, C] activations; its loss sums
    over time ([B, T, C] labels, [B, T] label masks)."""

    def set_n_in(self, input_type: InputType) -> None:
        if isinstance(input_type, InputTypeRecurrent):
            self.n_in = input_type.size
        else:
            raise ValueError(
                f"RnnOutputLayer needs recurrent input, got {input_type}")

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(
            self.n_out, getattr(input_type, "timeseries_length", None))

    def init_params(self, gen, input_type, dtype=torch.float32):
        return _dense_params(self, gen, dtype)

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        x = self._maybe_dropout_input(x, train, rng)
        return get_activation(self.activation)(self.pre_output(params, x)), state


@dataclass(kw_only=True)
class LossLayer(BaseOutputLayer):
    """Loss-only head: no weights, the input goes straight to the loss."""

    activation: Optional[str] = "identity"

    def has_params(self) -> bool:
        return False

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {}

    def pre_output(self, params, x):
        return x

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        return get_activation(self.activation)(x), state


@dataclass(kw_only=True)
class GlobalPoolingLayer(Layer):
    """Global pooling over time ([B,T,C] -> [B,C]) or space
    ([B,H,W,C] -> [B,C]). pooling_type: max | avg | sum | pnorm. A [B, T]
    mask on a time series leaves the masked steps out (avg divides by
    the unmasked count)."""

    pooling_type: str = "max"
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, InputTypeRecurrent):
            return InputType.feed_forward(input_type.size)
        if isinstance(input_type, InputTypeConvolutional):
            return InputType.feed_forward(input_type.channels)
        return input_type

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        if x.ndim == 3:
            axes = (1,)
        elif x.ndim == 4:
            axes = (1, 2)
        else:
            raise ValueError(f"GlobalPooling needs rank 3 or 4 input, got {tuple(x.shape)}")
        pt = self.pooling_type.lower()
        count = None
        if mask is not None and x.ndim == 3:
            m = mask[..., None]
            x = torch.where(m > 0, x, float("-inf")) if pt == "max" \
                else x * m
            count = torch.clamp_min(torch.sum(mask, dim=1, keepdim=True),
                                    1.0)
        if pt == "max":
            return torch.amax(x, dim=axes), state
        if pt == "sum":
            return torch.sum(x, dim=axes), state
        if pt == "avg":
            if count is not None:
                return torch.sum(x, dim=axes) / count, state
            denom = 1.0
            for a in axes:
                denom *= x.shape[a]
            return torch.sum(x, dim=axes) / denom, state
        if pt == "pnorm":
            p = float(self.pnorm)
            return torch.sum(torch.abs(x) ** p, dim=axes) ** (1.0 / p), state
        raise ValueError(f"Unknown pooling type {self.pooling_type}")

    def feed_forward_mask(self, mask, input_type):
        return None   # the time axis is reduced away
