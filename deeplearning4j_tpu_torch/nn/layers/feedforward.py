"""Denoising AutoEncoder layer (counterpart of
deeplearning4j_tpu/nn/layers/feedforward.py).

Supervised forward = the encoder; unsupervised `pretrain_loss` = the
reconstruction error (the layer's loss, decoding with the tied weight
W^T) after masking noise: each input element is zeroed with probability
`corruption_level`, the mask drawn from the network's torch.Generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeFeedForward,
)
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.nn.weights import init_weights


def flat_n_in(input_type: InputType) -> int:
    """The width of a feed-forward input, or the flattened size of any
    other."""
    return input_type.size if isinstance(
        input_type, InputTypeFeedForward) else input_type.arrays_per_example()


def visible_params(layer, gen, dtype):
    """W [n_in, n_out] and zero hidden (b) and visible (vb) biases: the
    parameters of a tied-weight encoder/decoder pair."""
    W = init_weights(layer.weight_init, gen, (layer.n_in, layer.n_out),
                     fan_in=layer.n_in, fan_out=layer.n_out, dtype=dtype)
    return {"W": W, "b": torch.zeros((layer.n_out,), dtype=dtype),
            "vb": torch.zeros((layer.n_in,), dtype=dtype)}


@dataclass(kw_only=True)
class AutoEncoder(BaseLayer):
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"
    activation: Optional[str] = "sigmoid"

    def set_n_in(self, input_type: InputType) -> None:
        self.n_in = flat_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return visible_params(self, gen, dtype)

    def encode(self, params, x):
        return get_activation(self.activation)(x @ params["W"] + params["b"])

    def decode(self, params, h):
        return get_activation(self.activation)(h @ params["W"].t()
                                               + params["vb"])

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        x = self._maybe_dropout_input(x, train, rng)
        return self.encode(params, x), state

    def pretrain_loss(self, params, x, rng):
        """Mean reconstruction loss of the corrupted input (no corruption
        without a generator)."""
        corrupted = x
        if self.corruption_level > 0.0 and rng is not None:
            u = torch.rand(x.shape, generator=rng, device=x.device,
                           dtype=torch.float32)
            corrupted = torch.where(u < 1.0 - self.corruption_level, x, 0.0)
        recon_pre = (self.encode(params, corrupted) @ params["W"].t()
                     + params["vb"])
        return torch.mean(get_loss(self.loss)(x, recon_pre, self.activation))
