"""BatchNormalization, eval path (counterpart of deeplearning4j_tpu/nn/layers/norm.py).

Inference normalizes with the running statistics in `state`, folded into
one per-element multiply-add: scale = gamma * rsqrt(var + eps) and
shift = beta - mean * scale in the statistics dtype (f32 for bf16
activations), then cast down — the JAX package's rounding points. The
train-mode path (batch statistics, EMA, the two-pass backward) arrives
with slice 2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeFeedForward,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.dtype import is_low_precision
from deeplearning4j_tpu_torch.nn.layers.base import Layer


@dataclass(kw_only=True)
class BatchNormalization(Layer):
    n_out: Optional[int] = None   # channel count, inferred
    decay: float = 0.9            # EMA decay for running stats
    eps: float = 1e-5
    gamma: float = 1.0            # init values
    beta: float = 0.0
    lock_gamma_beta: bool = False
    stat_sample: int = 1          # ghost-batch statistics (train only)

    def has_params(self) -> bool:
        return True

    def _channels(self, input_type: InputType) -> int:
        if isinstance(input_type, InputTypeConvolutional):
            return input_type.channels
        if isinstance(input_type, (InputTypeFeedForward, InputTypeRecurrent)):
            return input_type.size
        raise ValueError(f"BatchNormalization: unsupported input {input_type}")

    def set_n_in(self, input_type: InputType) -> None:
        self.n_out = self._channels(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init_params(self, gen, input_type, dtype=torch.float32):
        c = self.n_out or self._channels(input_type)
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((c,), self.gamma, dtype=dtype),
                "beta": torch.full((c,), self.beta, dtype=dtype)}

    def init_state(self, input_type, dtype=torch.float32):
        c = self.n_out or self._channels(input_type)
        return {"mean": torch.zeros((c,), dtype=dtype),
                "var": torch.ones((c,), dtype=dtype)}

    def apply(self, params, x, *, state=None):
        in_dtype = x.dtype
        stat_dtype = torch.float32 if is_low_precision(in_dtype) else in_dtype
        if state is not None:
            mean, var = state["mean"], state["var"]
        else:
            axes = tuple(range(x.ndim - 1))
            xs = x.to(stat_dtype)
            mean = xs.mean(dim=axes)
            var = ((xs - mean) ** 2).mean(dim=axes)
        mean = mean.to(stat_dtype)
        scale = torch.rsqrt(var.to(stat_dtype) + self.eps)
        if not self.lock_gamma_beta and params:
            scale = scale * params["gamma"].to(stat_dtype)
            shift = params["beta"].to(stat_dtype) - mean * scale
        elif self.lock_gamma_beta:
            scale = scale * self.gamma
            shift = self.beta - mean * scale
        else:
            shift = -mean * scale
        return x * scale.to(in_dtype) + shift.to(in_dtype), state
