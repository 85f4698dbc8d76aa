"""Layer base classes (counterpart of deeplearning4j_tpu/nn/layers/base.py).

A layer is a dataclass of hyperparameters — the same fields as the JAX
package, so configurations serialize identically — carrying
`init_params(gen, input_type, dtype) -> dict of tensors` and
`apply(params, x, state=...) -> (y, state)`. Running statistics live in a
separate `state` dict. This slice ports the inference forward; training
(dropout, regularization, the backward) arrives with slice 2.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType


@dataclass(kw_only=True)
class Layer:
    """Base hyperparameter container for all layers. Fields set to None
    inherit the network-level default at build() time."""

    name: Optional[str] = None
    frozen: bool = False
    dropout: Optional[float] = None  # inverted dropout on layer input (train)
    l1: Optional[float] = None
    l2: Optional[float] = None
    updater: Optional[str] = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None

    # ---- shape inference ----
    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def set_n_in(self, input_type: InputType) -> None:
        """Infer nIn from the incoming InputType (no-op for param-free layers)."""

    # ---- parameters ----
    def init_params(self, gen: torch.Generator, input_type: InputType,
                    dtype=torch.float32) -> Dict[str, Any]:
        return {}

    def init_state(self, input_type: InputType,
                   dtype=torch.float32) -> Dict[str, Any]:
        return {}

    def has_params(self) -> bool:
        return False

    # ---- forward ----
    def apply(self, params, x, *, state=None):
        """Inference forward. Returns (output, state)."""
        raise NotImplementedError

    # ---- serde ----
    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, InputType):
                v = v.to_dict()
            d[f.name] = v
        return d


@dataclass(kw_only=True)
class BaseLayer(Layer):
    """Base for layers with weights + an activation."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    bias_init: float = 0.0

    def has_params(self) -> bool:
        return True
