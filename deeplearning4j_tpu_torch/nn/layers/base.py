"""Layer base classes (counterpart of deeplearning4j_tpu/nn/layers/base.py).

A layer is a dataclass of hyperparameters — the same fields as the JAX
package, so configurations serialize identically — carrying
`init_params(gen, input_type, dtype) -> dict of tensors` and
`apply(params, x, train=..., state=...) -> (y, state)`. Running
statistics live in a separate `state` dict; a train-mode apply returns the
updated state. Gradients come from autograd over the whole network.

Input dropout is inverted dropout, `where(mask, x / keep, 0)` with
`keep = 1 - p`, split into a mask draw (`dropout_mask`, uniform draws
from an explicit torch.Generator that the network owns, passed to
`apply` as `rng`) and the apply step (`apply_dropout`), which tests hold
against the JAX package on one shared mask. torch cannot reproduce
`jax.random.bernoulli`'s bits, so the masks themselves are pinned within
the port: one generator state gives one set of masks.
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
    def apply(self, params, x, *, train=False, rng=None, state=None):
        """Returns (output, new_state). `rng`: the network's dropout
        generator (train mode only)."""
        raise NotImplementedError

    # ---- regularization ----
    def regularization_loss(self, params):
        """L1/L2 penalty over this layer's weight (non-bias) params: a leaf
        is exempt iff its own dict key starts with 'b' (b, beta, ...) or is
        'centers', as in the JAX package. Returns 0.0 when there is no
        penalty."""
        l1 = self.l1 or 0.0
        l2 = self.l2 or 0.0
        if not params or (l1 == 0.0 and l2 == 0.0):
            return 0.0
        reg = 0.0
        for key, leaf in _leaves_with_keys(params):
            if str(key).startswith("b") or str(key) == "centers":
                continue
            if l2:
                reg = reg + 0.5 * l2 * torch.sum(leaf * leaf)
            if l1:
                reg = reg + l1 * torch.sum(torch.abs(leaf))
        return reg

    # ---- input dropout ----
    def _maybe_dropout_input(self, x, train, rng):
        if not train or not self.dropout or self.dropout <= 0.0:
            return x
        if rng is None:
            raise ValueError(
                f"Layer {self.name or type(self).__name__} has dropout but "
                f"no rng")
        return apply_dropout(x, dropout_mask(x, self.dropout, rng),
                             self.dropout)

    # ---- serde ----
    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, InputType):
                v = v.to_dict()
            d[f.name] = v
        return d


def dropout_mask(x, p, gen):
    """The keep mask of inverted dropout at rate `p` for `x`: f32 uniform
    draws from `gen` (on `x`'s device) below keep = 1 - p, as
    `jax.random.bernoulli` draws its mask."""
    u = torch.rand(x.shape, generator=gen, device=x.device,
                   dtype=torch.float32)
    return u < (1.0 - p)


def apply_dropout(x, mask, p):
    """Inverted dropout on a drawn mask: where(mask, x / keep, 0), with
    keep rounded to x's dtype first, as JAX rounds a Python scalar (a
    device fill, not a host copy, so a CUDA graph can capture it)."""
    keep = torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / keep, 0.0)


def _leaves_with_keys(tree, key=None):
    """(own dict key, tensor) for every leaf of a nested param dict, in
    sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], k)
    elif tree is not None:
        yield key, tree


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
