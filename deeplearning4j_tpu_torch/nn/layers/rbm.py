"""Restricted Boltzmann Machine layer with CD-k pretraining (counterpart
of deeplearning4j_tpu/nn/layers/rbm.py).

CD-k is the gradient of a free-energy-difference surrogate,

    L(theta) = mean F(v_data) - mean F(v_model.detach())

where v_model is the k-step Gibbs sample: its gradient IS the CD-k
update, so the layer pretrains through the same autograd step as
AutoEncoder and VariationalAutoencoder (MultiLayerNetwork.pretrain). The
Gibbs chain samples from the network's torch.Generator. Supervised
forward = propUp, the hidden mean.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    flat_n_in,
    visible_params,
)

_UNITS = ("BINARY", "GAUSSIAN", "RECTIFIED", "IDENTITY")


def _mean(units, z):
    """The conditional mean of `units` at pre-activation z."""
    if units == "BINARY":
        return torch.sigmoid(z)
    if units == "RECTIFIED":
        return torch.relu(z)
    return z   # GAUSSIAN / IDENTITY


def _sample(units, p, gen):
    """(mean, sample) of `units` with mean p."""
    if units == "BINARY":
        return p, torch.bernoulli(p, generator=gen)
    if units == "GAUSSIAN":
        return p, p + torch.randn(p.shape, generator=gen, device=p.device,
                                  dtype=p.dtype)
    return p, p   # RECTIFIED / IDENTITY: mean-field


@dataclass(kw_only=True)
class RBM(BaseLayer):
    hidden_unit: str = "BINARY"
    visible_unit: str = "BINARY"
    k: int = 1                      # CD-k Gibbs steps
    sparsity: float = 0.0           # hidden sparsity target penalty
    activation: Optional[str] = "sigmoid"

    def __post_init__(self):
        hu = self.hidden_unit.upper()
        vu = self.visible_unit.upper()
        if hu not in _UNITS or vu not in _UNITS:
            raise ValueError(
                f"hidden/visible unit must be one of {_UNITS}: "
                f"{self.hidden_unit}/{self.visible_unit}")
        self.hidden_unit = hu
        self.visible_unit = vu

    def set_n_in(self, input_type: InputType) -> None:
        self.n_in = flat_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return visible_params(self, gen, dtype)

    def prop_up(self, params, v):
        """P(h|v) mean."""
        return _mean(self.hidden_unit, v @ params["W"] + params["b"])

    def prop_down(self, params, h):
        """P(v|h) mean."""
        return _mean(self.visible_unit, h @ params["W"].t() + params["vb"])

    def free_energy(self, params, v):
        """F(v) = visible term - hidden term, mean over the batch. The
        hidden term integrates the hidden units out: sum softplus(vW+b)
        for BINARY, sum (vW+b)^2/2 for unit-variance GAUSSIAN units;
        RECTIFIED/IDENTITY hidden units have no closed form and raise."""
        z = v @ params["W"] + params["b"]
        if self.hidden_unit == "BINARY":
            hidden_term = torch.sum(F.softplus(z), dim=-1)
        elif self.hidden_unit == "GAUSSIAN":
            hidden_term = 0.5 * torch.sum(z * z, dim=-1)
        else:
            raise NotImplementedError(
                f"free_energy has no closed form for {self.hidden_unit} "
                "hidden units; CD pretraining supports BINARY/GAUSSIAN "
                "hidden units only")
        if self.visible_unit == "GAUSSIAN":
            vis_term = 0.5 * torch.sum((v - params["vb"]) ** 2, dim=-1)
        else:
            vis_term = -(v @ params["vb"])
        return torch.mean(vis_term - hidden_term)

    def gibbs_sample(self, params, v0, rng, k: Optional[int] = None):
        """The visible sample after k alternating Gibbs steps from v0."""
        v = v0
        for _ in range(max(self.k if k is None else k, 1)):
            _, h = _sample(self.hidden_unit, self.prop_up(params, v), rng)
            _, v = _sample(self.visible_unit, self.prop_down(params, h), rng)
        return v

    def pretrain_loss(self, params, x, rng):
        """CD-k as the free-energy difference; with `sparsity` the mean
        hidden activation is pulled toward it."""
        v_model = self.gibbs_sample(params, x, rng).detach()
        loss = self.free_energy(params, x) - self.free_energy(params, v_model)
        if self.sparsity > 0.0:
            h_mean = torch.mean(self.prop_up(params, x), dim=0)
            loss = loss + torch.mean((h_mean - self.sparsity) ** 2)
        return loss

    def reconstruction_error(self, params, x, rng=None):
        """Mean squared error after one up-down pass."""
        v1 = self.prop_down(params, self.prop_up(params, x))
        return torch.mean((x - v1) ** 2)

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        x = self._maybe_dropout_input(x, train, rng)
        return self.prop_up(params, x), state
