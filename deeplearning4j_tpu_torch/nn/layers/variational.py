"""Variational autoencoder layer (counterpart of
deeplearning4j_tpu/nn/layers/variational.py).

Supervised forward: the encoder's latent mean. Unsupervised
`pretrain_loss`: the negative ELBO (the reconstruction log-probability
under a gaussian or bernoulli distribution plus KL(q(z|x) || N(0, I))),
mean over the batch, the reparameterization noise drawn from the
network's torch.Generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer
from deeplearning4j_tpu_torch.nn.layers.feedforward import flat_n_in
from deeplearning4j_tpu_torch.nn.weights import init_weights

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _linear(wi, gen, a, b, dtype):
    return {"W": init_weights(wi, gen, (a, b), fan_in=a, fan_out=b,
                              dtype=dtype),
            "b": torch.zeros((b,), dtype=dtype)}


def _mlp(params, x, act):
    for p in params:
        x = act(x @ p["W"] + p["b"])
    return x


@dataclass(kw_only=True)
class VariationalAutoencoder(BaseLayer):
    encoder_layer_sizes: Sequence[int] = (100,)
    decoder_layer_sizes: Sequence[int] = (100,)
    latent_size: int = 32              # == n_out for the supervised path
    reconstruction_distribution: str = "gaussian"  # gaussian | bernoulli
    pzx_activation: str = "identity"   # activation on latent mean/logvar heads
    num_samples: int = 1
    activation: Optional[str] = "tanh"

    def __post_init__(self):
        if self.n_out is None:
            self.n_out = self.latent_size

    def set_n_in(self, input_type: InputType) -> None:
        self.n_in = flat_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.latent_size)

    def init_params(self, gen, input_type, dtype=torch.float32):
        wi = self.weight_init
        enc = [self.n_in, *self.encoder_layer_sizes]
        dec = [self.latent_size, *self.decoder_layer_sizes]
        # gaussian reconstruction emits mean and logvar, bernoulli logits
        out = (2 if self.reconstruction_distribution == "gaussian"
               else 1) * self.n_in
        return {
            "encoder": [_linear(wi, gen, a, b, dtype)
                        for a, b in zip(enc[:-1], enc[1:])],
            "mu": _linear(wi, gen, enc[-1], self.latent_size, dtype),
            "logvar": _linear(wi, gen, enc[-1], self.latent_size, dtype),
            "decoder": [_linear(wi, gen, a, b, dtype)
                        for a, b in zip(dec[:-1], dec[1:])],
            "out": _linear(wi, gen, dec[-1], out, dtype),
        }

    def encode(self, params, x):
        h = _mlp(params["encoder"], x, get_activation(self.activation))
        head = get_activation(self.pzx_activation)
        mu = head(h @ params["mu"]["W"] + params["mu"]["b"])
        logvar = head(h @ params["logvar"]["W"] + params["logvar"]["b"])
        return mu, logvar

    def decode(self, params, z):
        h = _mlp(params["decoder"], z, get_activation(self.activation))
        return h @ params["out"]["W"] + params["out"]["b"]

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        x = self._maybe_dropout_input(x, train, rng)
        return self.encode(params, x)[0], state

    def _noise(self, mu, rng):
        return torch.randn(mu.shape, generator=rng, device=mu.device,
                           dtype=mu.dtype)

    def reconstruct(self, params, x, rng=None):
        """Encode, sample (the mean without a generator), decode: the
        reconstruction mean."""
        mu, logvar = self.encode(params, x)
        z = mu if rng is None else \
            mu + torch.exp(0.5 * logvar) * self._noise(mu, rng)
        out = self.decode(params, z)
        if self.reconstruction_distribution == "gaussian":
            return torch.chunk(out, 2, dim=-1)[0]
        return torch.sigmoid(out)

    def pretrain_loss(self, params, x, rng):
        """Negative ELBO, mean over the batch, over `num_samples` draws."""
        mu, logvar = self.encode(params, x)
        total = 0.0
        for _ in range(self.num_samples):
            z = mu + torch.exp(0.5 * logvar) * self._noise(mu, rng)
            out = self.decode(params, z)
            if self.reconstruction_distribution == "gaussian":
                r_mu, r_logvar = torch.chunk(out, 2, dim=-1)
                logp = -0.5 * ((x - r_mu) ** 2 * torch.exp(-r_logvar)
                               + r_logvar) - _HALF_LOG_2PI
            else:   # bernoulli with logits
                logp = x * F.logsigmoid(out) + (1 - x) * F.logsigmoid(-out)
            total = total + torch.sum(logp, dim=-1)
        recon = total / self.num_samples
        kl = 0.5 * torch.sum(torch.exp(logvar) + mu * mu - 1.0 - logvar,
                             dim=-1)
        return torch.mean(-recon + kl)
