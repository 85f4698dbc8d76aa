"""Activation functions (counterpart of deeplearning4j_tpu/nn/activations.py).

Same names and definitions as the JAX package, as elementwise (or
row-wise, for softmax) torch functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def identity(x):
    return x


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def leakyrelu(x, alpha: float = 0.01):
    return F.leaky_relu(x, negative_slope=alpha)


def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha=alpha)


def selu(x):
    return F.selu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def tanh(x):
    return torch.tanh(x)


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def rationaltanh(x):
    a = torch.abs(2.0 * x / 3.0)
    approx = torch.sign(x) * (1.0 - 1.0 / (1.0 + a + a * a + 1.41645 * a**4))
    return 1.7159 * approx


def rectifiedtanh(x):
    return torch.clamp_min(torch.tanh(x), 0.0)


def softmax(x):
    return torch.softmax(x, dim=-1)


def logsoftmax(x):
    return torch.log_softmax(x, dim=-1)


def softplus(x):
    return F.softplus(x)


def softsign(x):
    return F.softsign(x)


def cube(x):
    return x * x * x


def swish(x):
    return F.silu(x)


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mish(x):
    return x * torch.tanh(F.softplus(x))


ACTIVATIONS = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
    "softplus": softplus,
    "softsign": softsign,
    "cube": cube,
    "swish": swish,
    "gelu": gelu,
    "mish": mish,
}


def get_activation(name):
    """Resolve an activation by name (case-insensitive) or pass callables
    through."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
