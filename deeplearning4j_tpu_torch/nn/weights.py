"""Weight initialization schemes (counterpart of deeplearning4j_tpu/nn/weights.py).

Each scheme is `init(gen, shape, fan_in, fan_out, dtype, **kwargs)` with
an explicit `torch.Generator`. The distributions are the JAX package's;
the numbers are not (torch's generator is not threefry), so parity tests
carry JAX params over through util/model_serializer.py instead.
Tensors are drawn on the CPU, where a seeded generator gives the same
numbers whatever device the network later lives on.
"""

from __future__ import annotations

import math

import torch


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(dtype)


def _uniform(gen, shape, low, high, dtype):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (low + (high - low) * u).to(dtype)


def zero(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    return torch.zeros(shape, dtype=dtype)


def ones(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    return torch.ones(shape, dtype=dtype)


def constant(gen, shape, fan_in, fan_out, dtype=torch.float32, value=0.0,
             **kw):
    return torch.full(shape, value, dtype=dtype)


def uniform(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    a = 1.0 / math.sqrt(fan_in)
    return _uniform(gen, shape, -a, a, dtype)


def xavier(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    """Glorot normal: N(0, 2/(fan_in+fan_out))."""
    return _normal(gen, shape, dtype) * math.sqrt(2.0 / (fan_in + fan_out))


def xavier_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, -a, a, dtype)


def xavier_fan_in(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    return _normal(gen, shape, dtype) / math.sqrt(fan_in)


def xavier_legacy(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    return _normal(gen, shape, dtype) * math.sqrt(1.0 / (fan_in + fan_out))


def relu_init(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    """He normal: N(0, 2/fan_in)."""
    return _normal(gen, shape, dtype) * math.sqrt(2.0 / fan_in)


def relu_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    a = math.sqrt(6.0 / fan_in)
    return _uniform(gen, shape, -a, a, dtype)


def sigmoid_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, -a, a, dtype)


def normal(gen, shape, fan_in, fan_out, dtype=torch.float32, mean=0.0,
           std=None, **kw):
    if std is None:
        std = 1.0 / math.sqrt(fan_in)
    return mean + _normal(gen, shape, dtype) * std


def lecun_normal(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    return _normal(gen, shape, dtype) * math.sqrt(1.0 / fan_in)


def lecun_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32, **kw):
    a = math.sqrt(3.0 / fan_in)
    return _uniform(gen, shape, -a, a, dtype)


WEIGHT_INITS = {
    "zero": zero,
    "ones": ones,
    "constant": constant,
    "uniform": uniform,
    "xavier": xavier,
    "xavier_uniform": xavier_uniform,
    "xavier_fan_in": xavier_fan_in,
    "xavier_legacy": xavier_legacy,
    "relu": relu_init,
    "relu_uniform": relu_uniform,
    "sigmoid_uniform": sigmoid_uniform,
    "normal": normal,
    "distribution": normal,
    "lecun_normal": lecun_normal,
    "lecun_uniform": lecun_uniform,
}


def init_weights(name, gen, shape, fan_in, fan_out, dtype=torch.float32,
                 **kwargs):
    """Initialize a weight tensor with the named scheme."""
    if callable(name):
        return name(gen, shape, fan_in, fan_out, dtype, **kwargs)
    key = str(name).lower()
    if key not in WEIGHT_INITS:
        raise ValueError(
            f"Unknown weight init '{name}'. Known: {sorted(WEIGHT_INITS)}")
    return WEIGHT_INITS[key](gen, shape, fan_in, fan_out, dtype, **kwargs)
