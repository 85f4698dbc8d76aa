"""Mixed-precision policy helpers (counterpart of deeplearning4j_tpu/nn/dtype.py).

The JAX package's policy: master params and optimizer state stay f32;
params and inputs are cast to the compute dtype (bf16) for the forward
and backward — inside autograd, so gradients arrive back in f32 through
the cast; BatchNorm running states are not cast (their statistics stay
f32); loss pre-activations are upcast to f32 (losses.py); the network
output and the loss are cast back to the parameter dtype.
"""

from __future__ import annotations

import torch

_NAMES = {
    "float32": torch.float32, "float": torch.float32, "f32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "half": torch.float16,
    "float64": torch.float64, "double": torch.float64,
}


def canonical_dtype(dtype):
    """Accept 'bfloat16'/'float32'/... strings or torch dtypes (None
    passes through)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).lower().replace("torch.", "")
    if name not in _NAMES:
        raise ValueError(f"Unknown dtype '{dtype}'. Known: {sorted(_NAMES)}")
    return _NAMES[name]


def is_low_precision(dtype) -> bool:
    return dtype.is_floating_point and torch.finfo(dtype).bits < 32


def cast_floating(tree, dtype):
    """Cast every floating tensor of a nested dict/list to `dtype`
    (integer tensors and non-tensors untouched)."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def ensure_f32(t):
    """Upcast bf16/f16 tensors to f32; f32/f64 (gradient checks) pass."""
    if (isinstance(t, torch.Tensor) and t.is_floating_point()
            and is_low_precision(t.dtype)):
        return t.float()
    return t

