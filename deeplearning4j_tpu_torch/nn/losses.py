"""Loss functions (counterpart of deeplearning4j_tpu/nn/losses.py).

Same registry, names and definitions as the JAX package. A loss receives
the *pre-activation* output and the activation, so the stable fused forms
apply (log-softmax cross-entropy, sigmoid BCE with logits). Every loss
returns the **per-example** loss, shape [batch] (time/feature axes
reduced); masks broadcast against the label shape. Loss math runs in at
least float32 (bf16 pre-activations are upcast; float64 passes through).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.dtype import ensure_f32

_EPS = 1e-7


def _reduce_per_example(loss_elems, mask):
    """Sum all non-batch axes; apply mask first if given."""
    if mask is not None:
        m = mask
        while m.ndim < loss_elems.ndim:
            m = m[..., None]
        loss_elems = loss_elems * m
    axes = tuple(range(1, loss_elems.ndim))
    return loss_elems.sum(axes) if axes else loss_elems


def _activate(pre_output, activation):
    return get_activation(activation)(pre_output)


def _is(activation, name):
    return not callable(activation) and str(activation).lower() == name


def mse(labels, pre_output, activation="identity", mask=None):
    out = _activate(pre_output, activation)
    # reference convention: mean over the feature axis, sum over time
    return _reduce_per_example((out - labels) ** 2, mask) / labels.shape[-1]


def l2(labels, pre_output, activation="identity", mask=None):
    out = _activate(pre_output, activation)
    return _reduce_per_example((out - labels) ** 2, mask)


def mae(labels, pre_output, activation="identity", mask=None):
    out = _activate(pre_output, activation)
    return _reduce_per_example(torch.abs(out - labels), mask) / labels.shape[-1]


def l1(labels, pre_output, activation="identity", mask=None):
    out = _activate(pre_output, activation)
    return _reduce_per_example(torch.abs(out - labels), mask)


def mape(labels, pre_output, activation="identity", mask=None):
    out = _activate(pre_output, activation)
    pct = 100.0 * torch.abs((out - labels) / (labels + _EPS))
    return _reduce_per_example(pct, mask) / labels.shape[-1]


def msle(labels, pre_output, activation="identity", mask=None):
    out = _activate(pre_output, activation)
    d = torch.log1p(out) - torch.log1p(labels)
    return _reduce_per_example(d * d, mask) / labels.shape[-1]


def mcxent(labels, pre_output, activation="softmax", mask=None):
    """Multi-class cross-entropy; the stable log-softmax path when the
    activation is softmax."""
    if _is(activation, "softmax"):
        logp = torch.log_softmax(pre_output, dim=-1)
    else:
        out = _activate(pre_output, activation)
        logp = torch.log(torch.clamp(out, _EPS, 1.0))
    return _reduce_per_example(-labels * logp, mask)


def negativeloglikelihood(labels, pre_output, activation="softmax",
                          mask=None):
    # the reference treats NLL as MCXENT (same math for one-hot labels)
    return mcxent(labels, pre_output, activation, mask)


def xent(labels, pre_output, activation="sigmoid", mask=None):
    """Binary cross-entropy; BCE with logits when the activation is
    sigmoid: max(x,0) - x*z + log(1+exp(-|x|))."""
    if _is(activation, "sigmoid"):
        x, z = pre_output, labels
        elems = (torch.clamp_min(x, 0) - x * z
                 + torch.log1p(torch.exp(-torch.abs(x))))
    else:
        out = torch.clamp(_activate(pre_output, activation), _EPS, 1.0 - _EPS)
        elems = -(labels * torch.log(out)
                  + (1.0 - labels) * torch.log(1.0 - out))
    return _reduce_per_example(elems, mask)


def _signs(labels):
    """Hinge labels in {-1, +1} ({0, 1} mapped)."""
    return torch.where(labels <= 0, -1.0, 1.0).to(labels.dtype)


def hinge(labels, pre_output, activation="identity", mask=None):
    out = _activate(pre_output, activation)
    return _reduce_per_example(
        torch.clamp_min(1.0 - _signs(labels) * out, 0.0), mask)


def squared_hinge(labels, pre_output, activation="identity", mask=None):
    out = _activate(pre_output, activation)
    h = torch.clamp_min(1.0 - _signs(labels) * out, 0.0)
    return _reduce_per_example(h * h, mask)


def poisson(labels, pre_output, activation="identity", mask=None):
    out = _activate(pre_output, activation)
    elems = out - labels * torch.log(torch.clamp_min(out, _EPS))
    return _reduce_per_example(elems, mask)


def kl_divergence(labels, pre_output, activation="softmax", mask=None):
    out = torch.clamp_min(_activate(pre_output, activation), _EPS)
    p = torch.clamp_min(labels, _EPS)
    return _reduce_per_example(labels * (torch.log(p) - torch.log(out)),
                               mask)


def cosine_proximity(labels, pre_output, activation="identity", mask=None):
    out = _activate(pre_output, activation)
    if mask is not None:
        m = mask
        while m.ndim < out.ndim:
            m = m[..., None]
        out = out * m
        labels = labels * m
    dot = (labels * out).sum(-1)
    norms = (torch.linalg.vector_norm(labels, dim=-1)
             * torch.linalg.vector_norm(out, dim=-1) + _EPS)
    cos = dot / norms
    axes = tuple(range(1, cos.ndim))
    return -(cos.sum(axes) if axes else cos)


LOSSES = {
    "mse": mse,
    "l2": l2,
    "mae": mae,
    "mean_absolute_error": mae,
    "l1": l1,
    "mape": mape,
    "mean_absolute_percentage_error": mape,
    "msle": msle,
    "mean_squared_logarithmic_error": msle,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "xent": xent,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "poisson": poisson,
    "kl_divergence": kl_divergence,
    "reconstruction_crossentropy": xent,
    "cosine_proximity": cosine_proximity,
}


def _f32_loss(fn):
    """Loss math in at least float32: under the bf16 policy the output
    head's matmul stays bf16, but softmax/log/exp here would lose too
    much precision."""
    def wrapped(labels, pre_output, *args, **kwargs):
        return fn(ensure_f32(labels), ensure_f32(pre_output), *args,
                  **kwargs)
    wrapped.__name__ = getattr(fn, "__name__", "loss")
    return wrapped


def get_loss(name):
    """Resolve a loss by name (case-insensitive) or accept a callable;
    callables get the same float32 upcast as named losses."""
    if callable(name):
        return _f32_loss(name)
    key = str(name).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(LOSSES)}")
    return _f32_loss(LOSSES[key])
