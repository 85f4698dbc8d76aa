"""BatchNormalization (counterpart of deeplearning4j_tpu/nn/layers/norm.py).

Both modes fold the normalization into one per-element multiply-add:
scale = gamma * rsqrt(var + eps) and shift = beta - mean * scale in the
statistics dtype (f32 for bf16 activations), then cast down — the JAX
package's rounding points. Inference reads the running statistics in
`state`. Training normalizes with batch statistics (`_bn_stats`: one pass
for bf16/f16, two passes for f32) through `BNTrain`, an autograd Function
with the JAX package's two-pass backward, or with the statistics of the
leading ceil(B/k) rows (`stat_sample=k`, plain autograd); the running
statistics follow an EMA computed outside autograd. Under per-step data
parallelism (a `parallel.collectives.dp_scope` of world > 1) the batch
statistics are those of the global batch (`_bn_train_global`), as the
JAX package's one program over the dp-sharded batch computes them; with
`stat_sample=k` those of the global batch's leading ceil(N/k) rows, which
lie on the first ranks (`collectives.ghost_rows`).
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


def _stat_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)   # f64 in gradchecks


def _bn_stats(x, axes, st):
    """Per-channel mean/var. Low-precision inputs (bf16/f16) use the
    one-pass E[x^2]-E[x]^2 form with f32 accumulation; full-precision
    inputs the two-pass mean-then-deviations form (the one-pass form
    cancels in f32 when |mean| >> std)."""
    xs = x.to(st)
    mean = xs.mean(dim=axes)
    if st == x.dtype:
        var = ((x - mean) ** 2).mean(dim=axes)
    else:
        var = torch.clamp_min((xs * xs).mean(dim=axes) - mean * mean, 0.0)
    return mean, var


def _bn_fwd(x, gamma, beta, eps):
    axes = tuple(range(x.ndim - 1))
    st = _stat_dtype(x.dtype)
    mean, var = _bn_stats(x, axes, st)
    r = torch.rsqrt(var + eps)
    scale = gamma.to(st) * r
    shift = beta.to(st) - mean * scale
    y = x * scale.to(x.dtype) + shift.to(x.dtype)
    return y, mean, var, r


class BNTrain(torch.autograd.Function):
    """Train-mode batchnorm with the JAX package's hand-written two-pass
    backward (norm.py _bn_train):
      pass 1: dbeta = sum(dy), dgamma = sum(dy * xhat)
      pass 2: dx = gamma*r * (dy - xhat*dgamma/N - dbeta/N)
    Returns (y, mean, var); mean/var feed only the running-stat EMA and
    carry no gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, var, r = _bn_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, r)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, r = ctx.saved_tensors
        axes = tuple(range(x.ndim - 1))
        n = x.numel() // x.shape[-1]
        st = _stat_dtype(x.dtype)
        xhat = (x - mean.to(x.dtype)) * r.to(x.dtype)
        dyf = dy.to(st)
        dgamma = (dyf * xhat.to(st)).sum(axes)
        dbeta = dyf.sum(axes)
        k = (gamma.to(st) * r).to(x.dtype)
        dx = k * (dy - xhat * (dgamma / n).to(x.dtype)
                  - (dbeta / n).to(x.dtype))
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def _bn_train_global(x, gamma, beta, eps, axes, st, k=1):
    """Train-mode batchnorm with statistics over the GLOBAL batch of a
    per-step dp group (`collectives.dp_scope`), or over its leading
    ceil(N/k) ghost rows (`stat_sample=k`): each rank sums its own rows
    among them (`collectives.ghost_rows`: all, some or none) and the
    per-channel sums go through `collectives.dp_sum`, whose backward
    all-reduces the gradients reaching them, so plain autograd gives each
    rank its share of the global gradient. The count is the global row
    count of the statistics. The same one-pass / two-pass split as
    `_bn_stats`. Returns (y, mean, var)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    mine, total = collectives.ghost_rows(x.shape[0], k)
    n = total * (x[0].numel() // x.shape[-1])
    xs = x[:mine].to(st)
    mean = collectives.dp_sum(xs.sum(dim=axes)) / n
    if st == x.dtype:
        var = collectives.dp_sum(((xs - mean) ** 2).sum(dim=axes)) / n
    else:
        var = torch.clamp_min(
            collectives.dp_sum((xs * xs).sum(dim=axes)) / n - mean * mean,
            0.0)
    r = torch.rsqrt(var + eps)
    scale = gamma.to(st) * r
    shift = beta.to(st) - mean * scale
    y = x * scale.to(x.dtype) + shift.to(x.dtype)
    return y, mean.detach(), var.detach()


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

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        in_dtype = x.dtype
        stat_dtype = torch.float32 if is_low_precision(in_dtype) else in_dtype
        axes = tuple(range(x.ndim - 1))
        if train:
            return self._apply_train(params, x, state, stat_dtype, axes)
        if state is not None:
            mean, var = state["mean"], state["var"]
        else:
            mean, var = _bn_stats(x, axes, stat_dtype)
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

    def _apply_train(self, params, x, state, stat_dtype, axes):
        c = x.shape[-1]
        if not self.lock_gamma_beta and params:
            gamma, beta = params["gamma"], params["beta"]
        else:
            g0 = self.gamma if self.lock_gamma_beta else 1.0
            b0 = self.beta if self.lock_gamma_beta else 0.0
            gamma = torch.full((c,), g0, dtype=stat_dtype, device=x.device)
            beta = torch.full((c,), b0, dtype=stat_dtype, device=x.device)
        from deeplearning4j_tpu_torch.parallel import collectives

        if collectives.current() is not None:
            y, mean, var = _bn_train_global(x, gamma, beta, self.eps, axes,
                                            stat_dtype,
                                            int(self.stat_sample))
        elif self.stat_sample > 1:
            # ghost statistics of the leading ceil(B/k) rows, exact
            # autodiff through them (dgamma/dbeta stay full-tensor)
            nb = (x.shape[0] - 1) // int(self.stat_sample) + 1
            mean, var = _bn_stats(x[:nb], axes, stat_dtype)
            r = torch.rsqrt(var + self.eps)
            scale = gamma.to(stat_dtype) * r
            shift = beta.to(stat_dtype) - mean * scale
            y = x * scale.to(x.dtype) + shift.to(x.dtype)
        else:
            y, mean, var = BNTrain.apply(x, gamma, beta, self.eps)
        new_state = None
        if state is not None:
            with torch.no_grad():
                d = self.decay
                new_state = {
                    "mean": d * state["mean"] + (1.0 - d) * mean.detach(),
                    "var": d * state["var"] + (1.0 - d) * var.detach()}
        return y, new_state
