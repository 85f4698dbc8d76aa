"""ConvolutionLayer, SubsamplingLayer, ZeroPaddingLayer,
LocalResponseNormalization, and Convolution1DLayer / Subsampling1DLayer
over recurrent [B, T, C] input (counterpart of
deeplearning4j_tpu/nn/layers/conv.py).

Activations are NHWC and kernels HWIO, as in the JAX package. Torch's
convolution and pooling take NCHW, so they get a `permute` view; a
contiguous NHWC tensor viewed that way is channels_last, which is what
cuDNN prefers anyway.

Padding follows lax: "SAME" pads a total of max((out-1)*s + k_eff - n, 0)
with the SMALLER half first. For an odd total (the 7x7 stride-2 stem on
224 pads (2, 3); the 3x3 stride-2 max-pool on 112 pads (0, 1)) torch's
symmetric `padding=` is wrong, so every pad here is explicit, with -inf
for max-pooling as lax.reduce_window's init value.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, Layer
from deeplearning4j_tpu_torch.nn.weights import init_weights


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _out_dim(size, k, s, pad, mode, dilation=1):
    if mode == "same":
        return -(-size // s)  # ceil
    k_eff = k + (k - 1) * (dilation - 1)
    return (size + 2 * pad - k_eff) // s + 1


def same_pads(size: int, k: int, s: int, dilation: int = 1) -> Tuple[int, int]:
    """lax "SAME" padding of one spatial dim: (low, high), low <= high."""
    k_eff = k + (k - 1) * (dilation - 1)
    out = -(-size // s)
    total = max((out - 1) * s + k_eff - size, 0)
    return total // 2, total - total // 2


def resolve_padding(padding, h, w, kh, kw, sh, sw, dh=1, dw=1):
    """lax padding spec ("SAME" / "VALID" / ((ph0, ph1), (pw0, pw1)))
    -> explicit ((top, bottom), (left, right))."""
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return same_pads(h, kh, sh, dh), same_pads(w, kw, sw, dw)
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        raise ValueError(f"unknown padding {padding!r}")
    (pt, pb), (pl, pr) = padding
    return (int(pt), int(pb)), (int(pl), int(pr))


def conv2d_nhwc(x, w, stride=(1, 1), padding="SAME", dilation=(1, 1)):
    """lax.conv_general_dilated with ("NHWC", "HWIO", "NHWC") semantics:
    x [B,H,W,C], w [kh,kw,C,N] -> [B,H',W',N]."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    sh, sw = stride
    dh, dw = dilation
    (pt, pb), (pl, pr) = resolve_padding(
        padding, x.shape[1], x.shape[2], kh, kw, sh, sw, dh, dw)
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=(sh, sw), dilation=(dh, dw))
    return y.permute(0, 2, 3, 1)


@dataclass(kw_only=True)
class ConvolutionLayer(BaseLayer):
    """2D convolution over NHWC input. convolution_mode: 'truncate'
    (explicit symmetric padding, floor division) or 'same'."""

    kernel_size: Sequence[int] = (5, 5)
    stride: Sequence[int] = (1, 1)
    padding: Sequence[int] = (0, 0)
    convolution_mode: str = "truncate"
    activation: Optional[str] = "identity"
    dilation: Sequence[int] = (1, 1)

    def set_n_in(self, input_type: InputType) -> None:
        if not isinstance(input_type, InputTypeConvolutional):
            raise ValueError(f"ConvolutionLayer needs CNN input, got {input_type}")
        self.n_in = input_type.channels

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        mode = self.convolution_mode
        h = _out_dim(input_type.height, kh, sh, ph, mode, dh)
        w = _out_dim(input_type.width, kw, sw, pw, mode, dw)
        if h <= 0 or w <= 0:
            raise ValueError(
                f"Invalid conv output {h}x{w} from {input_type} with "
                f"k={self.kernel_size} s={self.stride} p={self.padding}")
        return InputType.convolutional(h, w, self.n_out)

    def lax_padding(self):
        if self.convolution_mode == "same":
            return "SAME"
        ph, pw = _pair(self.padding)
        return ((ph, ph), (pw, pw))

    def init_params(self, gen, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel_size)
        W = init_weights(
            self.weight_init, gen, (kh, kw, self.n_in, self.n_out),
            fan_in=self.n_in * kh * kw, fan_out=self.n_out * kh * kw,
            dtype=dtype)
        b = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return {"W": W, "b": b}

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        x = self._maybe_dropout_input(x, train, rng)
        y = conv2d_nhwc(x, params["W"], _pair(self.stride),
                        self.lax_padding(), _pair(self.dilation))
        y = y + params["b"]
        return get_activation(self.activation)(y), state


@dataclass(kw_only=True)
class Convolution1DLayer(BaseLayer):
    """1D convolution over [B, T, C] input: W [k, nIn, nOut], lax
    semantics ("same" pads as lax "SAME", else `padding` on both
    sides)."""

    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    convolution_mode: str = "same"
    activation: Optional[str] = "identity"

    def set_n_in(self, input_type: InputType) -> None:
        if not isinstance(input_type, InputTypeRecurrent):
            raise ValueError(
                f"Convolution1D needs recurrent input, got {input_type}")
        self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeseries_length
        if t is not None:
            t = _out_dim(t, self.kernel_size, self.stride, self.padding,
                         self.convolution_mode)
        return InputType.recurrent(self.n_out, t)

    def init_params(self, gen, input_type, dtype=torch.float32):
        k = self.kernel_size
        W = init_weights(self.weight_init, gen, (k, self.n_in, self.n_out),
                         fan_in=self.n_in * k, fan_out=self.n_out * k,
                         dtype=dtype)
        b = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return {"W": W, "b": b}

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        x = self._maybe_dropout_input(x, train, rng)
        if self.convolution_mode == "same":
            lo, hi = same_pads(x.shape[1], self.kernel_size, self.stride)
        else:
            lo = hi = self.padding
        xc = F.pad(x.transpose(1, 2), (lo, hi))               # [B, C, T]
        y = F.conv1d(xc, params["W"].permute(2, 1, 0), stride=self.stride)
        return get_activation(self.activation)(
            y.transpose(1, 2) + params["b"]), state


@dataclass(kw_only=True)
class SubsamplingLayer(Layer):
    """Spatial pooling (max/avg/sum/pnorm) over NHWC input, with
    lax.reduce_window semantics (avg divides by the full window, padded
    cells included)."""

    pooling_type: str = "max"
    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    padding: Sequence[int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        h = _out_dim(input_type.height, kh, sh, ph, self.convolution_mode)
        w = _out_dim(input_type.width, kw, sw, pw, self.convolution_mode)
        return InputType.convolutional(h, w, input_type.channels)

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        if self.convolution_mode == "same":
            pad = "SAME"
        else:
            ph, pw = _pair(self.padding)
            pad = ((ph, ph), (pw, pw))
        (pt, pb), (pl, pr) = resolve_padding(
            pad, x.shape[1], x.shape[2], kh, kw, sh, sw)
        pt_ = self.pooling_type.lower()
        if pt_ == "max":
            fill = float("-inf")
        elif pt_ in ("avg", "sum", "pnorm"):
            fill = 0.0
        else:
            raise ValueError(f"Unknown pooling type {self.pooling_type}")
        if pt_ == "pnorm":
            x = torch.abs(x) ** float(self.pnorm)
        if pt or pb or pl or pr:
            x = F.pad(x, (0, 0, pl, pr, pt, pb), value=fill)
        xc = x.permute(0, 3, 1, 2)
        if pt_ == "max":
            y = F.max_pool2d(xc, (kh, kw), (sh, sw))
        elif pt_ == "avg":
            y = F.avg_pool2d(xc, (kh, kw), (sh, sw))
        else:
            y = F.avg_pool2d(xc, (kh, kw), (sh, sw)) * (kh * kw)
            if pt_ == "pnorm":
                y = y ** (1.0 / float(self.pnorm))
        return y.permute(0, 2, 3, 1), state


@dataclass(kw_only=True)
class Subsampling1DLayer(Layer):
    """Temporal pooling over [B, T, C] (max/avg/sum/pnorm), `padding`
    on both sides, lax.reduce_window semantics (avg divides by the
    whole window)."""

    pooling_type: str = "max"
    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeseries_length
        if t is not None:
            t = _out_dim(t, self.kernel_size, self.stride, self.padding,
                         "truncate")
        return InputType.recurrent(input_type.size, t)

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        pt = self.pooling_type.lower()
        if pt not in ("max", "avg", "sum", "pnorm"):
            raise ValueError(
                f"Unknown pooling_type '{self.pooling_type}' "
                "(known: max, avg, sum, pnorm)")
        k, s, p = self.kernel_size, self.stride, self.padding
        if pt == "pnorm":
            x = torch.abs(x) ** float(self.pnorm)
        xc = F.pad(x.transpose(1, 2), (p, p),
                   value=float("-inf") if pt == "max" else 0.0)
        if pt == "max":
            y = F.max_pool1d(xc, k, s)
        else:
            y = F.avg_pool1d(xc, k, s)
            if pt != "avg":
                y = y * k
            if pt == "pnorm":
                y = y ** (1.0 / float(self.pnorm))
        return y.transpose(1, 2), state


@dataclass(kw_only=True)
class ZeroPaddingLayer(Layer):
    """Zero-pads the spatial dims of NHWC input. padding = (top, bottom,
    left, right), or (h, w) for symmetric padding."""

    padding: Sequence[int] = (1, 1)

    def _pads(self):
        p = tuple(int(v) for v in self.padding)
        if len(p) == 2:
            return (p[0], p[0], p[1], p[1])
        if len(p) == 4:
            return p
        raise ValueError(f"padding must have 2 or 4 elements, got {p}")

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self._pads()
        return InputType.convolutional(
            input_type.height + t + b, input_type.width + l + r,
            input_type.channels)

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        t, b, l, r = self._pads()
        return F.pad(x, (0, 0, l, r, t, b)), state


@dataclass(kw_only=True)
class LocalResponseNormalization(Layer):
    """Cross-channel LRN over NHWC: x / (k + alpha * s)^beta, with s the
    sum of x^2 over a window of n channels centred on each channel (zero
    outside), as the JAX package's lax.reduce_window computes it: the
    window sum runs in x's dtype, so in bf16 each partial sum is rounded
    to bf16, in the window's order (the channel below first)."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        half = self.n // 2
        c = x.shape[-1]
        sq = F.pad(x * x, (half, half))
        ssum = sq[..., 0:c]
        for j in range(1, self.n):
            ssum = ssum + sq[..., j:j + c]
        # alpha rounded to x's dtype first, as JAX rounds a Python scalar
        alpha = torch.full((), self.alpha, dtype=x.dtype, device=x.device)
        denom = (self.k + alpha * ssum) ** self.beta
        return x / denom, state
