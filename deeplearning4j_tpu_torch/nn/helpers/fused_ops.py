"""Fused conv+BN+activation forward (counterpart of
deeplearning4j_tpu/nn/helpers/fused_ops.py).

Activations cross layers as (raw conv output, per-channel affine) pairs:

    u     = relu(scale*x + shift [+ scale2*x2 + shift2])  # BN-apply(+add)
    y_raw = conv(u, W) + b
    ssum, ssq = channel sums of y_raw                     # stats epilogue

`fused_conv` is the forward of the JAX package's op. The
`torch.autograd.Function` and its backward (with the dgrad/wgrad kernels)
come with slice 2.

impl="xla" (the "fused" helper mode) composes torch ops, as the JAX
package composes lax ops. impl="pallas" dispatches by geometry to the
hand-written kernels of pallas_conv.py, which compute exactly this
forward for the geometry they cover:
  * 1x1 stride 1                       -> fused_conv1x1
  * 3x3 stride 1, SAME                 -> fused_conv3x3
  * anything else (the 7x7 stem, the stride-2 1x1s) -> torch convolution
    with the prologue applied in torch.
A part of the prologue a kernel does not take is materialized in torch
first, at the same rounding points as `_prologue`: for the 1x1 kernel the
second affine term scale2*x2+shift2 becomes the kernel's plain `add`; for
the 3x3 kernel any x2 term means the whole of u is materialized first.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.helpers import pallas_conv
from deeplearning4j_tpu_torch.nn.layers.conv import conv2d_nhwc, resolve_padding


def _conv(u, w, stride, padding):
    return conv2d_nhwc(u, w, tuple(stride), padding)


def _second_term(x2, scale2, shift2):
    """The residual term scale2*x2+shift2 (or plain x2), or None."""
    if x2 is None or scale2 is None:
        return x2
    return pallas_conv.affine(x2, scale2, shift2)


def _prologue(x, scale, shift, x2, scale2, shift2, relu):
    return pallas_conv.prologue(x, scale, shift,
                                _second_term(x2, scale2, shift2), relu)


def kernel_route(w_shape, stride, padding, in_hw):
    """Which hand-written kernel computes conv(u, W) for this geometry:
    "conv1x1", "conv3x3" or None (torch convolution). `in_hw` (H, W)
    resolves "SAME"/explicit padding."""
    kh, kw = int(w_shape[0]), int(w_shape[1])
    if tuple(int(s) for s in stride) != (1, 1):
        return None
    pads = resolve_padding(padding, in_hw[0], in_hw[1], kh, kw, 1, 1)
    if (kh, kw) == (1, 1) and pads == ((0, 0), (0, 0)):
        return "conv1x1"
    if (kh, kw) == (3, 3) and pads == ((1, 1), (1, 1)):
        return "conv3x3"
    return None


def fused_conv(x, w, b, scale, shift, x2, scale2, shift2,
               stride, padding, relu, with_stats, impl="xla",
               emit_u: bool = True):
    """y_raw = conv(act(scale*x+shift [+ scale2*x2+shift2]), w) + b, plus
    channel sum/sumsq of y_raw and the materialized activation u.

    x/x2: [B,H,W,C] raw (pre-BN) inputs; scale*/shift*: [C] f32 affines
    (None = plain tensor); stride: (sh, sw); padding: lax padding spec;
    with_stats: 0/False = no statistics (eval), 1 = statistics of the full
    y, k>1 = statistics of the leading ceil(B/k) batch rows.

    Returns (y_raw [B,H,W,N], ssum [N] f32, ssq [N] f32, u). Port-only,
    as PyTorch runs eagerly and nothing eliminates unread results: u is
    returned only when `emit_u` (None otherwise), and ssum/ssq are None
    when with_stats is 0.
    """
    if impl == "pallas" and int(with_stats) <= 1:
        route = kernel_route(w.shape, stride, padding, x.shape[1:3])
        if route is not None:
            return _fwd_kernel(route, x, w, b, scale, shift, x2, scale2,
                               shift2, relu, with_stats, emit_u)
    y, ssum, ssq, u = _fwd_impl(x, w, b, scale, shift, x2, scale2, shift2,
                                stride, padding, relu, with_stats)
    return y, ssum, ssq, (u if emit_u else None)


def _fwd_impl(x, w, b, scale, shift, x2, scale2, shift2,
              stride, padding, relu, with_stats):
    u = _prologue(x, scale, shift, x2, scale2, shift2, relu)
    y = _conv(u, w, stride, padding)
    if b is not None:
        y = y + b.to(y.dtype)
    ssum = ssq = None
    if with_stats:
        yf = _stat_rows(y, int(with_stats)).float()
        ssum = yf.sum((0, 1, 2))
        ssq = (yf * yf).sum((0, 1, 2))
    return y, ssum, ssq, u


def _stat_rows(y, k):
    """Leading ceil(B/k) batch rows of y (k=1: y itself)."""
    if k <= 1:
        return y
    nb = (y.shape[0] - 1) // k + 1
    return y[:nb]


def _fwd_kernel(route, x, w, b, scale, shift, x2, scale2, shift2, relu,
                with_stats, emit_u):
    bsz, h, wd, k = x.shape
    n = w.shape[-1]
    stats = bool(with_stats)
    if route == "conv1x1":
        add = _second_term(x2, scale2, shift2)
        if add is not None:
            add = add.reshape(-1, k).contiguous()
        y, ssum, ssq, u = pallas_conv.fused_conv1x1(
            x.reshape(-1, k).contiguous(), w.reshape(k, n).contiguous(), b,
            scale, shift, add, relu=relu, emit_u=emit_u, stats=stats)
        y = y.reshape(bsz, h, wd, n)
        u = None if u is None else u.reshape(bsz, h, wd, k)
    else:
        if x2 is not None or emit_u:
            u = _prologue(x, scale, shift, x2, scale2, shift2, relu)
            y, ssum, ssq = pallas_conv.fused_conv3x3(
                u.contiguous(), w.contiguous(), b, stats=stats)
        else:
            u = None
            y, ssum, ssq = pallas_conv.fused_conv3x3(
                x.contiguous(), w.contiguous(), b, scale, shift, relu=relu,
                stats=stats)
    return y, ssum, ssq, (u if emit_u else None)


# ---------------------------------------------------------------- helpers


def bn_affine(gamma, beta, ssum, ssq, count, eps):
    """Fold BN statistics into the next conv's prologue affine (one-pass
    variance, as the JAX package). Returns (scale, shift, mean, var), f32."""
    mean = ssum / count
    var = torch.clamp_min(ssq / count - mean * mean, 0.0)
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    return scale, shift, mean, var


def bn_affine_inference(gamma, beta, mean, var, eps):
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    shift = beta.float() - mean.float() * scale
    return scale, shift
