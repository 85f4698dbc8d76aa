"""Standalone NN utility functions (counterpart of
deeplearning4j_tpu/util/nn_utils.py): time-series helpers (the moving
average, the [B, T] mask and [B, T, C] activation reshapes, the masked
reverse), convolution geometry (output size, SAME padding, validation)
and masked pooling over time or space. Tensors in, tensors out (the
geometry helpers take and return ints), with the JAX package's values."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def moving_average(x, n: int):
    """Trailing moving average over the last axis, length L-n+1."""
    c = torch.cumsum(x, dim=-1)
    return torch.cat([c[..., n - 1:n], c[..., n:] - c[..., :-n]],
                     dim=-1) / n


def reshape_time_series_mask_to_vector(mask):
    """[B, T] -> [B*T, 1]."""
    return mask.reshape(-1, 1)


def reshape_vector_to_time_series_mask(vec, minibatch: int):
    """[B*T, 1] -> [B, T] (inverse of reshape_time_series_mask_to_vector)."""
    return vec.reshape(minibatch, -1)


def reshape_3d_to_2d(x):
    """[B, T, C] activations -> [B*T, C]."""
    b, t, c = x.shape
    return x.reshape(b * t, c)


def reshape_2d_to_3d(x, minibatch: int):
    """[B*T, C] -> [B, T, C]."""
    return x.reshape(minibatch, -1, x.shape[-1])


def reverse_time_series(x, mask=None):
    """Reverse along time; with a [B, T] mask each sequence's valid prefix
    is reversed in place and the padding stays at the tail."""
    if mask is None:
        return torch.flip(x, dims=(1,))
    lengths = torch.sum(mask > 0, dim=1).to(torch.long)           # [B]
    idx = torch.arange(x.shape[1], device=x.device)[None, :]      # [1, T]
    rev = lengths[:, None] - 1 - idx
    src = torch.where(rev >= 0, rev, idx)                         # [B, T]
    src = src.reshape(src.shape + (1,) * (x.ndim - 2)).expand_as(x)
    return torch.gather(x, 1, src)


def get_output_size(input_hw: Sequence[int], kernel: Sequence[int],
                    strides: Sequence[int], padding: Sequence[int],
                    same_mode: bool = False,
                    dilation: Sequence[int] = (1, 1)) -> Tuple[int, int]:
    """Spatial output size: ceil(in/stride) in SAME mode, else
    floor((in + 2p - k_eff)/s) + 1 with k_eff the dilated kernel."""
    validate_cnn_kernel_stride_padding(kernel, strides, padding)
    out = []
    for i in range(2):
        k_eff = kernel[i] + (kernel[i] - 1) * (dilation[i] - 1)
        if same_mode:
            out.append(-(-input_hw[i] // strides[i]))
        else:
            span = input_hw[i] + 2 * padding[i] - k_eff
            if span < 0:
                raise ValueError(
                    f"kernel {kernel[i]} (dilated {k_eff}) larger than "
                    f"padded input {input_hw[i] + 2 * padding[i]} on "
                    f"axis {i}")
            out.append(span // strides[i] + 1)
    return tuple(out)


def get_same_mode_top_left_padding(out_size, in_size, kernel, strides):
    """Asymmetric SAME padding: the top/left share."""
    return tuple(
        max((out_size[i] - 1) * strides[i] + kernel[i] - in_size[i], 0)
        // 2 for i in range(2))


def get_same_mode_bottom_right_padding(out_size, in_size, kernel,
                                       strides):
    """Asymmetric SAME padding: the bottom/right share."""
    total = [max((out_size[i] - 1) * strides[i] + kernel[i]
                 - in_size[i], 0) for i in range(2)]
    tl = get_same_mode_top_left_padding(out_size, in_size, kernel, strides)
    return tuple(total[i] - tl[i] for i in range(2))


def validate_cnn_kernel_stride_padding(kernel, strides, padding):
    """Two kernel sizes and strides of at least 1, two paddings of at
    least 0; raises ValueError otherwise."""
    for name, v, lo in (("kernel", kernel, 1), ("stride", strides, 1),
                        ("padding", padding, 0)):
        if len(v) != 2:
            raise ValueError(f"{name} must have 2 elements: {v}")
        if any(int(e) < lo for e in v):
            raise ValueError(f"{name} values must be >= {lo}: {v}")


def _masked_pool(pooling_type, x, m, axes):
    if pooling_type == "max":
        neg = torch.finfo(x.dtype).min
        return torch.amax(torch.where(m > 0, x, neg), dim=axes)
    if pooling_type == "sum":
        return torch.sum(x * m, dim=axes)
    if pooling_type == "avg":
        return torch.sum(x * m, dim=axes) / torch.clamp_min(
            torch.sum(m, dim=axes), 1.0)
    raise ValueError(f"unknown pooling type '{pooling_type}' "
                     "(known: max, avg, sum)")


def masked_pooling_time_series(pooling_type: str, x, mask):
    """[B, T, C] pooled over time under a [B, T] mask: max | avg | sum."""
    return _masked_pool(pooling_type, x, mask[:, :, None], (1,))


def masked_pooling_convolution(pooling_type: str, x, mask):
    """[B, H, W, C] pooled over space under a [B, H, W] mask."""
    return _masked_pool(pooling_type, x, mask[:, :, :, None], (1, 2))
