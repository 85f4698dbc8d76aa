"""Mask helpers for time series (counterpart of the mask part of
deeplearning4j_tpu/util/nn_utils.py): the [B, T] mask reshapes, the
masked time-series reverse, and masked pooling over time or space. Each
takes and returns tensors and gives the JAX package's values."""

from __future__ import annotations

import torch


def reshape_time_series_mask_to_vector(mask):
    """[B, T] -> [B*T, 1]."""
    return mask.reshape(-1, 1)


def reshape_vector_to_time_series_mask(vec, minibatch: int):
    """[B*T, 1] -> [B, T] (inverse of reshape_time_series_mask_to_vector)."""
    return vec.reshape(minibatch, -1)


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
