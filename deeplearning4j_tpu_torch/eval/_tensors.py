"""Inputs and accumulators of the port's evaluations, and `host`, the
port's one tensor-to-numpy conversion for data and evaluation."""

from __future__ import annotations

import numpy as np
import torch


def on(x, device, dtype=None) -> torch.Tensor:
    """`x` (a numpy array, a list or a tensor on any device) as a tensor
    on `device`, detached, in `dtype` when given (else its own)."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))
    return t.to(device=device, dtype=dtype)


def host(x) -> np.ndarray:
    """`x` (a tensor on any device, a numpy array or a list) as a numpy
    array; bfloat16, which numpy lacks, becomes float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def rows(labels, predictions, mask, device, dtype=None):
    """Labels and predictions as [N, C] tensors on `device` and a [N]
    weight (1 keeps a row, 0 drops it): a [N, T, C] time series is
    flattened to rows, its [N, T] mask (if any) becoming the weights; a
    2-D input keeps every row unless `mask` is given."""
    lab, pred = on(labels, device, dtype), on(predictions, device, dtype)
    if lab.ndim == 3:
        lab = lab.reshape(-1, lab.shape[-1])
        pred = pred.reshape(-1, pred.shape[-1])
    w = (torch.ones(lab.shape[0], dtype=torch.int64, device=device)
         if mask is None else
         (on(mask, device).reshape(-1) != 0).to(torch.int64))
    return lab, pred, w
