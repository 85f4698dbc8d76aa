"""Sharding rules (counterpart of deeplearning4j_tpu/parallel/sharding.py):
which rows of a batch a rank trains on, and the placement descriptors of
params and batches.

With one process per rank there is no global array to annotate: a rank
holds its own rows of the batch, and replicated params are the same
tensors on every rank. The descriptors below keep the JAX package's
names and the JAX package's pure shape rule for tensor parallelism
(`_tp_spec`, for ROADMAP queue 9c), so callers read one vocabulary.

  shard_batch(mesh, batch)     this rank's contiguous rows of each array
  pad_batch_with_masks(dp, x, y, fm, lm)
                               pad the leading dim to a dp multiple, the
                               padded rows masked out of the loss
  replicated / batch_sharding  descriptors (`Sharding`)
  param_shardings(mesh, params)
                               the tp rule's spec per leaf (all
                               replicated until queue 9c)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.util.tree import tree_map


@dataclass(frozen=True)
class Sharding:
    """A placement: `spec` names the mesh axis of each leading dim
    (None: replicated along that dim), as a JAX PartitionSpec does."""

    mesh: Any
    spec: Tuple[Optional[str], ...] = ()

    @property
    def replicated(self) -> bool:
        return all(a is None for a in self.spec)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh, ndim: int = None, axis: str = "dp",
                   seq_axis: Optional[str] = None) -> Sharding:
    """The leading (batch) dim over `axis`; optionally the second (time)
    dim over `seq_axis`."""
    spec = [axis] + ([seq_axis] if seq_axis is not None else [])
    return Sharding(mesh, tuple(spec))


def _tp_spec(shape, tp: int, tp_axis: str = "tp") -> Tuple:
    """The JAX package's tensor-parallel rule for one leaf, by shape only:
    shard the trailing (out-features) dim of a matrix when divisible,
    else its leading dim; a vector of at least 8*tp elements when
    divisible; everything else replicated."""
    shape = tuple(shape)
    ndim = len(shape)
    if tp == 1 or ndim == 0:
        return ()
    if ndim >= 2:
        if shape[-1] % tp == 0:
            return (None,) * (ndim - 1) + (tp_axis,)
        if shape[0] % tp == 0:
            return (tp_axis,) + (None,) * (ndim - 1)
        return ()
    if shape[0] % tp == 0 and shape[0] >= tp * 8:
        return (tp_axis,)
    return ()


def param_shardings(mesh, params: Any, tp_axis: str = "tp") -> Any:
    """The Sharding of each param leaf under the tp rule."""
    tp = mesh.shape.get(tp_axis, 1)
    return tree_map(lambda t: Sharding(mesh, _tp_spec(t.shape, tp, tp_axis)),
                    params)


def _rows(a, r: int, w: int):
    n = a.shape[0]
    if n % w:
        raise ValueError(f"batch of {n} rows does not split over dp={w}; "
                         "pad it (pad_batch_with_masks)")
    per = n // w
    return a[r * per:(r + 1) * per]


def shard_batch(mesh, batch: Any, axis: str = "dp",
                seq_axis: Optional[str] = None) -> Any:
    """This rank's contiguous rows of every array of `batch` (rank r of w
    takes rows [r*n/w, (r+1)*n/w)): the slice of the global batch a
    rank's device holds. Arrays keep their type (numpy or tensors)."""
    if seq_axis is not None:
        raise NotImplementedError(
            "sequence sharding is not ported yet (ROADMAP queue 9c)")
    w, r = mesh.shape[axis], mesh.rank

    def put(a):
        return None if a is None else _rows(a, r, w)

    if isinstance(batch, (tuple, list)):
        return type(batch)(put(a) for a in batch)
    return put(batch)


def pad_batch_with_masks(dp, x, y, fm, lm):
    """Pad one batch's leading dim to a dp multiple, masking padded rows
    out of the loss (the JAX package's `_pad_batch_with_masks`). Returns
    (x, y, fm, lm) as numpy arrays."""
    x = np.asarray(x)
    npad = (-x.shape[0]) % dp
    if npad:
        x = np.concatenate(
            [x, np.zeros((npad,) + x.shape[1:], x.dtype)], 0)
        y2 = np.asarray(y)
        y = np.concatenate(
            [y2, np.zeros((npad,) + y2.shape[1:], y2.dtype)], 0)
        if lm is None:
            lm = np.ones(
                (x.shape[0],) if y2.ndim == 2
                else (x.shape[0], y2.shape[1]), np.float32)
            lm[-npad:] = 0.0
        else:
            lm2 = np.asarray(lm)
            lm = np.concatenate(
                [lm2, np.zeros((npad,) + lm2.shape[1:], lm2.dtype)], 0)
        if fm is not None:
            fm2 = np.asarray(fm)
            fm = np.concatenate(
                [fm2, np.zeros((npad,) + fm2.shape[1:], fm2.dtype)], 0)
    return x, y, fm, lm


__all__ = ["Sharding", "batch_sharding", "pad_batch_with_masks",
           "param_shardings", "replicated", "shard_batch"]
