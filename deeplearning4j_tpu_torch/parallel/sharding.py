"""Sharding rules (counterpart of deeplearning4j_tpu/parallel/sharding.py):
which rows (and time steps) of a batch a rank trains on, which slice of
each param it holds under tensor parallelism, and the placement
descriptors of params and batches.

With one process per rank there is no global array to annotate: a rank
holds its own rows of the batch and its own slices of the params. The
descriptors below keep the JAX package's names and its pure shape rule
for tensor parallelism (`_tp_spec`), so callers read one vocabulary.

  shard_batch(mesh, batch, axis="dp", seq_axis=None)
                               this rank's contiguous rows of each array
                               (by its dp coordinate), and with
                               `seq_axis` its contiguous time steps
                               (dim 1, by its coordinate on that axis)
  pad_batch_with_masks(dp, x, y, fm, lm)
                               pad the leading dim to a dp multiple, the
                               padded rows masked out of the loss
  replicated / batch_sharding  descriptors (`Sharding`)
  param_shardings(mesh, params)
                               the tp rule's Sharding per leaf
  shard_params(mesh, params)   this rank's slice of every leaf
  gather_params(mesh, sliced, like)
                               the whole leaves again (all-gathers over
                               the tp group), inverting shard_params
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np

import torch

from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten


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


def _tp_dim(spec) -> Optional[int]:
    """The dim a spec shards (None: replicated)."""
    for d, a in enumerate(spec):
        if a is not None:
            return d
    return None


def _slice(a, dim: int, r: int, w: int):
    n = a.shape[dim]
    per = n // w
    return a.narrow(dim, r * per, per) if isinstance(a, torch.Tensor) \
        else np.take(a, np.arange(r * per, (r + 1) * per), axis=dim)


def shard_params(mesh, params: Any, tp_axis: str = "tp") -> Any:
    """This rank's placement of a params (or updater state) tree under
    the tp rule: each sharded leaf cut to its contiguous slice along the
    sharded dim by this rank's tp coordinate (a copy), the rest whole.
    Leaves keep their type (tensors or numpy)."""
    tp, r = mesh.shape.get(tp_axis, 1), mesh.coords.get(tp_axis, 0)

    def put(a):
        if a is None:
            return None
        d = _tp_dim(_tp_spec(tuple(a.shape), tp, tp_axis))
        if d is None:
            return a
        out = _slice(a, d, r, tp)
        return out.clone() if isinstance(out, torch.Tensor) else out

    return tree_map(put, params)


def gather_params(mesh, sliced: Any, like: Any, tp_axis: str = "tp") -> Any:
    """Invert `shard_params`: every leaf the tp rule shards (by the shape
    of its whole counterpart in `like`, a tree of whole leaves or of
    their shapes) all-gathered over the tp group along its sharded dim,
    all of them in one collective per dtype; the rest passed through.
    Differentiable (tensor_parallel.gather_many): the backward hands each
    rank its slice of the gradient."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import gather_many

    tp = mesh.shape.get(tp_axis, 1)
    ls = leaves(sliced)
    if tp == 1 or not ls:
        return sliced
    shapes = [tuple(getattr(t, "shape", t)) for t in leaves(like)]
    idx, dims = [], []
    for i, (t, shape) in enumerate(zip(ls, shapes)):
        d = _tp_dim(_tp_spec(shape, tp, tp_axis))
        if d is not None and tuple(t.shape) != shape:
            idx.append(i)
            dims.append(d)
    out = list(ls)
    for i, full in zip(idx, gather_many([ls[i] for i in idx], dims,
                                        mesh.group(tp_axis))):
        out[i] = full
    return unflatten(sliced, out)[0]


def _rows(a, r: int, w: int, dim: int = 0, what: str = "dp"):
    n = a.shape[dim]
    if n % w:
        if dim:
            raise ValueError(f"sequence of {n} steps does not split over "
                             f"{what}={w}")
        raise ValueError(f"batch of {n} rows does not split over dp={w}; "
                         "pad it (pad_batch_with_masks)")
    per = n // w
    return a[(slice(None),) * dim + (slice(r * per, (r + 1) * per),)]


def shard_batch(mesh, batch: Any, axis: str = "dp",
                seq_axis: Optional[str] = None) -> Any:
    """This rank's contiguous rows of every array of `batch` (coordinate
    r of w along `axis` takes rows [r*n/w, (r+1)*n/w)), and with
    `seq_axis` (JAX's P(axis, seq_axis)) its contiguous time steps of
    every array of two or more dims, by its coordinate on that axis: the
    slice of the global batch a rank's device holds. Arrays keep their
    type (numpy or tensors)."""
    w, r = mesh.shape[axis], mesh.coords.get(axis, mesh.rank)
    if seq_axis is not None:
        sw, sr = mesh.shape[seq_axis], mesh.coords.get(seq_axis, 0)

    def put(a):
        if a is None:
            return None
        a = _rows(a, r, w)
        if seq_axis is not None and a.ndim > 1:
            a = _rows(a, sr, sw, dim=1, what=seq_axis)
        return a

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


__all__ = ["Sharding", "batch_sharding", "gather_params",
           "pad_batch_with_masks", "param_shardings", "replicated",
           "shard_batch", "shard_params"]
