"""Tensor-parallel compute over the tp axis (port-only: the JAX package
shards params with GSPMD annotations, parallel/sharding.py, and lets XLA
insert the collectives; one process per device has to say them).

Each rank of a tp group holds its slice of every param the shape rule
shards (`sharding._tp_spec`: the trailing dim when it divides, else the
leading dim; a vector of at least 8*tp elements when it divides) and of
the updater state that mirrors it. A train step then computes:

  - DenseLayer / OutputLayer whose W is sharded on its trailing dim (and
    which carry no L1/L2 penalty): column-parallel. The input passes
    through `copy_to_tp` (identity forward, all-reduce sum backward),
    each rank computes x @ W_r (+ b_r when the bias is sharded too), and
    `gather_dim` (all-gather forward, this rank's slice backward) joins
    the feature columns before the bias (when replicated) and the
    activation. The backward's dx is the sum of the ranks' partial
    products.
  - every other sharded leaf (conv kernels HWIO, BatchNorm's [C]
    vectors, recurrent gates, a leaf sharded on its leading dim, a
    penalized Dense) is gathered on use through `gather_dim`, so the
    layers, the fused helper tier and the four CUDA kernels see whole
    weights and their arithmetic is unchanged.

Every rank of a tp group trains on the same rows (the group replicates
the data-parallel work), so activations and the gradients of replicated
leaves agree across the group and each rank's update touches its slices
only. The gradient average of per-step dp runs over the dp axis alone.
Gradient normalization that needs a norm (a global-norm clip, the L2
modes) gathers the gradients whole, clips them as one process does and
keeps this rank's slices.

  TensorParallel(net, mesh)   the plan a ParallelWrapper attaches as
                              `net._tp` for a fit: `attach()` slices the
                              params and updater state, `detach()` gathers
                              them whole again
  tp_scope(group)             the active tp group of a loss evaluation
  linear(x, W, b, n_out)      x @ W + b, column-parallel for a sliced W
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.util.tree import leaves, tree_map


class _GatherMany(torch.autograd.Function):
    """All-gathers of several tensors, each along its own dim, in one
    collective per dtype (the slices packed into one flat buffer)
    forward; this rank's slice of each gradient backward."""

    @staticmethod
    def forward(ctx, group, dims, *xs):
        ctx.group, ctx.dims = group, dims
        ctx.sizes = [x.shape[d] for x, d in zip(xs, dims)]
        moved = [x.detach().movedim(d, 0).contiguous()
                 for x, d in zip(xs, dims)]
        outs = [None] * len(xs)
        by_dt = {}
        for i, m in enumerate(moved):
            by_dt.setdefault(m.dtype, []).append(i)
        w = group.world
        for idx in by_dt.values():
            full = collectives.all_gather(
                torch.cat([moved[i].reshape(-1) for i in idx]), group)
            parts = torch.split(full.view(w, -1),
                                [moved[i].numel() for i in idx], dim=1)
            for i, part in zip(idx, parts):
                m = moved[i]
                outs[i] = part.reshape((w * m.shape[0],) + tuple(
                    m.shape[1:])).movedim(0, dims[i]).contiguous()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        r = ctx.group.rank
        return (None, None) + tuple(
            None if g is None else g.narrow(d, r * c, c).contiguous()
            for g, d, c in zip(gs, ctx.dims, ctx.sizes))


class _Copy(torch.autograd.Function):
    """Identity forward; the all-reduce sum of the gradient over the
    group backward (each rank's partial product reaches the input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce_sum(g.contiguous().clone(),
                                          ctx.group), None


def gather_many(xs, dims, group):
    """The group's slices of each of `xs` joined along its dim of `dims`,
    in one collective per dtype (differentiable)."""
    if group.world == 1 or not xs:
        return list(xs)
    return list(_GatherMany.apply(
        group, tuple(d % x.ndim for x, d in zip(xs, dims)), *xs))


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's slices of `x` joined along `dim` (differentiable)."""
    return gather_many([x], [dim], group)[0]


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """`x` unchanged, its gradient summed over the group (differentiable)."""
    if group.world == 1:
        return x
    return _Copy.apply(x, group)


# ------------------------------------------------------------ the scope
_SCOPE = threading.local()


@contextlib.contextmanager
def tp_scope(group):
    """Within the block, `linear` computes column-parallel for a W whose
    trailing dim is a slice of the layer's n_out."""
    prev = getattr(_SCOPE, "group", None)
    _SCOPE.group = group
    try:
        yield
    finally:
        _SCOPE.group = prev


def current():
    return getattr(_SCOPE, "group", None)


def linear(x, W, b, n_out: Optional[int]):
    """x @ W + b; column-parallel (module docstring) when W holds a slice
    of the n_out columns under an active tp scope."""
    if n_out is None or W.shape[-1] == n_out:
        return x @ W + b
    group = current()
    if group is None or W.shape[-1] * group.world != n_out:
        raise ValueError(
            f"weight of {W.shape[-1]} columns for a layer of n_out={n_out} "
            "outside a tensor-parallel scope")
    y = copy_to_tp(x, group) @ W
    if b.shape[-1] != n_out:
        return gather_dim(y + b, -1, group)
    return gather_dim(y, -1, group) + b


# ------------------------------------------------------------- the plan
def _column_parallel(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer

    return (type(layer) in (DenseLayer, OutputLayer)
            and not (layer.l1 or layer.l2))


class TensorParallel:
    """One net's tensor-parallel plan over `mesh`'s tp axis (module
    docstring). `like` keeps the whole shape of every param leaf, the
    reference of every gather; `memory_facts()` reads this rank's param
    and updater bytes against the whole ones."""

    def __init__(self, net, mesh, tp_axis: str = "tp"):
        self.net, self.mesh, self.tp_axis = net, mesh, tp_axis
        self.group = mesh.group(tp_axis)
        self.tp = self.group.world
        self.like = None
        self.upd_like = None
        self.attached = False

    # -------------------------------------------------------- placement
    def attach(self) -> "TensorParallel":
        """Slice the net's params and updater state (the flat carry off,
        as the JAX package's `_disable_flat_chain`) and route its train
        step through this plan."""
        from deeplearning4j_tpu_torch.parallel.sharding import shard_params

        net = self.net
        if self.attached:
            return self
        if not net._initialized():
            net.init()
        net._materialize_flat()
        net._flat_chain = None
        # whole shapes as storage-free meta tensors (tree leaves, unlike
        # tuples, which the tree utilities read as containers)
        shapes = lambda tree: tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            tree)
        self.like = shapes(net.params)
        self.upd_like = shapes(net.updater_states)
        net.params = shard_params(self.mesh, net.params, self.tp_axis)
        net.updater_states = shard_params(self.mesh, net.updater_states,
                                          self.tp_axis)
        net._tp = self
        self.attached = True
        return self

    def detach(self) -> None:
        """Gather the params and updater state whole on every rank and
        return the net to its one-process step."""
        from deeplearning4j_tpu_torch.parallel.sharding import gather_params

        net = self.net
        if not self.attached:
            return
        with torch.no_grad():
            net.params = gather_params(self.mesh, net.params, self.like,
                                       self.tp_axis)
            net.updater_states = gather_params(
                self.mesh, net.updater_states, self.upd_like, self.tp_axis)
        net._tp = None
        net._flat_chain = "uninit"
        self.attached = False

    def memory_facts(self) -> dict:
        """This rank's param and updater-state bytes against the whole
        ones (read while attached)."""
        def count(tree, like):
            size = lambda ts: sum(int(t.numel()) * t.element_size()
                                  for t in leaves(ts))
            return size(tree), size(like)

        pl, pf = count(self.net.params, self.like)
        ul, uf = count(self.net.updater_states, self.upd_like)
        return {"param_bytes": pl, "param_bytes_full": pf,
                "updater_bytes": ul, "updater_bytes_full": uf,
                "param_fraction": pl / pf if pf else 1.0,
                "updater_fraction": ul / uf if uf else 1.0,
                "tp": self.tp}

    # ----------------------------------------------------- the train step
    def expand(self, params):
        """The params a loss evaluation reads: every sharded leaf gathered
        on use (all of them in one collective per dtype), except the W
        (and b) of a column-parallel layer whose W is sharded on its
        trailing dim, which `linear` consumes as slices."""
        net = self.net
        items = net._layer_items()
        likes = [self.like[k] for k, _ in items]
        sliced = [_column_parallel(layer) and bool(params[k])
                  and like["W"].ndim == 2
                  and params[k]["W"].shape != like["W"].shape
                  and params[k]["W"].shape[0] == like["W"].shape[0]
                  for (k, layer), like in zip(items, likes)]
        whole = self._gather(
            [None if s else params[k] for (k, _), s in zip(items, sliced)],
            [None if s else like for like, s in zip(likes, sliced)])
        return net._pack([params[k] if s else w
                          for (k, _), s, w in zip(items, sliced, whole)])

    def _gather(self, p, like):
        from deeplearning4j_tpu_torch.parallel.sharding import gather_params

        return gather_params(self.mesh, p, like, self.tp_axis)

    def clip(self, conf, grads):
        """`clip_grads` as one process computes it: norm-based modes on
        the gathered whole gradients, then this rank's slices again."""
        from deeplearning4j_tpu_torch.nn.base_network import clip_grads
        from deeplearning4j_tpu_torch.parallel.sharding import shard_params

        gn = conf.gradient_normalization
        if not conf.max_grad_norm and (
                not gn or gn in ("none", "clip_element_wise_absolute_value")):
            return clip_grads(conf, grads)
        whole = self._gather(grads, self._like_of(grads))
        return shard_params(self.mesh, clip_grads(conf, whole),
                            self.tp_axis)

    def _like_of(self, grads):
        """`like` with the positions of `grads`' None leaves (a frozen
        layer) dropped, so leaves align."""
        return tree_map(lambda g, s: s, grads, self.like)


__all__ = ["TensorParallel", "copy_to_tp", "current", "gather_dim",
           "gather_many", "linear", "tp_scope"]
