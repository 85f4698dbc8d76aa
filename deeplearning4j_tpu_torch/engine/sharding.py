"""ZeRO-1 sharding policy and the sharded train step (counterpart of
deeplearning4j_tpu/engine/sharding.py; arXiv 2004.13336).

In plain data-parallel training every replica applies the same update to
the same replicated optimizer state. ZeRO-1 shards the update: each rank
keeps only its slice of the optimizer state, reduce-scatters the gradient
so it owns the matching slice, updates its slice, and all-gathers the
updated parameters for the next forward pass.

Two halves, kept in one module because they must agree on ONE slicing
convention:

  host half   `zero1_leaf_sharded` / `slice_bounds` / `slice_rows` /
              `assemble_rows` / `reslice`: the JAX package's numpy slice
              arithmetic, copied as it is. A leaf shards over dp iff its
              leading dim divides dp; everything else stays replicated.
              Both packages keep conv kernels HWIO, so the same leaves
              shard in both and the `*.updshard.npz` sidecars read across
              the packages.
  step half   `build_zero1_step`: the port's sharded step, with the
              net's `_step` signature, over the per-layer trees (never
              the flat carry, whose one vector would have to be gathered
              whole); `build_zero1_group`: k of those steps over
              [k, ...]-stacked data, the body `StepProgram.run_group`
              runs (and on CUDA captures into one graph) under a mesh.
              The ZeRO-1 step:
                1. forward and backward on the full params, BatchNorm
                   statistics and the loss's row count global over the
                   group (`collectives.dp_scope`);
                2. the gradient rows of the sharded leaves packed rank by
                   rank into one buffer and reduce-scattered (this rank
                   receives the sum of its rows), the replicated leaves
                   and the loss all-reduced in a second buffer, both
                   divided by the world: the mean the unsharded step's
                   all-reduce gives;
                3. the elementwise updater rule on this rank's slices
                   (the same `_apply_updates` the unsharded step runs);
                4. the updated slices all-gathered into the full params.
              A norm-based gradient normalization needs the whole
              gradient, so with one the gradient is all-reduced whole,
              normalized, and sliced instead of reduce-scattered.

Byte-parity contract: every shipped updater rule is elementwise, so
updating a slice equals slicing the update, and over two ranks (or one)
the reduce-scatter adds the same two numbers the all-reduce adds; the
sharded step therefore equals the unsharded one bit for bit, params and
updater state.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

ZERO1_AXIS = "dp"

# gradient normalizations that read a whole layer's (or the whole
# model's) gradient: ZeRO-1 all-reduces the gradient whole for them
_NORM_MODES = ("clip_l2_per_layer", "renormalize_l2_per_layer",
               "clip_l2_per_param_type", "renormalize_l2_per_param_type")


# ------------------------------------------------------ host-side slicing
def zero1_leaf_sharded(shape: Sequence[int], dp: int) -> bool:
    """True when a leaf of this shape shards its leading dim over a
    dp-extent mesh axis: non-scalar, leading dim divisible by dp
    (indivisible leaves stay replicated, a best-effort ZeRO exactly like
    arXiv 2004.13336's per-tensor applicability)."""
    shape = tuple(shape)
    return (dp > 1 and len(shape) >= 1 and shape[0] > 0
            and shape[0] % dp == 0)


def slice_bounds(n_rows: int, rank: int, world: int) -> Tuple[int, int]:
    """Row interval [lo, hi) of process `rank`'s slice of a sharded
    leaf: rows [rank*n/world, (rank+1)*n/world) — the one convention
    checkpoint save, resume resharding, and the in-memory staging all
    derive from."""
    if n_rows % world:
        raise ValueError(
            f"leaf with {n_rows} rows cannot slice over world {world}")
    per = n_rows // world
    return rank * per, (rank + 1) * per


def slice_rows(arr: np.ndarray, rank: int, world: int) -> np.ndarray:
    lo, hi = slice_bounds(arr.shape[0], rank, world)
    return np.ascontiguousarray(np.asarray(arr)[lo:hi])


def assemble_rows(slices: Dict[int, np.ndarray],
                  world: int) -> np.ndarray:
    """Reassemble one full leaf from {shard_rank: slice}. Requires a
    COMPLETE slice set (every rank 0..world-1) — a missing slice is a
    hole in the optimizer state and must fail loudly, never be
    zero-filled."""
    missing = [r for r in range(world) if r not in slices]
    if missing:
        raise ValueError(
            f"incomplete sharded state: missing slice(s) for "
            f"rank(s) {missing} of world {world}")
    return np.concatenate([np.asarray(slices[r])
                           for r in range(world)], axis=0)


def reslice(full: np.ndarray, new_world: int) -> List[np.ndarray]:
    """Re-slice a fully-assembled leaf for a different world size —
    the elastic 3→2 shrink's resharding-on-resume primitive."""
    return [slice_rows(full, r, new_world) for r in range(new_world)]


# ------------------------------------------------------- the sharded step
def _reduce_grads(conf, like, grads, sharded, repl, loss, group):
    """Step 2 (module docstring): ([my slice of each gradient leaf, or the
    whole leaf], mean loss) from the local gradients, every collective
    over the dp axis `group` (an AxisGroup: its size and this rank's
    coordinate pick the slices). `sharded` and `repl` index the leaves
    that have a gradient; `like` is the params tree the gradient
    normalization reads the layers from."""
    from deeplearning4j_tpu_torch.nn.base_network import clip_grads
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.util.tree import leaves, unflatten

    def clip(gs):
        return leaves(clip_grads(conf, unflatten(like, gs)[0])) \
            if any(g is not None for g in gs) else gs

    world, rank = group.world, group.rank
    out = list(grads)
    gdt = grads[(sharded + repl)[0]].dtype
    lv = loss.detach().reshape(1).to(gdt)
    if conf.max_grad_norm or conf.gradient_normalization in _NORM_MODES:
        idx = sharded + repl
        buf = C.dp_all_reduce_mean(torch.cat(
            [grads[i].reshape(-1) for i in idx] + [lv]), group)
        parts = torch.split(buf, [grads[i].numel() for i in idx] + [1])
        for p, i in zip(parts, idx):
            out[i] = p.view(grads[i].shape)
        out = _with_none(clip(out), grads)
        for i in sharded:
            lo, hi = slice_bounds(out[i].shape[0], rank, world)
            out[i] = out[i][lo:hi]
        return out, parts[-1][0].to(loss.dtype)
    if sharded:
        send = torch.cat([grads[i].reshape(world, -1) for i in sharded],
                         dim=1).reshape(-1)
        mine = C.reduce_scatter(send, group)
        mine.div_(world)
        for i, p in zip(sharded, torch.split(
                mine, [grads[i].numel() // world for i in sharded])):
            out[i] = p.view((grads[i].shape[0] // world,)
                            + tuple(grads[i].shape[1:]))
    buf = C.dp_all_reduce_mean(torch.cat(
        [grads[i].reshape(-1) for i in repl] + [lv]), group)
    parts = torch.split(buf, [grads[i].numel() for i in repl] + [1])
    for i, p in zip(repl, parts):
        out[i] = p.view(grads[i].shape)
    return _with_none(clip(out), grads), parts[-1][0].to(loss.dtype)


def _with_none(vals, grads):
    """`vals` (the leaves a clip returned, None leaves dropped) back at
    the positions of `grads`' non-None leaves."""
    it = iter(vals)
    return [None if g is None else next(it) for g in grads]


def _aligned(like, tree) -> list:
    """The leaves of `tree` at the positions of `like`'s leaves (None where
    `tree` has none: a frozen layer's gradient)."""
    if like is None:
        return []
    if isinstance(like, dict):
        return [a for k in sorted(like) for a in _aligned(
            like[k], None if tree is None else tree.get(k))]
    if isinstance(like, (list, tuple)):
        return [a for i, v in enumerate(like) for a in _aligned(
            v, None if tree is None else tree[i])]
    return [tree]


def build_zero1_step(net, manager):
    """The ZeRO-1 train step of `net` over `manager`'s dp group
    (engine/mesh.py MeshManager): a callable with the net's `_step`
    signature on a carry of (full params, updater state with the sharded
    leaves as this rank's slices, BN states). Every collective of the step
    (BatchNorm's sums, the reduce-scatter, the all-reduce, the all-gather)
    runs over that group, so on a mesh with other axes above 1 the ranks
    of one dp coordinate hold equal slices. Returns (new carry, mean loss
    over the dp ranks, new RNN carries)."""
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten

    conf = net.conf

    def step(carry, inputs, labels, lmasks, scalars, fmasks=None,
             rnn_carries=None):
        params, upd, states = carry
        group = manager.group
        world, rank = group.world, group.rank
        gtree, loss, new_states, new_rnn = net._grads(
            params, states, inputs, labels, lmasks, fmasks, rnn_carries,
            dp=group)
        with torch.no_grad():
            pl = leaves(params)
            grads = _aligned(params, gtree)
            sharded = [i for i, g in enumerate(grads) if g is not None
                       and zero1_leaf_sharded(g.shape, world)]
            repl = [i for i, g in enumerate(grads) if g is not None
                    and i not in sharded]
            if sharded or repl:
                grads, loss = _reduce_grads(conf, params, grads, sharded,
                                            repl, loss, group)
            mine = list(pl)
            for i in sharded:
                lo, hi = slice_bounds(pl[i].shape[0], rank, world)
                mine[i] = pl[i][lo:hi]
            new_sl, new_u = net._apply_updates(
                unflatten(params, mine)[0], upd,
                unflatten(params, grads)[0], scalars[0], scalars[1])
            out = list(leaves(new_sl))
            if sharded:
                full = C.all_gather(torch.cat(
                    [out[i].reshape(-1) for i in sharded]),
                    group).view(world, -1)
                for i, p in zip(sharded, torch.split(
                        full, [out[i].numel() for i in sharded], dim=1)):
                    out[i] = p.reshape(pl[i].shape)
        return ((unflatten(params, out)[0], new_u, new_states),
                loss, tree_map(lambda t: t.detach(), new_rnn))

    return step


def k_steps(step, carry, inputs, labels, lmasks, scalars, fmasks, k):
    """`k` calls of `step` (the net's `_step` signature) over the first k
    entries of the [k', ...]-stacked inputs and [k', 2] scalars. Returns
    (carry, [k] losses): the body of every k-step group, sharded
    (`build_zero1_group`) or not (`StepProgram.run_group`)."""
    from deeplearning4j_tpu_torch.util.tree import tree_map

    losses = []
    for i in range(k):
        at = lambda ts: tree_map(lambda t: t[i], ts)
        carry, loss, _ = step(carry, at(inputs), at(labels), at(lmasks),
                              scalars[i], at(fmasks))
        losses.append(loss)
    return carry, torch.stack(losses)


def build_zero1_group(net, manager, k: int, trace_key=None):
    """The k-step grouping of the ZeRO-1 step (JAX's `lax.scan` group):
    `group(carry, inputs, labels, lmasks, scalars, fmasks=None,
    steps=None)` runs `steps` (default k) ZeRO-1 steps over the
    [k, ...]-stacked inputs and the [k, 2] per-step (lr, step) scalars,
    the updater state carried sharded, and returns (carry, [steps]
    losses) — what k sequential `build_zero1_step` calls give, bit for
    bit. `trace_key`, when given, is recorded in the net's JitCache once
    per build (the JAX package records one trace per group program)."""
    step = build_zero1_step(net, manager)
    if trace_key is not None:
        net._jit_cache.record_trace(trace_key)

    def group(carry, inputs, labels, lmasks, scalars, fmasks=None,
              steps=None):
        return k_steps(step, carry, inputs, labels, lmasks, scalars, fmasks,
                       k if steps is None else steps)

    return group


__all__ = ["ZERO1_AXIS", "zero1_leaf_sharded", "slice_bounds",
           "slice_rows", "assemble_rows", "reslice",
           "build_zero1_step", "build_zero1_group", "k_steps"]
