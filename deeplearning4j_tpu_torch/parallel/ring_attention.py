"""Ring attention: sequence-parallel exact attention over the `sp` mesh
axis (counterpart of deeplearning4j_tpu/parallel/ring_attention.py).

The sequence axis is sharded over `sp`: each rank holds its Q/K/V block,
and the K/V blocks rotate around the ring (`collectives.ppermute`, one
hop per step) while each rank folds the incoming block into a
numerically-stable online softmax (the blockwise/flash formulation).
Peak memory per rank is O(T_local^2) instead of O(T^2). The arithmetic is
the JAX package's: f32 scores and accumulators, causal masks from global
positions (after t hops a rank holds the block that originated at
coordinate (my - t) mod n), `isfinite` guards for fully masked rows, no
rotation after the last fold, the output cast back to q's dtype.

Entry points:
- ring_self_attention(q, k, v, mesh, ...): global [B, T, H, D] tensors
  (T divisible by sp) on every rank; each rank takes its block by its sp
  coordinate, runs the ring, and all-gathers the output, so every rank
  returns the global [B, T, H, D].
- _ring_attention_block: the per-rank body on local [B, Tl, H, D]
  blocks, usable inside a larger sequence-parallel step.

The computation is plain PyTorch (matmuls, exp, max) with the hops over
torch.distributed: the JAX package computes it with `jnp.einsum` inside
`shard_map`, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel import collectives


def _ring_attention_block(q, k, v, *, axis_name, causal: bool,
                          scale: float):
    """Per-rank ring attention. q/k/v: [B, Tl, H, D] local blocks;
    `axis_name` the ring's collectives.AxisGroup (`mesh.group("sp")`: one
    process per device has no axis names outside a mesh). K/V rotate
    coordinate i -> (i + 1) % n each step, so after t steps coordinate i
    holds the block that originated at (i - t) mod n."""
    group = axis_name
    n, my = group.world, group.rank
    B, Tl, H, D = q.shape
    q_ = q.transpose(1, 2).float()                  # [B, H, Tq, D]
    neg = torch.finfo(torch.float32).min
    dev = q.device
    m = torch.full((B, H, Tl), neg, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])                         # one hop moves both
    ar = torch.arange(Tl, device=dev)
    for t in range(n):
        origin = (my - t) % n                        # where this K/V began
        k_ = kv[0].transpose(1, 2).float()           # [B, H, Tk, D]
        v_ = kv[1].transpose(1, 2).float()
        s = torch.matmul(q_, k_.transpose(-1, -2)) * scale
        if causal:
            q_pos = my * Tl + ar                     # global q indices
            k_pos = origin * Tl + ar                 # global k indices
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
            s = torch.where(mask, s, torch.full_like(s, neg))
        m_blk = s.amax(dim=-1)                       # [B, H, Tq]
        m_new = torch.maximum(m, m_blk)
        # fully-masked rows keep m = -inf; guard the exp shift
        shift = torch.where(torch.isfinite(m_new), m_new,
                            torch.zeros_like(m_new))
        p = torch.exp(s - shift[..., None])
        if causal:
            p = torch.where(mask, p, torch.zeros_like(p))
        corr = torch.where(torch.isfinite(m), torch.exp(m - shift),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.matmul(p, v_)
        m = m_new
        if t < n - 1:                                # no hop after the last
            kv = collectives.ppermute(kv, group, shift=1)
    out = o / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)           # [B, Tq, H, D]


def ring_self_attention(q, k, v, mesh, *, axis_name: str = "sp",
                        causal: bool = False,
                        scale: Optional[float] = None):
    """Exact multi-head attention with the sequence dim sharded over
    `axis_name`. q/k/v: the global [B, T, H, D] tensors, the same on every
    rank, with T % mesh.shape[axis_name] == 0. Matches dense
    softmax(QK^T/sqrt(D))V to float32 accuracy; every rank returns the
    global output."""
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no axis '{axis_name}' "
                         f"(axes: {dict(mesh.shape)})")
    n = mesh.shape[axis_name]
    B, T, H, D = q.shape
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by "
                         f"{axis_name}={n}")
    if scale is None:
        scale = 1.0 / float(math.sqrt(D))
    group = mesh.group(axis_name)
    tl = T // n
    lo = group.rank * tl
    block = lambda a: a[:, lo:lo + tl].contiguous()
    out = _ring_attention_block(block(q), block(k), block(v),
                                axis_name=group, causal=causal, scale=scale)
    if n == 1:
        return out
    full = collectives.all_gather(out.reshape(-1), group)
    return full.view(n, B, tl, H, D).permute(1, 0, 2, 3, 4).reshape(
        B, T, H, D)


__all__ = ["ring_self_attention"]
