"""KV-aware causal self-attention primitives over a PAGED cache
(counterpart of deeplearning4j_tpu/nn/attention.py).

The decode-serving path needs a transformer forward in TWO shapes over
ONE set of weights:

  chunk prefill   one page_size-aligned slice [T, d_model] of a prompt
             processed in parallel: causal within the chunk, attending
             to the PRIOR context through gathered page cells, emitting
             the chunk's K/V so the caller parks them in a physical
             page.
  decode     ONE new position per slot, batched over the engine's
             [max_slots] axis, attending against page cells GATHERED
             in logical token order — the per-cell (page, offset)
             indirection that makes the cache a virtual address space.

Both build from the same per-layer parameter dict (see
zoo/decoder.CausalTransformer); engine/decode_program.py owns where K/V
land in the page pool.

Layout: head_dim innermost everywhere, gathered cells HEAD-MAJOR
[..., n_heads, cells, head_dim], so both cache contractions are batched
matrix products over leading (slot, head) dims.

Bitwise discipline: attention is commutative but NOT associative over
keys, so the engine and the sequential oracle must present identical
operand values in an identical reduction order. Cells arrive in
LOGICAL token order, and dead cells are zeroed BEFORE the score
contraction (not just masked after): a dead cell points at the shared
scratch page, whose bytes other slots scribble, and 0·garbage is the
only value that can never leak — exp(MASK_VALUE - max) underflows the
weight to exactly 0.0, and the zeroed value keeps 0·NaN out of the
weighted sum. Every reduction is per row (per slot, per head), so a
row's result never depends on the other rows of the batch.

Everything here is plain PyTorch in f32 on device tensors — no host
syncs, no `.item()`, no Python branching on data.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# large finite "masked" score: exp(x - max) underflows to exactly 0.0
# for masked lanes while never producing inf/NaN arithmetic
MASK_VALUE = -1e30


def layer_norm(x, gain, bias, eps: float = 1e-5):
    """LayerNorm over the trailing (feature) axis, written as the JAX
    package's formula (mean, mean of squared deviations, divide by the
    root)."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * gain + bias


def qkv_heads(lp: dict, x, n_heads: int):
    """Project hidden states to per-head q/k/v: [..., d_model] ->
    three [..., n_heads, head_dim] tensors (head_dim innermost)."""
    def split(w):
        y = x @ w
        return y.reshape(y.shape[:-1] + (n_heads, -1))

    return split(lp["wq"]), split(lp["wk"]), split(lp["wv"])


def _scale(q) -> float:
    return 1.0 / math.sqrt(q.shape[-1])


def paged_decode_attention(q, k_cells, v_cells, live):
    """Single-position attention against GATHERED page cells (the
    DECODE shape): `q` is [S, n_heads, head_dim], `k_cells`/`v_cells`
    are HEAD-MAJOR [S, n_heads, cells, head_dim] in LOGICAL token order
    with the new position's K/V already written at cell live[s]-1.
    `live` ([S] int tensor on q's device) counts each slot's readable
    cells; cells beyond it are zeroed before the score contraction.
    Returns [S, n_heads, head_dim]."""
    c = k_cells.shape[2]
    mask = (torch.arange(c, device=q.device)[None, :]
            < live[:, None])                                # [S, C]
    m4 = mask[:, None, :, None]
    k_cells = torch.where(m4, k_cells, 0.0)
    v_cells = torch.where(m4, v_cells, 0.0)
    # "shd,shcd->shc" as a batched product over (slot, head)
    scores = torch.matmul(k_cells, q.unsqueeze(-1)).squeeze(-1) * _scale(q)
    scores = torch.where(mask[:, None, :], scores, MASK_VALUE)
    w = _softmax(scores)
    # "shc,shcd->shd"
    return torch.matmul(w.unsqueeze(-2), v_cells).squeeze(-2)


def chunk_prefill_attention(q, k, v, k_cells, v_cells, n_prior: int):
    """One prompt chunk attending jointly to its PRIOR context and to
    itself (the CHUNK-PREFILL shape): `q`/`k`/`v` are [T, n_heads,
    head_dim] for chunk positions n_prior..n_prior+T-1; `k_cells`/
    `v_cells` are HEAD-MAJOR [n_heads, cells, head_dim] — positions
    0..n_prior-1 gathered in logical order (cells >= n_prior are
    scratch: zeroed + masked). ONE softmax spans [prior cells ; chunk]
    so the reduction order is fixed however the prior pages were
    produced. Returns [T, n_heads, head_dim]."""
    t = q.shape[0]
    c = k_cells.shape[1]
    scale = _scale(q)
    prior = torch.arange(c, device=q.device) < n_prior        # [C]
    m3 = prior[None, :, None]
    k_cells = torch.where(m3, k_cells, 0.0)
    v_cells = torch.where(m3, v_cells, 0.0)
    qh = q.transpose(0, 1)                                     # [H, T, D]
    # "thd,hcd->htc"
    sp = torch.matmul(qh, k_cells.transpose(1, 2)) * scale     # [H, T, C]
    sp = torch.where(prior[None, None, :], sp, MASK_VALUE)
    # "thd,uhd->htu"
    si = torch.matmul(qh, k.permute(1, 2, 0)) * scale          # [H, T, T]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=q.device))
    si = torch.where(causal[None, :, :], si, MASK_VALUE)
    w = _softmax(torch.cat([sp, si], dim=-1))
    # "htc,hcd->thd" + "htu,uhd->thd"
    out = (torch.matmul(w[..., :c], v_cells)
           + torch.matmul(w[..., c:], v.transpose(0, 1)))      # [H, T, D]
    return out.transpose(0, 1)


def _softmax(scores):
    """The explicit softmax: max, exp, sum, divide (F.softmax would
    fuse the same steps with its own rounding)."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def mlp_block(lp: dict, x):
    """The position-wise feed-forward half of a decoder block (GELU,
    tanh approximation as the JAX package's `approximate=True`)."""
    h = F.gelu(x @ lp["w1"] + lp["b1"], approximate="tanh")
    return h @ lp["w2"] + lp["b2"]


def block_chunk_prefill(lp: dict, x, n_heads: int, k_cells, v_cells,
                        n_prior: int, qkv=None):
    """One decoder block over a prompt CHUNK: x [T, d_model] -> x'.
    The chunk's q/k/v are the pre-attention projections of the ln1
    stream — exactly what the decode shape recomputes per position.
    The caller usually passes `qkv` precomputed via `decode_qkv` (it
    parks k/v into a physical page BEFORE attention — scatter, then
    gather); `k_cells`/`v_cells`/`n_prior` carry the prior context."""
    if qkv is None:
        h = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        qkv = qkv_heads(lp, h, n_heads)
    q, k, v = qkv
    att = chunk_prefill_attention(q, k, v, k_cells, v_cells, n_prior)
    x = x + _merge_heads(att) @ lp["wo"]
    x = x + mlp_block(lp, layer_norm(x, lp["ln2_g"], lp["ln2_b"]))
    return x


def decode_qkv(lp: dict, x, n_heads: int):
    """First half of a decode-shape block: the current position's
    q/k/v projections off the ln1 stream. The caller writes k/v into
    the slot's write cell BEFORE calling `block_decode_finish` (the
    position must attend to itself)."""
    h = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    return qkv_heads(lp, h, n_heads)


def block_decode_finish(lp: dict, x, q, k_cells, v_cells, live):
    """Second half of a decode-shape block: attend `q` [S, H, Dh]
    against the gathered window cells [S, H, cells, Dh] and run the
    residual + feed-forward tail. Returns x' [S, d_model]."""
    att = paged_decode_attention(q, k_cells, v_cells, live)
    x = x + _merge_heads(att) @ lp["wo"]
    x = x + mlp_block(lp, layer_norm(x, lp["ln2_g"], lp["ln2_b"]))
    return x


def _merge_heads(att):
    return att.reshape(att.shape[:-2] + (-1,))


def lm_logits(x, tok_emb):
    """Tied LM head: [..., d_model] x [vocab, d_model] -> [..., vocab],
    contracting d_model against the embedding's rows (no transposed
    copy of the table)."""
    return torch.matmul(x, tok_emb.t())
