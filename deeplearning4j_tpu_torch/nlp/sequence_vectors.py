"""SequenceVectors: the generic embedding trainer (counterpart of
deeplearning4j_tpu/nlp/sequence_vectors.py; parity:
models/sequencevectors/SequenceVectors.java — buildVocab :103,207,
fit :187, worker loop :289; elements-learning algorithms SkipGram.java:31
(iterateSample :224, HS :238, negative sampling :258) and CBOW.java).

The tables live on the device (CUDA unless the caller passes
device="cpu") and train by batched gathers and scatter-adds, in one of
the JAX package's two tiers:

- scan tier (small vocab, default < 2048): the JAX package's `lax.scan`
  over small chunks is a loop over chunks here; each chunk sees the
  tables the chunk before it left (the reference's per-pair SGD,
  approximated), so in-batch duplicate updates do not collapse tiny
  vocabularies.
- dense tier (large vocab / mode='dense'): the native single-pass epoch
  builder (native/dl4j_tpu_native.cpp, the AggregateSkipGram role) packs
  [center, positive, K alias-sampled negatives] rows in corpus order on a
  packer thread; each slab of batches ships to the device once and trains
  batch by batch: gather -> elementwise -> capped scatter-add.

Every `.at[idx].add(...)` of the JAX package is an `index_add_` here: it
sums duplicate indices, as JAX does (`t[idx] += x` would keep one of
them). On the CPU the sum runs in index order, so a run repeats bit for
bit; on CUDA it uses float atomics, and two runs may differ in the last
bits. Tables are updated in place (the JAX steps donate theirs), and
every array handed to or taken from a caller is a copy.

The host side — vocab, Huffman codes, pairs, subsampling, the packs, the
alias tables, every random draw and its order — is the JAX package's
code, so the packs and the initial tables equal the JAX package's bit for
bit from the same seed.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache, build_huffman

_EPS = 1e-7


def _host(t: torch.Tensor) -> np.ndarray:
    """A read-only host copy of a device table (the JAX package's
    `np.asarray` of a device array is read-only too): training the
    table in place later never reaches an array a caller holds."""
    a = t.detach().to("cpu", copy=True).numpy()
    a.flags.writeable = False
    return a


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A device copy of a host array (never a view of it on the CPU)."""
    return torch.tensor(np.asarray(a), device=dev)


def _idx(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=dev)


def _chunk_of(batch: int, chunk: int) -> int:
    """Largest divisor of `batch` that is <= chunk (equal chunks, as the
    JAX package's scan needs)."""
    c = min(chunk, batch)
    while batch % c:
        c -= 1
    return max(c, 1)


def _bk_bkd(g, u):
    """einsum('bk,bkd->bd')."""
    return torch.bmm(g.unsqueeze(1), u).squeeze(1)


def _bd_bkd(v, u):
    """einsum('bd,bkd->bk')."""
    return torch.bmm(u, v.unsqueeze(2)).squeeze(2)


def _ns_loss(lab, p):
    """The chunks' mean negative-sampling loss; p, lab [S, c, K+1]."""
    ll = lab * torch.log(p + _EPS) + (1 - lab) * torch.log(1 - p + _EPS)
    return (-ll.mean(dim=(1, 2))).mean()


def _hs_loss(cds, p, msk):
    """The chunks' mean hierarchical-softmax loss; [S, c, L] each."""
    tgt = 1.0 - cds
    ll = tgt * torch.log(p + _EPS) + (1 - tgt) * torch.log(1 - p + _EPS)
    per = -(ll * msk).sum(dim=(1, 2)) / msk.sum(dim=(1, 2)).clamp_min(1.0)
    return per.mean()


class _NegSamplingStep:
    """Skip-gram negative-sampling update, chunk by chunk (JAX
    `_NegSamplingStep`). The reference applies per-pair SGD one pair at
    a time (SkipGram.java:258-272); summing a whole batch computed at the
    same stale tables multiplies the effective lr of in-batch duplicates.
    Updates inside a chunk are batched; chunks see each other's fresh
    values. syn0 and syn1neg are updated in place and returned with the
    mean loss."""

    def __init__(self, chunk: int = 32):
        self.chunk = chunk

    def __call__(self, syn0, syn1neg, center, ctx, labels, lr):
        B, K1 = ctx.shape
        D = syn0.shape[1]
        c = _chunk_of(B, self.chunk)
        ps = []
        for s in range(0, B, c):
            cen, cx, lab = center[s:s + c], ctx[s:s + c], labels[s:s + c]
            v = syn0[cen]                           # [c,D]
            u = syn1neg[cx]                         # [c,K+1,D]
            p = torch.sigmoid(_bd_bkd(v, u))
            g = (lab - p) * lr                      # [c,K+1]
            dv = _bk_bkd(g, u)
            du = g[:, :, None] * v[:, None, :]
            syn0.index_add_(0, cen, dv)
            syn1neg.index_add_(0, cx.reshape(-1), du.reshape(-1, D))
            ps.append(p)
        S = B // c
        loss = _ns_loss(labels.reshape(S, c, K1),
                        torch.stack(ps))
        return syn0, syn1neg, loss


class _HierarchicSoftmaxStep:
    """Skip-gram hierarchical-softmax update (SkipGram.java:238; JAX
    `_HierarchicSoftmaxStep`), chunk by chunk as _NegSamplingStep."""

    def __init__(self, chunk: int = 32):
        self.chunk = chunk

    def __call__(self, syn0, syn1, center, points, codes, mask, lr):
        B, L = points.shape
        D = syn0.shape[1]
        c = _chunk_of(B, self.chunk)
        ps = []
        for s in range(0, B, c):
            cen, pts = center[s:s + c], points[s:s + c]
            cds, msk = codes[s:s + c], mask[s:s + c]
            v = syn0[cen]                           # [c,D]
            u = syn1[pts]                           # [c,L,D]
            p = torch.sigmoid(_bd_bkd(v, u))
            # target: 1 - code
            g = ((1.0 - cds) - p) * msk * lr
            dv = _bk_bkd(g, u)
            du = g[:, :, None] * v[:, None, :]
            syn0.index_add_(0, cen, dv)
            syn1.index_add_(0, pts.reshape(-1), du.reshape(-1, D))
            ps.append(p)
        S = B // c
        loss = _hs_loss(codes.reshape(S, c, L), torch.stack(ps),
                        mask.reshape(S, c, L))
        return syn0, syn1, loss


def _context_mean(syn0, cw, cm):
    """Masked mean of the context vectors: [B,W] words and mask -> [B,D]
    (JAX: einsum('bwd,bw->bd') / counts)."""
    counts = cm.sum(dim=1).clamp_min(1.0)
    return _bk_bkd(cm, syn0[cw]) / counts[:, None]


class _CbowNegSamplingStep:
    """CBOW negative-sampling update (ref CBOW.java + word2vec.c
    cbow-mean; JAX `_CbowNegSamplingStep`): input = masked mean of the
    context vectors, targets = center + negatives; the input gradient
    reaches every context word unscaled, as in the reference. Chunk by
    chunk as the skip-gram steps."""

    def __init__(self, chunk: int = 32):
        self.chunk = chunk

    def __call__(self, syn0, syn1neg, ctx_words, ctx_mask, targets,
                 labels, lr):
        B, W = ctx_words.shape
        K1 = targets.shape[1]
        D = syn0.shape[1]
        c = _chunk_of(B, self.chunk)
        ps = []
        for s in range(0, B, c):
            cw, cm = ctx_words[s:s + c], ctx_mask[s:s + c]
            tgt, lab = targets[s:s + c], labels[s:s + c]
            h = _context_mean(syn0, cw, cm)             # [c,D]
            u = syn1neg[tgt]                            # [c,K+1,D]
            p = torch.sigmoid(_bd_bkd(h, u))
            g = (lab - p) * lr
            du = g[:, :, None] * h[:, None, :]
            dh = _bk_bkd(g, u)
            syn1neg.index_add_(0, tgt.reshape(-1), du.reshape(-1, D))
            dctx = dh[:, None, :] * cm[:, :, None]      # [c,W,D]
            syn0.index_add_(0, cw.reshape(-1), dctx.reshape(-1, D))
            ps.append(p)
        S = B // c
        loss = _ns_loss(labels.reshape(S, c, K1), torch.stack(ps))
        return syn0, syn1neg, loss


class _CbowHierarchicSoftmaxStep:
    """CBOW hierarchical-softmax update (ref CBOW.java HS branch; JAX
    `_CbowHierarchicSoftmaxStep`): the context mean against the CENTER
    word's Huffman path."""

    def __init__(self, chunk: int = 32):
        self.chunk = chunk

    def __call__(self, syn0, syn1, ctx_words, ctx_mask, points, codes,
                 mask, lr):
        B, W = ctx_words.shape
        L = points.shape[1]
        D = syn0.shape[1]
        c = _chunk_of(B, self.chunk)
        ps = []
        for s in range(0, B, c):
            cw, cm = ctx_words[s:s + c], ctx_mask[s:s + c]
            pts, cds = points[s:s + c], codes[s:s + c]
            msk = mask[s:s + c]
            h = _context_mean(syn0, cw, cm)
            u = syn1[pts]                               # [c,L,D]
            p = torch.sigmoid(_bd_bkd(h, u))
            g = ((1.0 - cds) - p) * msk * lr
            du = g[:, :, None] * h[:, None, :]
            dh = _bk_bkd(g, u)
            syn1.index_add_(0, pts.reshape(-1), du.reshape(-1, D))
            dctx = dh[:, None, :] * cm[:, :, None]
            syn0.index_add_(0, cw.reshape(-1), dctx.reshape(-1, D))
            ps.append(p)
        S = B // c
        loss = _hs_loss(codes.reshape(S, c, L), torch.stack(ps),
                        mask.reshape(S, c, L))
        return syn0, syn1, loss


_DUP_CAP = 8.0


def _dedup_scatter_add(table, idx_flat, rows):
    """table[idx] += capped-sum-of-duplicates(rows), in place: rows with
    up to _DUP_CAP in-batch occurrences apply their full summed gradient
    (approximating the sequential hogwild's total movement); beyond that
    the sum is rescaled to the cap. A plain summed scatter multiplies the
    head word's effective lr by its duplicate count — under a zipf
    vocabulary that is thousands per batch and the table NaNs within an
    epoch; a plain mean starves moderate-frequency words.

    The JAX package sums into a zeroed copy of the table and adds it
    scaled; the scale depends on the row's index only, so here each
    row is scaled first and summed straight into the table: the same
    update, with touched rows only (no pass over the whole table)."""
    counts = torch.zeros(table.shape[0], dtype=rows.dtype,
                         device=rows.device)
    counts.index_add_(0, idx_flat, torch.ones_like(idx_flat,
                                                   dtype=rows.dtype))
    scale = _DUP_CAP / counts.clamp_min(_DUP_CAP)
    table.index_add_(0, idx_flat, rows * scale[idx_flat][:, None])
    return table


class _DenseSteps:
    """Dense batched updates for large vocabularies (the role of the
    reference's native AggregateSkipGram op behind SkipGram.java:224's
    hot loop; JAX `_DenseSteps`).

    - One batched update per batch of B pairs; in-batch duplicate rows
      apply a CAPPED SUM of their gradients (_dedup_scatter_add).
    - Negative sampling happens on the host (the native single-pass alias
      builder, native/dl4j_tpu_native.cpp dl4j_w2v_sg_pack).
    - A whole SLAB of batches ships as one [nb, B, cols] upload, widened
      to int64 on the device once; its per-batch lrs ship once as one
      f32 tensor. The JAX package's `lax.scan` over the slab is a loop
      over its batches here.
    - Negatives that collide with the row's positive have their gradient
      masked on the device (no contradictory label on one index).
    - The tables are updated in place and stay on the device until the
      lazy table properties are read.
    - A batch whose lr is 0 (the epoch tail's padding) changes nothing,
      so the slab loop skips it: `live` lists the batches to run.
    """

    @staticmethod
    def _ns_grad(tgt, p, lr):
        """(lab - p) * lr with lab = [1, 0, ..., 0], zeroed where a
        negative equals the row's positive."""
        lab = torch.zeros_like(p)
        lab[:, 0] = 1.0
        g = (lab - p) * lr
        g[:, 1:].masked_fill_(tgt[:, 1:] == tgt[:, :1], 0.0)
        return g

    @staticmethod
    def _sg_ns_body(syn0, syn1neg, pack, lr):
        """pack [B, K+2] int64: col 0 center, col 1 positive, rest
        negatives."""
        cen = pack[:, 0]
        tgt = pack[:, 1:]
        D = syn0.shape[1]
        v = syn0[cen]                        # [B,D]
        u = syn1neg[tgt]                     # [B,K+1,D]
        p = torch.sigmoid(_bd_bkd(v, u))
        g = _DenseSteps._ns_grad(tgt, p, lr)
        dv = _bk_bkd(g, u)
        du = (g[:, :, None] * v[:, None, :]).reshape(-1, D)
        _dedup_scatter_add(syn0, cen, dv)
        _dedup_scatter_add(syn1neg, tgt.reshape(-1), du)
        return syn0, syn1neg

    @staticmethod
    def _sg_hs_body(syn0, syn1, pts_tab, tgt_tab, msk_tab, pack, lr):
        """pack [B, 2] int64: col 0 center, col 1 positive. tgt_tab is
        1 - codes (the JAX package's `1.0 - cds`, gathered after)."""
        cen, pos = pack[:, 0], pack[:, 1]
        D = syn0.shape[1]
        pts, tgt, msk = pts_tab[pos], tgt_tab[pos], msk_tab[pos]
        v = syn0[cen]                        # [B,D]
        u = syn1[pts]                        # [B,L,D]
        p = torch.sigmoid(_bd_bkd(v, u))
        g = (tgt - p) * msk * lr
        dv = _bk_bkd(g, u)
        du = (g[:, :, None] * v[:, None, :]).reshape(-1, D)
        _dedup_scatter_add(syn0, cen, dv)
        _dedup_scatter_add(syn1, pts.reshape(-1), du)
        return syn0, syn1

    @staticmethod
    def _context(syn0, pack, W):
        """CBOW's context: -1 empty slots read row 0 under a zero mask
        (never an out-of-range index). -> (cw, cm, h)."""
        cw_raw = pack[:, :W]
        cm = (cw_raw >= 0).to(syn0.dtype)
        cw = cw_raw.clamp_min(0)
        return cw, cm, _context_mean(syn0, cw, cm)

    @staticmethod
    def _cbow_ns_body(syn0, syn1neg, pack, W, lr):
        """pack [B, W+K+1] int64: cols 0..W-1 context (-1 = empty
        slot), col W center/positive, rest negatives."""
        D = syn0.shape[1]
        cw, cm, h = _DenseSteps._context(syn0, pack, W)
        tgt = pack[:, W:]
        u = syn1neg[tgt]                     # [B,K+1,D]
        p = torch.sigmoid(_bd_bkd(h, u))
        g = _DenseSteps._ns_grad(tgt, p, lr)
        du = (g[:, :, None] * h[:, None, :]).reshape(-1, D)
        dh = _bk_bkd(g, u)
        _dedup_scatter_add(syn1neg, tgt.reshape(-1), du)
        dctx = dh[:, None, :] * cm[:, :, None]
        _dedup_scatter_add(syn0, cw.reshape(-1), dctx.reshape(-1, D))
        return syn0, syn1neg

    @staticmethod
    def _cbow_hs_body(syn0, syn1, pts_tab, tgt_tab, msk_tab, pack, W,
                      lr):
        """pack [B, W+1] int64: cols 0..W-1 context (-1 = empty), col W
        center."""
        D = syn0.shape[1]
        cw, cm, h = _DenseSteps._context(syn0, pack, W)
        cen = pack[:, W]
        pts, tgt, msk = pts_tab[cen], tgt_tab[cen], msk_tab[cen]
        u = syn1[pts]                        # [B,L,D]
        p = torch.sigmoid(_bd_bkd(h, u))
        g = (tgt - p) * msk * lr
        du = (g[:, :, None] * h[:, None, :]).reshape(-1, D)
        dh = _bk_bkd(g, u)
        _dedup_scatter_add(syn1, pts.reshape(-1), du)
        dctx = dh[:, None, :] * cm[:, :, None]
        _dedup_scatter_add(syn0, cw.reshape(-1), dctx.reshape(-1, D))
        return syn0, syn1

    # --------------------------------------------------- slab dispatch
    @staticmethod
    def _batches(packs, live):
        return range(packs.shape[0]) if live is None else live

    def sg_ns(self, syn0, syn1neg, packs, lrs, live=None):
        """packs [nb, B, K+2] int64, lrs [nb] f32, both on the tables'
        device: trains the slab batch by batch, in place."""
        for i in self._batches(packs, live):
            self._sg_ns_body(syn0, syn1neg, packs[i], lrs[i])
        return syn0, syn1neg

    def sg_hs(self, syn0, syn1, pts_tab, tgt_tab, msk_tab, packs, lrs,
              live=None):
        for i in self._batches(packs, live):
            self._sg_hs_body(syn0, syn1, pts_tab, tgt_tab, msk_tab,
                             packs[i], lrs[i])
        return syn0, syn1

    def cbow_ns(self, syn0, syn1neg, packs, W, lrs, live=None):
        for i in self._batches(packs, live):
            self._cbow_ns_body(syn0, syn1neg, packs[i], W, lrs[i])
        return syn0, syn1neg

    def cbow_hs(self, syn0, syn1, pts_tab, tgt_tab, msk_tab, packs, W,
                lrs, live=None):
        for i in self._batches(packs, live):
            self._cbow_hs_body(syn0, syn1, pts_tab, tgt_tab, msk_tab,
                               packs[i], W, lrs[i])
        return syn0, syn1


class SequenceVectors:
    """Generic embedding trainer over token sequences.

    The syn0/syn1/syn1neg tables are lazily fetched properties: after a
    dense fit they stay on the device and materialize to a read-only
    NumPy copy only when read — queries and serialization trigger one
    transfer. `device` (None: CUDA) is resolved when a fit starts.
    """

    @staticmethod
    def _lazy(host, dev):
        if host is None and dev is not None:
            host = _host(dev)
        return host

    @property
    def syn0(self):
        self._syn0_host = self._lazy(self._syn0_host, self._syn0_dev)
        return self._syn0_host

    @syn0.setter
    def syn0(self, v):
        self._syn0_host, self._syn0_dev = v, None

    @property
    def syn1(self):
        self._syn1_host = self._lazy(self._syn1_host, self._syn1_dev)
        return self._syn1_host

    @syn1.setter
    def syn1(self, v):
        self._syn1_host, self._syn1_dev = v, None

    @property
    def syn1neg(self):
        self._syn1neg_host = self._lazy(self._syn1neg_host,
                                        self._syn1neg_dev)
        return self._syn1neg_host

    @syn1neg.setter
    def syn1neg(self, v):
        self._syn1neg_host, self._syn1neg_dev = v, None

    def __init__(self, layer_size: int = 100, window: int = 5,
                 negative: int = 5, use_hierarchic_softmax: bool = False,
                 min_word_frequency: int = 1, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, epochs: int = 1,
                 batch_size: int = 512, sampling: float = 0.0,
                 use_cbow: bool = False, seed: int = 42,
                 chunk: Optional[int] = None,
                 mode: Optional[str] = None,
                 dense_batch_size: int = 16384,
                 device=None):
        self.layer_size = layer_size
        self.window = window
        self.negative = negative
        self.use_hs = use_hierarchic_softmax or negative <= 0
        self.min_word_frequency = min_word_frequency
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.sampling = sampling
        self.use_cbow = use_cbow
        self.seed = seed
        self.device = device

        self.vocab = AbstractCache(min_word_frequency)
        self.syn0 = None
        self.syn1 = None      # HS inner nodes
        self.syn1neg = None
        self._unigram: Optional[np.ndarray] = None
        self._max_code_len = 0
        # One chunk constant shared by all steps; batch_size is rounded
        # up to a chunk multiple so full batches never need padding
        # (padding replicates pairs -> over-trains them). chunk=None
        # (default) resolves at fit() time from the vocab size: tiny
        # vocabularies need small chunks or in-batch duplicate updates
        # collapse embeddings; large ones rarely repeat a word in a chunk.
        self._chunk_param = chunk
        self._raw_batch_size = batch_size
        self._chunk = None
        self.batch_size = batch_size
        self._neg_step = None
        self._hs_step = None
        self._cbow_neg_step = None
        self._cbow_hs_step = None
        # mode: None = auto (dense when the vocab is large enough that
        # in-batch duplicate updates are noise, scan otherwise);
        # 'scan' / 'dense' force a tier. An explicit chunk implies scan.
        if mode not in (None, "scan", "dense"):
            raise ValueError(f"mode must be None|'scan'|'dense': {mode}")
        self._mode = mode
        self.dense_batch_size = int(dense_batch_size)
        self._dense = False
        self._dense_steps = None
        self._hs_tables = None
        # External lr-schedule hooks, as in the JAX package:
        # lr_total_epochs overrides self.epochs in the linear-decay
        # denominator and carries the examples-seen count (_lr_seen)
        # across fit() calls; _fit_rng, when set, persists the
        # shuffle/negative-sampling stream across fit() calls.
        self.lr_total_epochs = 0
        self._lr_seen = 0
        self._fit_rng = None

    def _ensure_steps(self):
        if self._neg_step is not None or self._dense_steps is not None:
            return
        V = self.vocab.num_words()
        if self._mode == "dense":
            self._dense = True
        elif self._mode == "scan" or self._chunk_param is not None:
            self._dense = False
        else:
            self._dense = V >= 2048
        if self._dense:
            self._dense_steps = _DenseSteps()
            return
        if self._chunk_param is not None:
            self._chunk = int(self._chunk_param)
        else:
            self._chunk = 32 if V < 2048 else 512
        self.batch_size = (-(-self._raw_batch_size // self._chunk)
                           * self._chunk)
        self._neg_step = _NegSamplingStep(chunk=self._chunk)
        self._hs_step = _HierarchicSoftmaxStep(chunk=self._chunk)
        self._cbow_neg_step = _CbowNegSamplingStep(chunk=self._chunk)
        self._cbow_hs_step = _CbowHierarchicSoftmaxStep(chunk=self._chunk)

    # ------------------------------------------------------------- vocab
    def build_vocab(self, sequences: Iterable[Sequence[str]]):
        for seq in sequences:
            for tok in seq:
                self.vocab.add_token(tok)
        self.vocab.finalize_vocab()
        self._vocab_tables()
        V = self.vocab.num_words()
        rng = np.random.default_rng(self.seed)
        self.syn0 = ((rng.random((V, self.layer_size)) - 0.5)
                     / self.layer_size).astype(np.float32)
        if self.use_hs:
            self.syn1 = np.zeros((max(V - 1, 1), self.layer_size), np.float32)
        if self.negative > 0:
            self.syn1neg = np.zeros((V, self.layer_size), np.float32)
        return self

    def _vocab_tables(self):
        """What training needs of a finalized vocab besides the weight
        tables: the Huffman codes (HS) and the unigram^0.75 distribution
        (negative sampling)."""
        if self.use_hs:
            self._max_code_len = build_huffman(self.vocab)
        if self.negative > 0:
            counts = self.vocab.counts() ** 0.75
            self._unigram = (counts / counts.sum()).astype(np.float64)
            # inverse-CDF sampling (searchsorted) is O(log V) per draw vs
            # rng.choice(p=...)'s per-call setup
            self._unigram_cdf = np.cumsum(self._unigram)

    def _draw_negatives(self, rng, shape):
        u = rng.random(shape)
        return np.searchsorted(self._unigram_cdf, u).astype(np.int64)

    # ----------------------------------------------------------- pairs
    def _sequence_indices(self, seq, rng):
        idxs = [self.vocab.index_of(t) for t in seq]
        idxs = [i for i in idxs if i >= 0]
        if self.sampling > 0 and self.vocab.total_word_count > 0:
            counts = self.vocab.counts()
            total = counts.sum()
            keep = []
            for i in idxs:
                f = counts[i] / total
                p_keep = min(1.0, (np.sqrt(f / self.sampling) + 1)
                             * self.sampling / f)
                if rng.random() < p_keep:
                    keep.append(i)
            idxs = keep
        return idxs

    def _gen_pairs(self, sequences, rng):
        """Yield (center, context) index pairs with the reference's random
        reduced-window trick."""
        for seq in sequences:
            idxs = self._sequence_indices(seq, rng)
            n = len(idxs)
            for pos, center in enumerate(idxs):
                b = rng.integers(1, self.window + 1)
                for off in range(-b, b + 1):
                    if off == 0:
                        continue
                    j = pos + off
                    if 0 <= j < n:
                        yield center, idxs[j]

    def _gen_cbow_examples(self, sequences, rng):
        """Yield (center, [context indices]) with the reduced-window
        trick — one CBOW example per position (ref CBOW.java)."""
        for seq in sequences:
            idxs = self._sequence_indices(seq, rng)
            n = len(idxs)
            for pos, center in enumerate(idxs):
                b = rng.integers(1, self.window + 1)
                ctx = [idxs[pos + off] for off in range(-b, b + 1)
                       if off != 0 and 0 <= pos + off < n]
                if ctx:
                    yield center, ctx

    # ------------------------------------------------- dense host side
    def _index_corpus(self, seqs) -> List[np.ndarray]:
        """Translate token sequences to vocab-index arrays once (reused
        across epochs; only subsampling/windows are re-drawn)."""
        out = []
        for seq in seqs:
            idxs = [self.vocab.index_of(t) for t in seq]
            arr = np.asarray([i for i in idxs if i >= 0], np.int32)
            if arr.size:
                out.append(arr)
        return out

    def _subsample_flat(self, idx_arrays, rng):
        """Concatenate the corpus with per-sequence ids, applying the
        subsampling keep-test vectorized (same formula as
        _sequence_indices)."""
        arr = np.concatenate(idx_arrays)
        sid = np.concatenate([np.full(a.size, i, np.int32)
                              for i, a in enumerate(idx_arrays)])
        if self.sampling > 0 and self.vocab.total_word_count > 0:
            counts = self.vocab.counts().astype(np.float64)
            f = counts / counts.sum()
            with np.errstate(divide="ignore", invalid="ignore"):
                keep_p = np.minimum(
                    1.0, (np.sqrt(f / self.sampling) + 1)
                    * self.sampling / np.maximum(f, 1e-300))
            m = rng.random(arr.size) < keep_p[arr]
            arr, sid = arr[m], sid[m]
        return arr, sid

    def _context_slots(self, arr, sid, rng, p0, p1):
        """[-1-padded] context-candidate matrix for centers [p0, p1) of
        the full epoch stream: rows see neighbors across the chunk edge
        because `arr`/`sid` are the whole arrays. Shared by both numpy
        fallbacks."""
        n = arr.size
        W2 = 2 * self.window
        p1 = min(p1, n)
        m = p1 - p0
        if m <= 0:
            return np.zeros((0, W2), np.int32), arr[:0]
        b = rng.integers(1, self.window + 1, size=m)
        pos = np.arange(p0, p1)
        cand = np.full((m, W2), -1, np.int32)
        slot = 0
        for off in range(-self.window, self.window + 1):
            if off == 0:
                continue
            j = pos + off
            jc = np.clip(j, 0, n - 1)
            valid = ((j >= 0) & (j < n) & (abs(off) <= b)
                     & (sid[jc] == sid[pos]))
            cand[:, slot] = np.where(valid, arr[jc], -1)
            slot += 1
        return cand, arr[p0:p1]

    def _pairs_from_flat(self, arr, sid, rng, p0=0, p1=None):
        """NumPy fallback for the native sg builder: (center, context)
        skip-gram pairs for centers [p0, p1) with the reduced-window
        trick, one vectorized pass per window offset, in CORPUS ORDER
        (position-major), the order the reference trains in
        (SequenceVectors.java:289)."""
        if p1 is None:
            p1 = arr.size
        cand, centers = self._context_slots(arr, sid, rng, p0, p1)
        if centers.size == 0:
            return (np.zeros(0, np.int32),) * 2
        flat = cand.ravel()
        m = flat >= 0
        c = np.repeat(centers, cand.shape[1])[m]
        x = flat[m]
        return c, x

    def _cbow_from_flat(self, arr, sid, rng, p0=0, p1=None):
        """NumPy fallback for the native cbow builder: one example per
        position [p0, p1) in corpus order, fixed-width [N, 2*window]
        context with -1 marking empty slots."""
        if p1 is None:
            p1 = arr.size
        cw, centers = self._context_slots(arr, sid, rng, p0, p1)
        keep = (cw >= 0).any(axis=1)
        return cw[keep], centers[keep]

    def _hs_device_tables(self):
        """[V, L] Huffman (points, codes, mask) host tables for the
        device-side gather (built once; the scan tier packs per batch on
        the host)."""
        if self._hs_tables is None:
            V = self.vocab.num_words()
            L = max(self._max_code_len, 1)
            words = self.vocab.vocab_words()
            pts = np.zeros((V, L), np.int32)
            cds = np.zeros((V, L), np.float32)
            msk = np.zeros((V, L), np.float32)
            for i in range(V):
                w = words[i]
                l = len(w.codes)
                pts[i, :l] = w.points
                cds[i, :l] = w.codes
                msk[i, :l] = 1.0
            self._hs_tables = (pts, cds, msk)
        return self._hs_tables

    def _hs_tabs_on(self, dev):
        """The dense HS bodies' tables on `dev`: points (int64), 1 - codes
        (the JAX package's `1.0 - cds`, gathered after) and mask."""
        pts, cds, msk = self._hs_device_tables()
        return _idx(pts, dev), _upload(1.0 - cds, dev), _upload(msk, dev)

    def _alias_tables(self):
        """Vose alias tables for the unigram^0.75 negative distribution
        (two uniform draws + two table lookups per negative, vectorized
        on the host)."""
        if getattr(self, "_alias", None) is None:
            p = self._unigram
            V = p.size
            prob = np.zeros(V)
            alias = np.zeros(V, np.int32)
            scaled = (p * V).astype(np.float64).copy()
            small = [i for i in range(V) if scaled[i] < 1.0]
            large = [i for i in range(V) if scaled[i] >= 1.0]
            while small and large:
                s, l = small.pop(), large.pop()
                prob[s] = scaled[s]
                alias[s] = l
                scaled[l] -= 1.0 - scaled[s]
                (small if scaled[l] < 1.0 else large).append(l)
            for i in small + large:
                prob[i] = 1.0
            self._alias = (prob.astype(np.float32), alias)
        return self._alias

    def _host_negatives(self, rng, positives):
        """[B, K+1] targets (positive first) via the alias method.
        Collisions with the positive are masked on the device (see
        _DenseSteps)."""
        B = positives.size
        K = self.negative
        prob, alias = self._alias_tables()
        # one f32 uniform per draw: the integer part picks the bucket,
        # the fractional remainder runs the alias coin-flip. f32
        # resolution bounds the vocab at 2^24; larger vocabularies get
        # f64 draws.
        dt = np.float32 if prob.size < (1 << 24) else np.float64
        r = rng.random((B, K), dtype=dt) * prob.size
        u1 = r.astype(np.int32)
        neg = np.where(r - u1 < prob[u1], u1, alias[u1])
        return np.concatenate(
            [positives.astype(np.int32)[:, None], neg], axis=1)

    # Slab size: batches per upload. Epoch tails pad to the slab shape
    # with lr=0 batches, as in the JAX package (one compiled shape there;
    # here the slab loop skips them).
    _DENSE_SLAB = 64

    def _epoch_pack_chunk(self, arr, sid, rng, p0, p1):
        """Packed rows for centers in positions [p0, p1) of the full
        epoch stream (native builder; the NumPy fallback only where the
        library returns None) — windows see across chunk boundaries
        because the whole arrays are passed."""
        from deeplearning4j_tpu_torch import native

        K = self.negative if self.negative > 0 else 0
        if K:
            prob, alias = self._alias_tables()
        else:
            prob = alias = None
        seed = int(rng.integers(0, 2 ** 63))
        fn = (native.w2v_cbow_pack if self.use_cbow
              else native.w2v_sg_pack)
        pk = fn(arr, sid, self.window, K, prob, alias, seed, p0, p1)
        if pk is not None:
            return pk
        if self.use_cbow:
            cw, cen = self._cbow_from_flat(arr, sid, rng, p0, p1)
            parts = [cw, cen[:, None].astype(np.int32)]
            if K:
                parts.append(self._host_negatives(rng, cen)[:, 1:])
            return np.concatenate(parts, axis=1)
        cen, ctx = self._pairs_from_flat(arr, sid, rng, p0, p1)
        if K:
            return np.concatenate(
                [cen[:, None].astype(np.int32),
                 self._host_negatives(rng, ctx)], axis=1)
        return np.stack([cen, ctx], axis=1).astype(np.int32)

    # Pipelined host packing: ONE packer thread runs the native epoch
    # builders (ctypes releases the GIL) while the main thread keeps the
    # device fed, so packing, upload and the device's work overlap.
    pipeline_packing = True
    _PREFETCH_SLABS = 2

    def _prefetched(self, gen):
        """Drain `gen` on a daemon thread through a bounded queue when
        pipeline_packing is on; otherwise pass it through inline.
        Exceptions on the packer thread re-raise at the consumer."""
        if not self.pipeline_packing:
            return gen

        import queue as _qm
        import threading

        q: _qm.Queue = _qm.Queue(maxsize=self._PREFETCH_SLABS)
        DONE, ERR = object(), object()
        stop = threading.Event()   # consumer gone: the packer must not
                                   # park forever on a full queue

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except _qm.Full:
                    continue
            return False

        def run():
            try:
                for item in gen:
                    if not put(item):
                        return
                put(DONE)
            except BaseException as e:   # re-raised below
                put((ERR, e))

        packer = threading.Thread(target=run, daemon=True,
                                  name="w2v-slab-packer")
        packer.start()

        def drain():
            try:
                while True:
                    item = q.get()
                    if item is DONE:
                        return
                    if isinstance(item, tuple) and len(item) == 2 \
                            and item[0] is ERR:
                        raise item[1]
                    yield item
            finally:
                stop.set()
                # the stop flag makes every pending put() bail within one
                # timeout tick, so this join is bounded
                packer.join(timeout=2.0)

        return drain()

    def _dispatch_slab(self, tables, rows, lrs, W, hs_tabs):
        """Ship one [S*Bp, cols] row block and its per-batch lrs, and
        train the slab. Returns the (updated in place) tables.

        Rows may arrive as int16 (the halved wire format the packer uses
        when the vocabulary fits); one conversion per slab widens them to
        int64 on the device."""
        syn0 = tables[0]
        dev = syn0.device
        S = lrs.size
        Bp = rows.shape[0] // S
        live = [i for i in range(S) if lrs[i] != 0.0]
        if not live:
            return tables
        packs = torch.from_numpy(rows).to(dev).long()
        packs = packs.reshape(S, Bp, rows.shape[1])
        lrs_d = torch.from_numpy(lrs).to(dev)
        _, syn1, syn1neg = tables
        if self.use_cbow:
            if self.use_hs:
                syn0, syn1 = self._dense_steps.cbow_hs(
                    syn0, syn1, *hs_tabs, packs[:, :, :W + 1], W, lrs_d,
                    live)
            if self.negative > 0:
                syn0, syn1neg = self._dense_steps.cbow_ns(
                    syn0, syn1neg, packs, W, lrs_d, live)
        else:
            if self.use_hs:
                syn0, syn1 = self._dense_steps.sg_hs(
                    syn0, syn1, *hs_tabs, packs[:, :, :2], lrs_d, live)
            if self.negative > 0:
                syn0, syn1neg = self._dense_steps.sg_ns(
                    syn0, syn1neg, packs, lrs_d, live)
        return syn0, syn1, syn1neg

    def _fit_dense(self, seqs):
        """Streamed dense training: the corpus is processed in
        position-chunks whose packed rows accumulate in a host buffer;
        every full slab (fixed [S, Bp, cols] shape) ships as one upload.
        With pipeline_packing (default) the packing runs on a prefetch
        thread. The epoch tail pads to the slab shape with wrap-around
        rows; fully padded batches get lr=0 (no update)."""
        idx_arrays = self._index_corpus(seqs)
        if not idx_arrays:
            return self
        dev = resolve_device(self.device)
        rng = self._fit_rng or np.random.default_rng(self.seed + 1)
        W = 2 * self.window

        def take_dev(host_attr, dev_attr):
            """The device-resident table if present (trained in place),
            else a device copy of the host one."""
            t = getattr(self, dev_attr)
            if t is not None:
                setattr(self, dev_attr, None)
                return t.to(dev)
            host = getattr(self, host_attr)
            return None if host is None else _upload(host, dev)

        tables = (take_dev("_syn0_host", "_syn0_dev"),
                  take_dev("_syn1_host", "_syn1_dev"),
                  take_dev("_syn1neg_host", "_syn1neg_dev"))
        hs_tabs = self._hs_tabs_on(dev) if self.use_hs else None
        per_pos = 1 if self.use_cbow else self.window
        positions = sum(a.size for a in idx_arrays)
        chunked = int(self.lr_total_epochs) > 0
        total_ep = int(self.lr_total_epochs) or self.epochs
        approx = max(1, positions * per_pos * total_ep)
        S = self._DENSE_SLAB
        seen0 = self._lr_seen if chunked else 0
        # halved wire format: every packed value is a word index (or the
        # -1 CBOW empty-slot sentinel), so a sub-32k vocabulary ships
        # int16 rows and widens on the device
        wire_dt = (np.int16 if self.vocab.num_words() < 32768
                   else np.int32)

        def slabs():
            """Host production: yields (rows, lrs, n_real) fixed-shape
            slabs. Runs on the packer thread when pipeline_packing is on
            — all rng use (subsample, pack, negatives) lives here in the
            exact serial order, so the pipelined and inline paths are
            bit-identical."""
            seen = seen0
            for _ in range(self.epochs):
                arr, sid = self._subsample_flat(idx_arrays, rng)
                n = arr.size
                if n == 0:
                    continue
                Bp = self.dense_batch_size
                slab_rows = S * Bp
                # chunk sized to produce ~1.25 slabs of rows so the
                # buffer drains about once per chunk
                pos_chunk = max(1, int(slab_rows * 1.25
                                       / max(per_pos, 1)))
                buf: list = []
                buffered = 0
                first_rows = None
                for a in range(0, n, pos_chunk):
                    pk = self._epoch_pack_chunk(
                        arr, sid, rng, a, min(a + pos_chunk, n))
                    pk = pk.astype(wire_dt, copy=False)
                    if first_rows is None and pk.shape[0]:
                        first_rows = pk[:Bp].copy()
                    buf.append(pk)
                    buffered += pk.shape[0]
                    while buffered >= slab_rows:
                        block = np.concatenate(buf, axis=0)
                        rows, rest = (block[:slab_rows],
                                      block[slab_rows:])
                        buf, buffered = [rest], rest.shape[0]
                        lrs = np.asarray(
                            [self._lr(seen + i * Bp, approx)
                             for i in range(S)], np.float32)
                        yield rows, lrs, slab_rows
                        seen += slab_rows
                # epoch tail: top up to the fixed slab shape; whole
                # pad batches get lr=0, the boundary batch wraps
                # epoch-head rows
                rest = (np.concatenate(buf, axis=0) if buf
                        else np.zeros((0, 2), wire_dt))
                if rest.shape[0]:
                    n_real = rest.shape[0]
                    nb_real = -(-n_real // Bp)
                    pad_src = (first_rows if first_rows is not None
                               else rest)
                    need = nb_real * Bp - n_real
                    reps = (-(-need // max(pad_src.shape[0], 1))
                            if need else 0)
                    pad = (np.concatenate([pad_src] * reps,
                                          axis=0)[:need]
                           if reps else rest[:0])
                    filler = np.zeros(
                        ((S - nb_real) * Bp, rest.shape[1]), wire_dt)
                    rows = np.concatenate([rest, pad, filler], axis=0)
                    lrs = np.asarray(
                        [self._lr(seen + i * Bp, approx)
                         if i < nb_real else 0.0 for i in range(S)],
                        np.float32)
                    yield rows, lrs, n_real
                    seen += n_real

        seen_total = seen0
        for rows, lrs, n_real in self._prefetched(slabs()):
            tables = self._dispatch_slab(tables, rows, lrs, W, hs_tabs)
            seen_total += n_real
        if chunked:
            self._lr_seen = seen_total
        syn0, syn1, syn1neg = tables
        # The tables stay on the device: queries and serialization
        # fetch them lazily through the syn0/syn1/syn1neg properties.
        self._syn0_host, self._syn0_dev = None, syn0
        if syn1 is not None:
            self._syn1_host, self._syn1_dev = None, syn1
        if syn1neg is not None:
            self._syn1neg_host, self._syn1neg_dev = None, syn1neg
        return self

    # ------------------------------------------------------------- fit
    def fit(self, sequences: Iterable[Sequence[str]]):
        seqs = [list(s) for s in sequences]
        if self._syn0_host is None and self._syn0_dev is None:
            self.build_vocab(seqs)
        self._ensure_steps()
        if self._dense:
            return self._fit_dense(seqs)
        dev = resolve_device(self.device)
        rng = self._fit_rng or np.random.default_rng(self.seed + 1)
        syn0 = _upload(self.syn0, dev)
        syn1 = None if self.syn1 is None else _upload(self.syn1, dev)
        syn1neg = (None if self.syn1neg is None
                   else _upload(self.syn1neg, dev))

        # rough total example count for the linear lr decay: skip-gram
        # emits ~window pairs per position, CBOW one example per position
        per_pos = 1 if self.use_cbow else self.window
        chunked = int(self.lr_total_epochs) > 0
        total_ep = int(self.lr_total_epochs) or self.epochs
        approx_pairs = max(
            1, sum(len(s) for s in seqs) * per_pos * total_ep)
        seen = self._lr_seen if chunked else 0
        gen = (self._gen_cbow_examples if self.use_cbow
               else self._gen_pairs)
        flush = self._flush_cbow if self.use_cbow else self._flush
        for _ in range(self.epochs):
            order = rng.permutation(len(seqs))
            buf_c, buf_x = [], []
            for si in order:
                for c, x in gen([seqs[si]], rng):
                    buf_c.append(c)
                    buf_x.append(x)
                    if len(buf_c) >= self.batch_size:
                        syn0, syn1, syn1neg = flush(
                            syn0, syn1, syn1neg, buf_c, buf_x, rng,
                            seen, approx_pairs)
                        seen += len(buf_c)
                        buf_c, buf_x = [], []
            if buf_c:
                syn0, syn1, syn1neg = flush(
                    syn0, syn1, syn1neg, buf_c, buf_x, rng, seen,
                    approx_pairs)
                seen += len(buf_c)
        if chunked:
            self._lr_seen = seen
        self.syn0 = _host(syn0)
        self.syn1 = None if syn1 is None else _host(syn1)
        self.syn1neg = None if syn1neg is None else _host(syn1neg)
        return self

    def _lr(self, seen, total):
        frac = min(1.0, seen / total)
        return max(self.min_learning_rate,
                   self.learning_rate * (1.0 - frac))

    def _pad_batch_lists(self, *bufs):
        """Pad the final ragged batch to the fixed batch size (padding
        replicates the last example, as in the JAX package, where it
        keeps one compiled shape)."""
        B = self.batch_size
        out = []
        for buf in bufs:
            if len(buf) < B:
                buf = buf + [buf[-1]] * (B - len(buf))
            out.append(buf)
        return out

    def _pack_hs(self, targets):
        """Pack the targets' Huffman (points, codes, mask) arrays."""
        B = self.batch_size
        L = max(self._max_code_len, 1)
        words = self.vocab.vocab_words()
        pts = np.zeros((B, L), np.int32)
        cds = np.zeros((B, L), np.float32)
        msk = np.zeros((B, L), np.float32)
        for i, x in enumerate(targets):
            w = words[x]
            l = len(w.codes)
            pts[i, :l] = w.points
            cds[i, :l] = w.codes
            msk[i, :l] = 1.0
        return pts, cds, msk

    def _sample_negatives(self, positives, rng):
        """[B, K+1] targets (positive first) + [B, K+1] labels.
        Negatives colliding with the row's positive are resampled — the
        reference resamples on collision (SkipGram.java:258)."""
        B = self.batch_size
        K = self.negative
        pos = np.asarray(positives, np.int64)[:, None]
        neg = self._draw_negatives(rng, (B, K))
        for _ in range(16):
            coll = neg == pos
            n_coll = int(coll.sum())
            if not n_coll:
                break
            neg[coll] = self._draw_negatives(rng, n_coll)
        targets = np.concatenate([pos, neg], axis=1)
        labels = np.zeros((B, K + 1), np.float32)
        labels[:, 0] = 1.0
        return targets, labels

    def _flush(self, syn0, syn1, syn1neg, buf_c, buf_x, rng, seen, total):
        dev = syn0.device
        buf_c, buf_x = self._pad_batch_lists(buf_c, buf_x)
        center = _idx(buf_c, dev)
        lr = self._lr(seen, total)
        if self.use_hs:
            pts, cds, msk = self._pack_hs(buf_x)
            syn0, syn1, _ = self._hs_step(
                syn0, syn1, center, _idx(pts, dev), _upload(cds, dev),
                _upload(msk, dev), lr)
        if self.negative > 0:
            ctx, labels = self._sample_negatives(buf_x, rng)
            syn0, syn1neg, _ = self._neg_step(
                syn0, syn1neg, center, _idx(ctx, dev),
                _upload(labels, dev), lr)
        return syn0, syn1, syn1neg

    def _flush_cbow(self, syn0, syn1, syn1neg, buf_c, buf_x, rng, seen,
                    total):
        """CBOW batch: buf_c = center indices, buf_x = context lists."""
        dev = syn0.device
        buf_c, buf_x = self._pad_batch_lists(buf_c, buf_x)
        B = self.batch_size
        W = 2 * self.window
        cw = np.zeros((B, W), np.int32)
        cm = np.zeros((B, W), np.float32)
        for i, ctx in enumerate(buf_x):
            n = min(len(ctx), W)
            cw[i, :n] = ctx[:n]
            cm[i, :n] = 1.0
        cw_d = _idx(cw, dev)
        cm_d = _upload(cm, dev)
        lr = self._lr(seen, total)
        if self.use_hs:
            pts, cds, msk = self._pack_hs(buf_c)
            syn0, syn1, _ = self._cbow_hs_step(
                syn0, syn1, cw_d, cm_d, _idx(pts, dev), _upload(cds, dev),
                _upload(msk, dev), lr)
        if self.negative > 0:
            tgt, labels = self._sample_negatives(buf_c, rng)
            syn0, syn1neg, _ = self._cbow_neg_step(
                syn0, syn1neg, cw_d, cm_d, _idx(tgt, dev),
                _upload(labels, dev), lr)
        return syn0, syn1, syn1neg

    # ------------------------------------------------------- query API
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.syn0[i]

    def has_word(self, word: str) -> bool:
        return self.vocab.contains_word(word)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom else 0.0

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            v = self.get_word_vector(word_or_vec)
            exclude = {word_or_vec}
            if v is None:
                return []
        else:
            v = np.asarray(word_or_vec)
            exclude = set()
        norms = np.linalg.norm(self.syn0, axis=1) * np.linalg.norm(v)
        sims = self.syn0 @ v / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at_index(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out

    wordsNearest = words_nearest
