"""ParagraphVectors / doc2vec (counterpart of
deeplearning4j_tpu/nlp/paragraph_vectors.py; parity:
models/paragraphvectors/ParagraphVectors.java with the sequence-learning
algorithms DBOW and DM — models/embeddings/learning/impl/sequence/
{DBOW,DM}.java).

DBOW: the doc vector predicts sampled context words (negative sampling;
the scan tier's skip-gram step with the doc vectors as the centre table).
DM: mean of (context word vectors + doc vector) predicts the center word.
Both run as batched device steps over a document's padded windows.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.sentence_iterator import LabelledDocument
from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
    SequenceVectors,
    _NegSamplingStep,
    _bd_bkd,
    _bk_bkd,
    _host,
    _idx,
    _ns_loss,
    _upload,
)
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory


class _DMStep:
    """PV-DM update (JAX `_DMStep`), in place: each table's in-batch
    duplicate rows are scaled by 1/sqrt(their count)."""

    def __call__(self, syn0, docvecs, syn1neg, ctx, ctx_mask, doc_ids,
                 targets, labels, lr):
        D = syn0.shape[1]
        cw = syn0[ctx] * ctx_mask[..., None]          # [B,W,D]
        n_ctx = ctx_mask.sum(dim=1, keepdim=True)     # [B,1]
        dv = docvecs[doc_ids]                         # [B,D]
        denom = n_ctx + 1.0
        h = (cw.sum(dim=1) + dv) / denom              # [B,D]
        u = syn1neg[targets]                          # [B,K,D]
        p = torch.sigmoid(_bd_bkd(h, u))
        g = (labels - p) * lr
        dh = _bk_bkd(g, u) / denom
        du = g[:, :, None] * h[:, None, :]
        flat_t = targets.reshape(-1)
        t_cnt = torch.zeros(syn1neg.shape[0], dtype=p.dtype,
                            device=p.device)
        t_cnt.index_add_(0, flat_t, torch.ones_like(flat_t, dtype=p.dtype))
        syn1neg.index_add_(
            0, flat_t, du.reshape(-1, D) / torch.sqrt(t_cnt[flat_t])[:, None])
        d_cnt = torch.zeros(docvecs.shape[0], dtype=p.dtype,
                            device=p.device)
        d_cnt.index_add_(0, doc_ids, torch.ones_like(doc_ids,
                                                     dtype=p.dtype))
        docvecs.index_add_(0, doc_ids,
                           dh / torch.sqrt(d_cnt[doc_ids])[:, None])
        dctx = dh[:, None, :] * ctx_mask[..., None]
        flat_c = ctx.reshape(-1)
        c_cnt = torch.zeros(syn0.shape[0], dtype=p.dtype, device=p.device)
        c_cnt.index_add_(0, flat_c, ctx_mask.reshape(-1))
        syn0.index_add_(
            0, flat_c, dctx.reshape(-1, D)
            / torch.sqrt(c_cnt.clamp_min(1.0))[flat_c][:, None])
        return syn0, docvecs, syn1neg, _ns_loss(labels[None], p[None])


class ParagraphVectors(SequenceVectors):
    def __init__(self, dm: bool = False, **kw):
        self._tokenizer_factory = kw.pop("tokenizer_factory",
                                         DefaultTokenizerFactory())
        self._label_iterator = kw.pop("iterate_labelled", None)
        super().__init__(**kw)
        self.dm = dm
        self.doc_vectors: Optional[np.ndarray] = None
        self.labels: List[str] = []
        self._label_index: Dict[str, int] = {}
        self._dm_step = _DMStep()
        self._infer_step = _NegSamplingStep()

    class Builder:
        def __init__(self):
            self._kw = {}
            self._docs = None
            self._tok = None
            self._dm = False

        def layer_size(self, v):
            self._kw["layer_size"] = int(v)
            return self

        def window_size(self, v):
            self._kw["window"] = int(v)
            return self

        def negative_sample(self, v):
            self._kw["negative"] = int(v)
            return self

        def min_word_frequency(self, v):
            self._kw["min_word_frequency"] = int(v)
            return self

        def learning_rate(self, v):
            self._kw["learning_rate"] = float(v)
            return self

        def epochs(self, v):
            self._kw["epochs"] = int(v)
            return self

        def batch_size(self, v):
            self._kw["batch_size"] = int(v)
            return self

        def seed(self, v):
            self._kw["seed"] = int(v)
            return self

        def device(self, v):
            """Where the tables train (None: CUDA; "cpu" as asked)."""
            self._kw["device"] = v
            return self

        def sequence_learning_algorithm(self, name: str):
            self._dm = "dm" in str(name).lower()
            return self

        def iterate(self, label_aware_iterator):
            self._docs = label_aware_iterator
            return self

        def tokenizer_factory(self, tf):
            self._tok = tf
            return self

        def build(self) -> "ParagraphVectors":
            pv = ParagraphVectors(dm=self._dm, **self._kw)
            pv._label_iterator = self._docs
            if self._tok is not None:
                pv._tokenizer_factory = self._tok
            return pv

    # ------------------------------------------------------------------
    def fit(self, documents: Optional[Iterable[LabelledDocument]] = None):
        docs = list(documents if documents is not None
                    else self._label_iterator)
        token_seqs = []
        doc_labels = []
        for d in docs:
            toks = self._tokenizer_factory.create(d.content).get_tokens()
            token_seqs.append(toks)
            doc_labels.append(d.labels[0] if d.labels else f"DOC_{len(doc_labels)}")
        self.build_vocab(token_seqs)
        self.labels = doc_labels
        self._label_index = {l: i for i, l in enumerate(doc_labels)}
        rng = np.random.default_rng(self.seed)
        self.doc_vectors = ((rng.random((len(docs), self.layer_size)) - 0.5)
                            / self.layer_size).astype(np.float32)

        dev = resolve_device(self.device)
        syn0 = _upload(self.syn0, dev)
        syn1neg = _upload(self.syn1neg, dev)
        docvecs = _upload(self.doc_vectors, dev)
        total = max(1, sum(len(s) for s in token_seqs) * self.epochs)
        seen = 0
        for _ in range(self.epochs):
            for di in rng.permutation(len(token_seqs)):
                idxs = self._sequence_indices(token_seqs[di], rng)
                if not idxs:
                    continue
                lr = self._lr(seen, total)
                seen += len(idxs)
                if self.dm:
                    syn0, docvecs, syn1neg = self._fit_dm_doc(
                        syn0, docvecs, syn1neg, idxs, di, rng, lr)
                else:
                    syn0, docvecs, syn1neg = self._fit_dbow_doc(
                        syn0, docvecs, syn1neg, idxs, di, rng, lr)
        self.syn0 = _host(syn0)
        self.syn1neg = _host(syn1neg)
        self.doc_vectors = _host(docvecs)
        return self

    def _neg_targets(self, idxs, rng):
        B = len(idxs)
        K = self.negative
        neg = rng.choice(self.vocab.num_words(), size=(B, K),
                         p=self._unigram)
        tgt = np.concatenate([np.asarray(idxs)[:, None], neg], 1)
        labels = np.zeros((B, K + 1), np.float32)
        labels[:, 0] = 1.0
        return tgt.astype(np.int64), labels

    def _fit_dbow_doc(self, syn0, docvecs, syn1neg, idxs, di, rng, lr):
        """Doc vector predicts each word (PV-DBOW)."""
        dev = syn0.device
        tgt, labels = self._neg_targets(idxs, rng)
        doc_ids = np.full(len(idxs), di, np.int64)
        # the skip-gram step with docvecs as the "center" table
        docvecs, syn1neg, _ = self._infer_step(
            docvecs, syn1neg, _idx(doc_ids, dev), _idx(tgt, dev),
            _upload(labels, dev), lr)
        return syn0, docvecs, syn1neg

    def _fit_dm_doc(self, syn0, docvecs, syn1neg, idxs, di, rng, lr):
        dev = syn0.device
        W = 2 * self.window
        n = len(idxs)
        ctx = np.zeros((n, W), np.int64)
        cmask = np.zeros((n, W), np.float32)
        for pos in range(n):
            c = 0
            for off in range(-self.window, self.window + 1):
                j = pos + off
                if off == 0 or not (0 <= j < n):
                    continue
                ctx[pos, c] = idxs[j]
                cmask[pos, c] = 1.0
                c += 1
        tgt, labels = self._neg_targets(idxs, rng)
        doc_ids = np.full(n, di, np.int64)
        syn0, docvecs, syn1neg, _ = self._dm_step(
            syn0, docvecs, syn1neg, _idx(ctx, dev), _upload(cmask, dev),
            _idx(doc_ids, dev), _idx(tgt, dev), _upload(labels, dev), lr)
        return syn0, docvecs, syn1neg

    # ------------------------------------------------------------------
    def get_doc_vector(self, label: str) -> Optional[np.ndarray]:
        i = self._label_index.get(label)
        return None if i is None else self.doc_vectors[i]

    def similarity_doc(self, a: str, b: str) -> float:
        va, vb = self.get_doc_vector(a), self.get_doc_vector(b)
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom else 0.0

    def infer_vector(self, text: str, steps: int = 20,
                     learning_rate: float = 0.025) -> np.ndarray:
        """Gradient-fit a fresh doc vector with the word tables frozen
        (ref: ParagraphVectors.inferVector): each step starts from the
        trained syn1neg (inside a step, its chunks see each other's
        updates, as in the JAX package)."""
        toks = self._tokenizer_factory.create(text).get_tokens()
        rng = np.random.default_rng(self.seed + 7)
        idxs = [self.vocab.index_of(t) for t in toks]
        idxs = [i for i in idxs if i >= 0]
        if not idxs:
            return np.zeros(self.layer_size, np.float32)
        dev = resolve_device(self.device)
        vec = ((rng.random((1, self.layer_size)) - 0.5)
               / self.layer_size).astype(np.float32)
        vec_d = _upload(vec, dev)
        frozen = _upload(self.syn1neg, dev)
        doc_ids = torch.zeros(len(idxs), dtype=torch.int64, device=dev)
        for s in range(steps):
            tgt, labels = self._neg_targets(idxs, rng)
            lr = learning_rate * (1 - s / steps) + 1e-4 * s / steps
            self._infer_step(vec_d, frozen.clone(), doc_ids,
                             _idx(tgt, dev), _upload(labels, dev), lr)
        return _host(vec_d)[0]
