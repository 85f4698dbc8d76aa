"""GloVe (counterpart of deeplearning4j_tpu/nlp/glove.py; parity:
models/glove/Glove.java + models/glove/count/ cooccurrence counting).
A host-side cooccurrence map, then AdaGrad updates over batched
(i, j, X_ij) triples on the device — the reference's per-pair AdaGrad
(AbstractCoOccurrences + GloveCalculations) batch-synchronously.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
    SequenceVectors,
    _host,
    _upload,
)


class _GloveStep:
    """One AdaGrad step over a batch of (i, j) pairs (JAX `_GloveStep`),
    in place. Duplicate indices sum (`index_add_`); the accumulators are
    read after their own scatter, as in the JAX step."""

    def __call__(self, w, wc, b, bc, hw, hwc, hb, hbc, ii, jj, logx, fx,
                 lr):
        wi = w[ii]
        wj = wc[jj]
        diff = (wi * wj).sum(dim=1) + b[ii] + bc[jj] - logx
        fdiff = fx * diff                      # [B]
        gwi = fdiff[:, None] * wj
        gwj = fdiff[:, None] * wi
        gb2 = fdiff * fdiff                    # gbi * gbi == gbj * gbj
        hw.index_add_(0, ii, gwi * gwi)
        hwc.index_add_(0, jj, gwj * gwj)
        hb.index_add_(0, ii, gb2)
        hbc.index_add_(0, jj, gb2)
        eps = 1e-8
        w.index_add_(0, ii, (gwi * -lr) / torch.sqrt(hw[ii] + eps))
        wc.index_add_(0, jj, (gwj * -lr) / torch.sqrt(hwc[jj] + eps))
        b.index_add_(0, ii, (fdiff * -lr) / torch.sqrt(hb[ii] + eps))
        bc.index_add_(0, jj, (fdiff * -lr) / torch.sqrt(hbc[jj] + eps))
        return 0.5 * (fx * diff * diff).mean()


class Glove(SequenceVectors):
    def __init__(self, x_max: float = 100.0, alpha: float = 0.75, **kw):
        kw.setdefault("learning_rate", 0.05)
        super().__init__(**kw)
        self.x_max = x_max
        self.alpha = alpha
        self._step = _GloveStep()

    def _cooccurrences(self, seqs) -> Dict[Tuple[int, int], float]:
        co: Dict[Tuple[int, int], float] = {}
        for seq in seqs:
            idxs = [self.vocab.index_of(t) for t in seq]
            idxs = [i for i in idxs if i >= 0]
            for pos, center in enumerate(idxs):
                for off in range(1, self.window + 1):
                    j = pos + off
                    if j >= len(idxs):
                        break
                    a, c = center, idxs[j]
                    wgt = 1.0 / off
                    co[(a, c)] = co.get((a, c), 0.0) + wgt
                    co[(c, a)] = co.get((c, a), 0.0) + wgt
        return co

    def fit(self, sequences: Iterable[Sequence[str]]):
        seqs = [list(s) for s in sequences]
        if self.syn0 is None:
            self.build_vocab(seqs)
        co = self._cooccurrences(seqs)
        if not co:
            return self
        dev = resolve_device(self.device)
        V = self.vocab.num_words()
        D = self.layer_size
        rng = np.random.default_rng(self.seed)
        w = _upload((rng.random((V, D)) - 0.5).astype(np.float32) / D, dev)
        wc = _upload((rng.random((V, D)) - 0.5).astype(np.float32) / D,
                     dev)
        b = torch.zeros(V, dtype=torch.float32, device=dev)
        bc = torch.zeros(V, dtype=torch.float32, device=dev)
        hw = torch.ones((V, D), dtype=torch.float32, device=dev)
        hwc = torch.ones((V, D), dtype=torch.float32, device=dev)
        hb = torch.ones(V, dtype=torch.float32, device=dev)
        hbc = torch.ones(V, dtype=torch.float32, device=dev)

        pairs = np.asarray(list(co.keys()), np.int64)
        xs = np.asarray(list(co.values()), np.float32)
        logx = np.log(xs)
        fx = np.minimum(1.0, (xs / self.x_max) ** self.alpha).astype(np.float32)
        # the triples ship once; each epoch ships its permutation once
        ii_all = _upload(pairs[:, 0], dev)
        jj_all = _upload(pairs[:, 1], dev)
        logx_d, fx_d = _upload(logx, dev), _upload(fx, dev)
        B = min(self.batch_size, len(pairs))
        lr = self.learning_rate
        for _ in range(self.epochs):
            order = _upload(rng.permutation(len(pairs)), dev)
            for s in range(0, len(pairs) - B + 1, B):
                sel = order[s:s + B]
                self._step(w, wc, b, bc, hw, hwc, hb, hbc, ii_all[sel],
                           jj_all[sel], logx_d[sel], fx_d[sel], lr)
        self.syn0 = _host(w) + _host(wc)  # standard GloVe sum
        return self
