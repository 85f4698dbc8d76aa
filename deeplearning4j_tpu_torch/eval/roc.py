"""ROC / AUC evaluation (counterpart of deeplearning4j_tpu/eval/roc.py).

Parity: eval/ROC.java, ROCBinary.java, ROCMultiClass.java + eval/curves/.
Scores are binned into `threshold_steps` bins of [0, 1] (200 by default,
the reference's default), so memory is O(bins) whatever the data size.
The bin counts accumulate as int64 on `device` (None means "cuda";
without a GPU it raises unless device="cpu") with one `index_add_` per
batch and no host sync, fed numpy arrays or tensors on any device; the
curves and AUCs are the JAX module's, computed on the host from the
counts, so they equal the JAX package's numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.eval._tensors import host, rows


class _BinnedRoc:
    """TPR/FPR from score counts per bin in [0, 1], one curve per column:
    `pos`/`neg` are [columns, bins] int64 tensors."""

    def __init__(self, bins: int, columns: int, device):
        self.bins = bins
        self.pos = torch.zeros(columns, bins, dtype=torch.int64, device=device)
        self.neg = torch.zeros_like(self.pos)

    def add(self, scores: torch.Tensor, is_positive: torch.Tensor,
            weight: torch.Tensor):
        """scores, is_positive: [N, columns]; weight: [N] (0 drops a row)."""
        idx = torch.clamp((scores * self.bins).to(torch.int64), 0,
                          self.bins - 1)
        flat = idx + self.bins * torch.arange(
            idx.shape[1], device=idx.device)[None, :]
        w = weight[:, None]
        self.pos.view(-1).index_add_(0, flat.reshape(-1),
                                     (is_positive * w).reshape(-1))
        self.neg.view(-1).index_add_(0, flat.reshape(-1),
                                     (~is_positive * w).reshape(-1))

    def column(self, c: int) -> "_Curve":
        return _Curve(host(self.pos[c]), host(self.neg[c]))


class _Curve:
    """One column's host counts and the JAX module's curve arithmetic."""

    def __init__(self, pos_hist: np.ndarray, neg_hist: np.ndarray):
        self.pos_hist = pos_hist
        self.neg_hist = neg_hist

    def curve(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (fpr, tpr) arrays from highest threshold to lowest."""
        # cumulate from the top bin down: predictions >= threshold
        pos_cum = np.cumsum(self.pos_hist[::-1])
        neg_cum = np.cumsum(self.neg_hist[::-1])
        P = max(int(self.pos_hist.sum()), 1)
        N = max(int(self.neg_hist.sum()), 1)
        tpr = np.concatenate([[0.0], pos_cum / P])
        fpr = np.concatenate([[0.0], neg_cum / N])
        return fpr, tpr

    def auc(self) -> float:
        fpr, tpr = self.curve()
        return float(np.trapezoid(tpr, fpr))

    def precision_recall(self) -> Tuple[np.ndarray, np.ndarray]:
        """(precision, recall) from highest threshold to lowest
        (ref eval/curves/PrecisionRecallCurve.java)."""
        pos_cum = np.cumsum(self.pos_hist[::-1])
        neg_cum = np.cumsum(self.neg_hist[::-1])
        P = max(int(self.pos_hist.sum()), 1)
        predicted = pos_cum + neg_cum
        # no predicted positives -> precision defined as 1.0 (ref
        # PrecisionRecallCurve semantics)
        precision = np.where(predicted > 0,
                             pos_cum / np.maximum(predicted, 1), 1.0)
        precision = np.concatenate([[1.0], precision])
        recall = np.concatenate([[0.0], pos_cum / P])
        return precision, recall


class _RocEval:
    """What the three ROC evaluations share: the device, the bins and
    `eval`'s input handling ([N, C], or [N, T, C] flattened to rows; an
    optional mask drops rows in both)."""

    def __init__(self, threshold_steps: int, device):
        self.device = resolve_device(device)
        self.steps = threshold_steps
        self._roc: Optional[_BinnedRoc] = None

    def _rows(self, labels, predictions, mask, columns: int):
        lab, pred, w = rows(labels, predictions, mask, self.device)
        if self._roc is None:
            self._roc = _BinnedRoc(self.steps, columns or lab.shape[-1],
                                   self.device)
        return lab, pred, w

    def merge(self, other):
        if other._roc is None:
            return self
        if self._roc is None:
            self._roc = _BinnedRoc(other.steps, other._roc.pos.shape[0],
                                   self.device)
        self._roc.pos += other._roc.pos.to(self.device)
        self._roc.neg += other._roc.neg.to(self.device)
        return self


class ROC(_RocEval):
    """Binary-problem ROC: labels [N, 1] (0/1) or [N, 2] one-hot; scores are
    P(class=1)."""

    def __init__(self, threshold_steps: int = 200, device=None):
        super().__init__(threshold_steps, device)

    def eval(self, labels, predictions, mask=None):
        lab, pred, w = self._rows(labels, predictions, mask, 1)
        c = 1 if lab.shape[-1] == 2 else 0
        self._roc.add(pred[:, c:c + 1], lab[:, c:c + 1] >= 0.5, w)

    def calculate_auc(self) -> float:
        return self._roc.column(0).auc()

    auc = calculate_auc

    def get_roc_curve(self):
        return self._roc.column(0).curve()

    roc_curve = get_roc_curve

    def precision_recall_curve(self):
        return self._roc.column(0).precision_recall()


class ROCBinary(_RocEval):
    """Per-output-column ROC for multi-label binary outputs."""

    def __init__(self, threshold_steps: int = 200, device=None):
        super().__init__(threshold_steps, device)

    def eval(self, labels, predictions, mask=None):
        lab, pred, w = self._rows(labels, predictions, mask, 0)
        self._roc.add(pred, lab >= 0.5, w)

    def calculate_auc(self, col: int) -> float:
        return self._roc.column(col).auc()

    def average_auc(self) -> float:
        return float(np.mean([self.calculate_auc(c)
                              for c in range(self._roc.pos.shape[0])]))


class ROCMultiClass(_RocEval):
    """One-vs-all ROC per class for softmax outputs."""

    def __init__(self, threshold_steps: int = 200, device=None):
        super().__init__(threshold_steps, device)

    def eval(self, labels, predictions, mask=None):
        lab, pred, w = self._rows(labels, predictions, mask, 0)
        actual = lab.argmax(dim=-1)
        classes = torch.arange(lab.shape[-1], device=self.device)
        self._roc.add(pred, actual[:, None] == classes[None, :], w)

    def calculate_auc(self, cls: int) -> float:
        return self._roc.column(cls).auc()

    def average_auc(self) -> float:
        return float(np.mean([self.calculate_auc(c)
                              for c in range(self._roc.pos.shape[0])]))
