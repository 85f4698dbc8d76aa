"""Multi-label binary evaluation (counterpart of
deeplearning4j_tpu/eval/binary.py).

Parity: eval/EvaluationBinary.java — per-output-column binary counts at a
0.5 decision threshold, accuracy/precision/recall/F1 per column. The
counts accumulate as int64 on `device` (None means "cuda"; without a GPU
it raises unless device="cpu"), fed numpy arrays or tensors on any
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.eval._tensors import host, rows

_COUNTS = ("tp", "fp", "tn", "fn")


class EvaluationBinary:
    def __init__(self, n_columns: Optional[int] = None,
                 threshold: float = 0.5, device=None):
        self.device = resolve_device(device)
        self.n = n_columns
        self.threshold = threshold
        self._acc = None          # {"tp"|"fp"|"tn"|"fn": [n] int64}

    def _ensure(self, n):
        if self._acc is None:
            self.n = self.n or n
            self._acc = {k: torch.zeros(self.n, dtype=torch.int64,
                                        device=self.device) for k in _COUNTS}

    def eval(self, labels, predictions, mask=None):
        """Accumulate a batch: [N, C] (a mask is ignored) or [N, T, C]
        with an optional [N, T] mask."""
        lab, pred, w = rows(labels, predictions,
                            mask if np.ndim(labels) == 3 else None,
                            self.device)
        self._ensure(lab.shape[-1])
        p = pred >= self.threshold
        actual = lab >= 0.5
        w = w[:, None]
        a = self._acc
        a["tp"] += ((p & actual) * w).sum(0)
        a["fp"] += ((p & ~actual) * w).sum(0)
        a["tn"] += ((~p & ~actual) * w).sum(0)
        a["fn"] += ((~p & actual) * w).sum(0)

    def __getattr__(self, name):
        # the counts, read on the host as the JAX module's numpy arrays
        if name in _COUNTS and self.__dict__.get("_acc") is not None:
            return host(self._acc[name])
        raise AttributeError(name)

    def accuracy(self, col: int) -> float:
        tp, fp, tn, fn = (self.tp[col], self.fp[col], self.tn[col],
                          self.fn[col])
        total = tp + fp + tn + fn
        return float((tp + tn) / total) if total else 0.0

    def precision(self, col: int) -> float:
        tp, fp = self.tp[col], self.fp[col]
        return float(tp / (tp + fp)) if tp + fp else 0.0

    def recall(self, col: int) -> float:
        tp, fn = self.tp[col], self.fn[col]
        return float(tp / (tp + fn)) if tp + fn else 0.0

    def f1(self, col: int) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def average_accuracy(self) -> float:
        return float(np.mean([self.accuracy(c) for c in range(self.n)]))

    def stats(self) -> str:
        lines = ["Column    Acc      Prec     Recall   F1"]
        for c in range(self.n):
            lines.append(
                f"col_{c:<5} {self.accuracy(c):<8.4f} {self.precision(c):<8.4f} "
                f"{self.recall(c):<8.4f} {self.f1(c):<8.4f}")
        return "\n".join(lines)

    def merge(self, other: "EvaluationBinary"):
        if other._acc is None:
            return self
        self._ensure(other.n)
        for k in _COUNTS:
            self._acc[k] += other._acc[k].to(self.device)
        return self
