"""Classification evaluation: accuracy/precision/recall/F1 + confusion
matrix (counterpart of deeplearning4j_tpu/eval/evaluation.py, which is
host numpy; this is the port's own copy).

Parity: eval/Evaluation.java (`eval`:288, `stats()`:502, `f1`:978) and
eval/ConfusionMatrix.java. Accumulates over batches (call
`eval(labels, predictions)` per batch, read metrics at the end). Counts
accumulate in a host-side numpy confusion matrix: evaluation is not a hot
path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.eval._tensors import host


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def add_batch(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def actual_total(self, cls: int) -> int:
        return int(self.matrix[cls].sum())

    def predicted_total(self, cls: int) -> int:
        return int(self.matrix[:, cls].sum())

    def total(self) -> int:
        return int(self.matrix.sum())

    def __str__(self):
        return str(self.matrix)


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None):
        self.label_names = labels
        if labels is not None and num_classes is None:
            num_classes = len(labels)
        self.num_classes = num_classes
        self.confusion: Optional[ConfusionMatrix] = None
        self.top_n_correct = 0
        self.top_n_total = 0

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)

    def eval(self, labels, predictions, mask=None, top_n: int = 1):
        """Accumulate a batch. labels/predictions: [N, C] (one-hot / prob)
        or [N, T, C] time series with optional [N, T] mask."""
        labels = host(labels)
        predictions = host(predictions)
        if mask is not None:
            mask = host(mask)
        if labels.ndim == 3:
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
            else:
                m = np.ones(labels.shape[0] * labels.shape[1], dtype=bool)
            labels = labels.reshape(-1, labels.shape[-1])[m]
            predictions = predictions.reshape(-1, predictions.shape[-1])[m]
        elif mask is not None:
            # [N] example mask on 2D input: drop masked-out rows (e.g. DP
            # batch padding) so they don't enter the confusion matrix
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        actual = labels.argmax(axis=-1)
        pred = predictions.argmax(axis=-1)
        self.confusion.add_batch(actual, pred)
        if top_n > 1:
            topk = np.argsort(-predictions, axis=-1)[:, :top_n]
            self.top_n_correct += int((topk == actual[:, None]).any(axis=1).sum())
            self.top_n_total += len(actual)

    # ---- metrics ----
    def accuracy(self) -> float:
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.top_n_total if self.top_n_total else 0.0

    def true_positives(self, cls: int) -> int:
        return self.confusion.get_count(cls, cls)

    def false_positives(self, cls: int) -> int:
        return self.confusion.predicted_total(cls) - self.true_positives(cls)

    def false_negatives(self, cls: int) -> int:
        return self.confusion.actual_total(cls) - self.true_positives(cls)

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self.confusion.predicted_total(cls)
            return self.true_positives(cls) / denom if denom else 0.0
        vals = [self.precision(c) for c in range(self.num_classes)
                if self.confusion.actual_total(c) > 0
                or self.confusion.predicted_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self.confusion.actual_total(cls)
            return self.true_positives(cls) / denom if denom else 0.0
        vals = [self.recall(c) for c in range(self.num_classes)
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def matthews_correlation(self, cls: int) -> float:
        tp = self.true_positives(cls)
        fp = self.false_positives(cls)
        fn = self.false_negatives(cls)
        tn = self.confusion.total() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return ((tp * tn - fp * fn) / denom) if denom else 0.0

    def stats(self) -> str:
        """Pretty report (ref: Evaluation.stats():502)."""
        lines = ["========================Scores========================"]
        lines.append(f" # of classes:    {self.num_classes}")
        lines.append(f" Accuracy:        {self.accuracy():.4f}")
        lines.append(f" Precision:       {self.precision():.4f}")
        lines.append(f" Recall:          {self.recall():.4f}")
        lines.append(f" F1 Score:        {self.f1():.4f}")
        if self.top_n_total:
            lines.append(f" Top-N Accuracy:  {self.top_n_accuracy():.4f}")
        lines.append("======================================================")
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        lines.append(str(self.confusion))
        return "\n".join(lines)

    def merge(self, other: "Evaluation"):
        """Combine accumulated counts (the distributed-eval reduce step,
        ref: spark IEvaluationReduceFunction)."""
        if other.confusion is None:
            return self
        self._ensure(other.num_classes)
        self.confusion.matrix += other.confusion.matrix
        self.top_n_correct += other.top_n_correct
        self.top_n_total += other.top_n_total
        return self
