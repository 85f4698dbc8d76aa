"""EvaluationCalibration: reliability diagrams, residual plots,
probability histograms (counterpart of
deeplearning4j_tpu/eval/calibration.py).

Parity: eval/EvaluationCalibration.java — accumulates per-bin counts of
predicted probability vs empirical accuracy (reliability), |label - p|
residuals, and predicted-probability histograms; plus expected
calibration error as the summary scalar. The counts (int64) and the
probability sums (float64) accumulate on `device` (None means "cuda";
without a GPU it raises unless device="cpu") with `index_add_` and no
host sync, fed numpy arrays or tensors on any device; the queries are
the JAX module's, on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.eval._tensors import host, rows

_ACC = ("_counts", "_correct", "_prob_sum", "_residual_hist", "_prob_hist")


class EvaluationCalibration:
    """Accumulate with eval(labels, predictions) per batch
    (labels one-hot [N, C], predictions probabilities [N, C])."""

    def __init__(self, reliability_bins: int = 10,
                 histogram_bins: int = 50, device=None):
        self.device = resolve_device(device)
        self.reliability_bins = reliability_bins
        self.histogram_bins = histogram_bins
        self._acc = None           # {name in _ACC: tensor on the device}
        self.num_classes = None

    def _ensure(self, c: int):
        if self._acc is None:
            self.num_classes = c
            b, h = self.reliability_bins, self.histogram_bins
            z = lambda *s, dt=torch.int64: torch.zeros(
                *s, dtype=dt, device=self.device)
            self._acc = {"_counts": z(c, b), "_correct": z(c, b),
                         "_prob_sum": z(c, b, dt=torch.float64),
                         "_residual_hist": z(h), "_prob_hist": z(c, h)}

    def eval(self, labels, predictions, mask=None):
        if np.ndim(labels) != 2:
            raise ValueError("labels must be one-hot [N, C]")
        lab, p, w = rows(labels, predictions, mask, self.device,
                         torch.float64)
        n, c = lab.shape
        self._ensure(c)
        if n == 0:
            return self
        a, b, h = self._acc, self.reliability_bins, self.histogram_bins
        cls = torch.arange(c, device=self.device)[None, :]
        bins = torch.clamp((p * b).to(torch.int64), 0, b - 1) + b * cls
        correct = (lab > 0.5).to(torch.int64)
        wc = w[:, None].expand(n, c).reshape(-1)
        flat = bins.reshape(-1)
        a["_counts"].view(-1).index_add_(0, flat, wc)
        a["_correct"].view(-1).index_add_(0, flat, correct.reshape(-1) * wc)
        a["_prob_sum"].view(-1).index_add_(
            0, flat, p.reshape(-1) * wc.to(torch.float64))
        hb = torch.clamp((p * h).to(torch.int64), 0, h - 1) + h * cls
        a["_prob_hist"].view(-1).index_add_(0, hb.reshape(-1), wc)
        res = (lab - p).abs().reshape(-1)
        rb = torch.clamp((res * h).to(torch.int64), 0, h - 1)
        a["_residual_hist"].index_add_(0, rb, wc)
        return self

    def __getattr__(self, name):
        # the accumulators, read on the host as the JAX module's arrays
        if name in _ACC and self.__dict__.get("_acc") is not None:
            return host(self._acc[name])
        raise AttributeError(name)

    # ------------------------------------------------------------- queries
    def reliability_info(self, class_idx: int):
        """(mean predicted prob per bin, empirical frequency per bin,
        counts per bin) — the reliability diagram
        (ref getReliabilityDiagram)."""
        cnt = self._counts[class_idx]
        safe = np.maximum(cnt, 1)
        mean_p = self._prob_sum[class_idx] / safe
        freq = self._correct[class_idx] / safe
        return mean_p, freq, cnt.copy()

    def expected_calibration_error(self, class_idx: Optional[int] = None
                                   ) -> float:
        """ECE = sum_b (n_b / N) |acc_b - conf_b| (macro over classes if
        class_idx is None)."""
        idxs = (range(self.num_classes) if class_idx is None
                else [class_idx])
        eces = []
        for ci in idxs:
            mean_p, freq, cnt = self.reliability_info(ci)
            total = max(cnt.sum(), 1)
            eces.append(float(np.sum(cnt / total * np.abs(freq - mean_p))))
        return float(np.mean(eces))

    def residual_plot(self):
        """(bin_edges, counts) of |label - p| (ref getResidualPlot)."""
        edges = np.linspace(0, 1, self.histogram_bins + 1)
        return edges, self._residual_hist.copy()

    def probability_histogram(self, class_idx: int):
        """(bin_edges, counts) of predicted P(class) (ref
        getProbabilityHistogram)."""
        edges = np.linspace(0, 1, self.histogram_bins + 1)
        return edges, self._prob_hist[class_idx].copy()

    def stats(self) -> str:
        lines = ["EvaluationCalibration "
                 f"(bins={self.reliability_bins}):"]
        for ci in range(self.num_classes):
            lines.append(f"  class {ci}: ECE="
                         f"{self.expected_calibration_error(ci):.4f}")
        lines.append(f"  macro ECE={self.expected_calibration_error():.4f}")
        return "\n".join(lines)
