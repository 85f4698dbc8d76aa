"""Regression evaluation: MSE, MAE, RMSE, RSE, PC (Pearson), R^2 per
column (counterpart of deeplearning4j_tpu/eval/regression.py).

Parity: eval/RegressionEvaluation.java — accumulates sufficient statistics
per output column across batches. The sums accumulate in float64 on
`device` (None means "cuda"; without a GPU it raises unless
device="cpu"), fed numpy arrays or tensors on any device; the metrics
are the JAX module's formulas on the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.eval._tensors import host, rows

_SUMS = ("count", "sum_abs_err", "sum_sq_err", "sum_label", "sum_label_sq",
         "sum_pred", "sum_pred_sq", "sum_label_pred")


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None,
                 column_names: Optional[List[str]] = None, device=None):
        self.device = resolve_device(device)
        self.column_names = column_names
        if column_names is not None and n_columns is None:
            n_columns = len(column_names)
        self.n = n_columns
        self._acc = None          # {sum name: [n] float64 tensor}

    def _ensure(self, n):
        if self._acc is None:
            self.n = self.n or n
            self._acc = {k: torch.zeros(self.n, dtype=torch.float64,
                                        device=self.device) for k in _SUMS}

    def eval(self, labels, predictions, mask=None):
        """Accumulate a batch: [N, C] (a mask is ignored) or [N, T, C]
        with an optional [N, T] mask."""
        lab, pred, w = rows(labels, predictions,
                            mask if np.ndim(labels) == 3 else None,
                            self.device, torch.float64)
        self._ensure(lab.shape[-1])
        w = w.to(torch.float64)[:, None]
        err = pred - lab
        a = self._acc
        a["count"] += w.sum()
        a["sum_abs_err"] += (err.abs() * w).sum(0)
        a["sum_sq_err"] += (err * err * w).sum(0)
        a["sum_label"] += (lab * w).sum(0)
        a["sum_label_sq"] += (lab * lab * w).sum(0)
        a["sum_pred"] += (pred * w).sum(0)
        a["sum_pred_sq"] += (pred * pred * w).sum(0)
        a["sum_label_pred"] += (lab * pred * w).sum(0)

    def __getattr__(self, name):
        # the sums, read on the host as the JAX module's numpy arrays
        if name in _SUMS and self.__dict__.get("_acc") is not None:
            return host(self._acc[name])
        raise AttributeError(name)

    def mean_squared_error(self, col: int) -> float:
        return float(self.sum_sq_err[col] / self.count[col])

    def mean_absolute_error(self, col: int) -> float:
        return float(self.sum_abs_err[col] / self.count[col])

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int) -> float:
        n = self.count[col]
        mean_label = self.sum_label[col] / n
        denom = self.sum_label_sq[col] - n * mean_label**2
        return float(self.sum_sq_err[col] / denom) if denom else float("inf")

    def pearson_correlation(self, col: int) -> float:
        n = self.count[col]
        cov = self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col] / n
        var_l = self.sum_label_sq[col] - self.sum_label[col] ** 2 / n
        var_p = self.sum_pred_sq[col] - self.sum_pred[col] ** 2 / n
        denom = np.sqrt(var_l * var_p)
        return float(cov / denom) if denom else 0.0

    def r_squared(self, col: int) -> float:
        n = self.count[col]
        mean_label = self.sum_label[col] / n
        ss_tot = self.sum_label_sq[col] - n * mean_label**2
        return float(1.0 - self.sum_sq_err[col] / ss_tot) if ss_tot else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean([self.mean_squared_error(c) for c in range(self.n)]))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean([self.mean_absolute_error(c) for c in range(self.n)]))

    def stats(self) -> str:
        lines = ["Column    MSE          MAE          RMSE         RSE          R^2"]
        for c in range(self.n):
            name = (self.column_names[c] if self.column_names
                    else f"col_{c}")
            lines.append(
                f"{name:<9} {self.mean_squared_error(c):<12.5g} "
                f"{self.mean_absolute_error(c):<12.5g} "
                f"{self.root_mean_squared_error(c):<12.5g} "
                f"{self.relative_squared_error(c):<12.5g} "
                f"{self.r_squared(c):<12.5g}")
        return "\n".join(lines)

    def merge(self, other: "RegressionEvaluation"):
        if other._acc is None:
            return self
        self._ensure(other.n)
        for k in _SUMS:
            self._acc[k] += other._acc[k].to(self.device)
        return self
