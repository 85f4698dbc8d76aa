"""EarlyStoppingConfiguration + result (parity:
earlystopping/EarlyStoppingConfiguration.java,
EarlyStoppingResult.java).

Counterpart of deeplearning4j_tpu/earlystopping/config.py."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class EarlyStoppingConfiguration:
    model_saver: Any = None                  # default InMemoryModelSaver
    score_calculator: Any = None             # e.g. DataSetLossCalculator
    epoch_termination_conditions: List = field(default_factory=list)
    iteration_termination_conditions: List = field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    class Builder:
        def __init__(self):
            self._c = EarlyStoppingConfiguration()

        def model_saver(self, s):
            self._c.model_saver = s
            return self

        def score_calculator(self, sc):
            self._c.score_calculator = sc
            return self

        def epoch_termination_conditions(self, *conds):
            self._c.epoch_termination_conditions.extend(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._c.iteration_termination_conditions.extend(conds)
            return self

        def evaluate_every_n_epochs(self, n):
            self._c.evaluate_every_n_epochs = int(n)
            return self

        def save_last_model(self, v=True):
            self._c.save_last_model = bool(v)
            return self

        def build(self):
            from deeplearning4j_tpu_torch.earlystopping.saver import (
                InMemoryModelSaver,
            )
            if self._c.model_saver is None:
                self._c.model_saver = InMemoryModelSaver()
            return self._c


class TerminationReason:
    EPOCH_TERMINATION = "epoch_termination_condition"
    ITERATION_TERMINATION = "iteration_termination_condition"
    ERROR = "error"


@dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Optional[Any] = None
