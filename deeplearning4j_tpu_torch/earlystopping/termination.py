"""Termination conditions (parity: earlystopping/termination/* —
MaxEpochsTerminationCondition, BestScoreEpochTerminationCondition,
ScoreImprovementEpochTerminationCondition, MaxTimeIterationTermination-
Condition, MaxScoreIterationTerminationCondition,
InvalidScoreIterationTerminationCondition).

Counterpart of deeplearning4j_tpu/earlystopping/termination.py."""

from __future__ import annotations

import math
import time


class EpochTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least this good."""

    def __init__(self, best_expected: float):
        self.best_expected = best_expected

    def terminate(self, epoch, score):
        return score <= self.best_expected


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without (sufficient) improvement."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = None
        self.stale = 0

    def initialize(self):
        self.best = None
        self.stale = 0

    def terminate(self, epoch, score):
        if self.best is None or self.best - score > self.min_improvement:
            self.best = score
            self.stale = 0
            return False
        self.stale += 1
        return self.stale >= self.patience


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, score):
        if self._start is None:
            self._start = time.monotonic()
        return time.monotonic() - self._start > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if the score explodes past a bound."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score):
        return score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, score):
        return math.isnan(score) or math.isinf(score)
