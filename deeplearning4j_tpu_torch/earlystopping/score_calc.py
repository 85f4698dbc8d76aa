"""Score calculators (parity: earlystopping/scorecalc/
DataSetLossCalculator.java).

Counterpart of deeplearning4j_tpu/earlystopping/score_calc.py."""

from __future__ import annotations


class DataSetLossCalculator:
    """Average loss over a held-out iterator."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total = 0.0
        count = 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        for batch in self.iterator:
            s = net.score(batch)
            n = (batch.num_examples() if hasattr(batch, "num_examples")
                 else len(batch[0]))
            total += s * n
            count += n
        if count == 0:
            raise ValueError("empty score iterator")
        return total / count if self.average else total
