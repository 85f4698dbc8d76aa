"""Evaluation (counterpart of deeplearning4j_tpu/eval/). Only the
classification Evaluation and its ConfusionMatrix are ported; the rest of
eval/ waits (ROADMAP queue 10)."""

from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    ConfusionMatrix,
    Evaluation,
)
