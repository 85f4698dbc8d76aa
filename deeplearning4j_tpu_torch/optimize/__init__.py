"""Training listeners (counterpart of deeplearning4j_tpu/optimize/)."""

from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CheckpointListener,
    CollectScoresIterationListener,
    EvaluativeListener,
    InvocationType,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ProfilerListener,
    ScoreIterationListener,
    SleepyTrainingListener,
    TimeIterationListener,
)
