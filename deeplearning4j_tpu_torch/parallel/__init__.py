"""Parallel training and inference (counterpart of
deeplearning4j_tpu/parallel/), on one process and one card: ParallelInference
(with InferenceMode), ModelServer and ModelClient, TrainingMaster and
ParallelWrapper. The mesh, LocalStepTrainer,
StaleGradientTrainer, ring attention and the DCN model wait (ROADMAP
queue 9)."""

from deeplearning4j_tpu_torch.parallel.inference import (  # noqa: F401
    InferenceMode,
    ParallelInference,
)
from deeplearning4j_tpu_torch.parallel.serving import (  # noqa: F401
    ModelClient,
    ModelServer,
)
from deeplearning4j_tpu_torch.parallel.training_master import (  # noqa: F401
    TrainingMaster,
)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper  # noqa: F401
