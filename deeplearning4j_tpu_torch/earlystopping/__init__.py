"""Early stopping (counterpart of deeplearning4j_tpu/earlystopping/)."""

from deeplearning4j_tpu_torch.earlystopping.config import (  # noqa: F401
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
)
from deeplearning4j_tpu_torch.earlystopping.termination import (  # noqa: F401
    BestScoreEpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_tpu_torch.earlystopping.saver import (  # noqa: F401
    InMemoryModelSaver,
    LocalFileGraphSaver,
    LocalFileModelSaver,
)
from deeplearning4j_tpu_torch.earlystopping.trainer import (  # noqa: F401
    EarlyStoppingTrainer,
)
from deeplearning4j_tpu_torch.earlystopping.score_calc import (  # noqa: F401
    DataSetLossCalculator,
)
from deeplearning4j_tpu_torch.earlystopping.parallel_trainer import (  # noqa: F401
    EarlyStoppingParallelTrainer,
)
