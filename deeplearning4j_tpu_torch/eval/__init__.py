"""Evaluation (counterpart of deeplearning4j_tpu/eval/): classification
(Evaluation, ConfusionMatrix), regression, multi-label binary, ROC
(binary, per column, one-vs-all), calibration and the HTML exports."""

from deeplearning4j_tpu_torch.eval.evaluation import Evaluation, ConfusionMatrix  # noqa: F401
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation  # noqa: F401
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass  # noqa: F401
from deeplearning4j_tpu_torch.eval.binary import EvaluationBinary  # noqa: F401
from deeplearning4j_tpu_torch.eval.calibration import EvaluationCalibration  # noqa: F401
from deeplearning4j_tpu_torch.eval.tools import (  # noqa: F401
    export_evaluation_calibration_to_html,
    export_roc_charts_to_html,
)
