"""Evaluation metrics (port of `deeplearning4j_tpu/eval/`: numpy only,
copied, not imported).

Reference parity: `eval/` in deeplearning4j-nn — Evaluation (confusion
matrix / precision / recall / F1), EvaluationBinary, RegressionEvaluation,
ROC family. Metrics accumulate batch-wise on host numpy (tiny data), matching
the reference's streaming eval design.
"""

from deeplearning4j_tpu_torch.eval.evaluation import Evaluation, ConfusionMatrix
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass
from deeplearning4j_tpu_torch.eval.binary import EvaluationBinary
from deeplearning4j_tpu_torch.eval.meta import Prediction, RecordMetaData

__all__ = [
    "Evaluation", "ConfusionMatrix", "RegressionEvaluation", "ROC",
    "ROCBinary", "ROCMultiClass", "EvaluationBinary",
    "Prediction", "RecordMetaData",
]
