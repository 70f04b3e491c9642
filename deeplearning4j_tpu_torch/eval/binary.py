"""Per-output binary evaluation (multi-label); port of
`deeplearning4j_tpu/eval/binary.py`, numpy only.

Reference parity: `eval/EvaluationBinary.java` — independent binary metrics
per output column at threshold 0.5.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class EvaluationBinary:
    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = None
        self.fp = None
        self.tn = None
        self.fn = None

    def _ensure(self, n: int):
        if self.tp is None:
            self.tp = np.zeros(n, dtype=np.int64)
            self.fp = np.zeros(n, dtype=np.int64)
            self.tn = np.zeros(n, dtype=np.int64)
            self.fn = np.zeros(n, dtype=np.int64)

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels) > 0.5
        pred = np.asarray(predictions) >= self.threshold
        if labels.ndim == 3:
            B, T, C = labels.shape
            labels = labels.reshape(B * T, C)
            pred = pred.reshape(B * T, C)
            if mask is not None:
                m = np.asarray(mask).reshape(B * T) > 0
                labels, pred = labels[m], pred[m]
        self._ensure(labels.shape[-1])
        self.tp += (labels & pred).sum(0)
        self.fp += (~labels & pred).sum(0)
        self.tn += (~labels & ~pred).sum(0)
        self.fn += (labels & ~pred).sum(0)

    def accuracy(self, col: int) -> float:
        total = self.tp[col] + self.fp[col] + self.tn[col] + self.fn[col]
        return float((self.tp[col] + self.tn[col]) / total) if total else 0.0

    def precision(self, col: int) -> float:
        d = self.tp[col] + self.fp[col]
        return float(self.tp[col] / d) if d else 0.0

    def recall(self, col: int) -> float:
        d = self.tp[col] + self.fn[col]
        return float(self.tp[col] / d) if d else 0.0

    def f1(self, col: int) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def stats(self) -> str:
        n = len(self.tp)
        lines = ["Label   Acc      Precision Recall   F1"]
        for c in range(n):
            lines.append(
                f"{c:<7} {self.accuracy(c):<8.4f} {self.precision(c):<9.4f} "
                f"{self.recall(c):<8.4f} {self.f1(c):<8.4f}"
            )
        return "\n".join(lines)
