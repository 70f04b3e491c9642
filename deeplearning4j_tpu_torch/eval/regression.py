"""Regression evaluation (port of `deeplearning4j_tpu/eval/regression.py`,
numpy only).

Reference parity: `eval/RegressionEvaluation.java` — per-column MSE, MAE,
RMSE, RSE, correlation, R².
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, num_columns: Optional[int] = None):
        self.n = 0
        self.num_columns = num_columns
        self._sum_sq_err = None
        self._sum_abs_err = None
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_pred_sq = None
        self._sum_label_pred = None

    def _ensure(self, c: int):
        if self._sum_sq_err is None:
            self.num_columns = self.num_columns or c
            z = lambda: np.zeros(self.num_columns)
            self._sum_sq_err = z()
            self._sum_abs_err = z()
            self._sum_label = z()
            self._sum_label_sq = z()
            self._sum_pred = z()
            self._sum_pred_sq = z()
            self._sum_label_pred = z()

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, dtype=np.float64)
        predictions = np.asarray(predictions, dtype=np.float64)
        if labels.ndim == 3:
            B, T, C = labels.shape
            labels = labels.reshape(B * T, C)
            predictions = predictions.reshape(B * T, C)
            if mask is not None:
                m = np.asarray(mask).reshape(B * T) > 0
                labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        err = predictions - labels
        self.n += labels.shape[0]
        self._sum_sq_err += (err**2).sum(0)
        self._sum_abs_err += np.abs(err).sum(0)
        self._sum_label += labels.sum(0)
        self._sum_label_sq += (labels**2).sum(0)
        self._sum_pred += predictions.sum(0)
        self._sum_pred_sq += (predictions**2).sum(0)
        self._sum_label_pred += (labels * predictions).sum(0)

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_sq_err[col] / self.n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs_err[col] / self.n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self._sum_sq_err[col] / self.n))

    def correlation_r2(self, col: int) -> float:
        """Pearson correlation between labels and predictions for a column."""
        n = self.n
        num = self._sum_label_pred[col] - self._sum_label[col] * self._sum_pred[col] / n
        den_l = self._sum_label_sq[col] - self._sum_label[col] ** 2 / n
        den_p = self._sum_pred_sq[col] - self._sum_pred[col] ** 2 / n
        den = np.sqrt(den_l * den_p)
        return float(num / den) if den else 0.0

    def average_mean_squared_error(self) -> float:
        return float(self._sum_sq_err.mean() / self.n)

    def average_mean_absolute_error(self) -> float:
        return float(self._sum_abs_err.mean() / self.n)

    def stats(self) -> str:
        cols = range(self.num_columns)
        lines = ["Column    MSE            MAE            RMSE           Corr"]
        for c in cols:
            lines.append(
                f"col_{c:<5} {self.mean_squared_error(c):<14.6f} "
                f"{self.mean_absolute_error(c):<14.6f} "
                f"{self.root_mean_squared_error(c):<14.6f} "
                f"{self.correlation_r2(c):<14.6f}"
            )
        return "\n".join(lines)
