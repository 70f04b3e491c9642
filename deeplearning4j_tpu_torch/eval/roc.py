"""ROC / AUC evaluation (port of `deeplearning4j_tpu/eval/roc.py`, numpy
only).

Reference parity: `eval/ROC.java` (369 LoC, thresholded), `ROCBinary`,
`ROCMultiClass`. The reference accumulates threshold buckets; here we keep
exact scores (host memory is ample for eval-sized data) and compute exact AUC
by rank statistics, with `threshold_steps` bucketing available for parity.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _auc_from_scores(pos: np.ndarray, neg: np.ndarray) -> float:
    """Exact AUROC via Mann-Whitney U."""
    if len(pos) == 0 or len(neg) == 0:
        return 0.0
    all_ = np.concatenate([pos, neg])
    # average ranks with tie handling
    order = np.argsort(all_)
    sorted_vals = all_[order]
    avg_ranks = np.empty(len(all_), dtype=np.float64)
    i = 0
    while i < len(sorted_vals):
        j = i
        while j + 1 < len(sorted_vals) and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        avg = (i + j) / 2.0 + 1
        avg_ranks[order[i:j + 1]] = avg
        i = j + 1
    r_pos = avg_ranks[: len(pos)].sum()  # first len(pos) entries are positives
    n1, n2 = len(pos), len(neg)
    u = r_pos - n1 * (n1 + 1) / 2.0
    return float(u / (n1 * n2))


class ROC:
    """Binary ROC (positive class = column 1 of 2-col labels, or 1-col 0/1).
    Reference: `eval/ROC.java`."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 2 and labels.shape[-1] == 2:
            y = labels[:, 1]
            s = predictions[:, 1]
        else:
            y = labels.reshape(-1)
            s = predictions.reshape(-1)
        self._labels.append(y)
        self._scores.append(s)

    def calculate_auc(self) -> float:
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        return _auc_from_scores(s[y > 0.5], s[y <= 0.5])

    def get_roc_curve(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (thresholds, fpr, tpr)."""
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        steps = self.threshold_steps or 100
        thresholds = np.linspace(0, 1, steps + 1)
        P = max((y > 0.5).sum(), 1)
        N = max((y <= 0.5).sum(), 1)
        tpr = np.array([((s >= t) & (y > 0.5)).sum() / P for t in thresholds])
        fpr = np.array([((s >= t) & (y <= 0.5)).sum() / N for t in thresholds])
        return thresholds, fpr, tpr


class ROCBinary:
    """Per-output independent binary ROC. Reference: `eval/ROCBinary.java`."""

    def __init__(self):
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        n = labels.shape[-1]
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(n)]
        for c in range(n):
            self._rocs[c].eval(labels[:, c], predictions[:, c])

    def calculate_auc(self, col: int) -> float:
        return self._rocs[col].calculate_auc()

    def average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))


class ROCMultiClass:
    """One-vs-all ROC per class. Reference: `eval/ROCMultiClass.java`."""

    def __init__(self):
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        n = labels.shape[-1]
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(n)]
        for c in range(n):
            self._rocs[c].eval(labels[:, c], predictions[:, c])

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))
