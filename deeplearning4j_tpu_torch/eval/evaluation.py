"""Classification evaluation: confusion matrix, accuracy, precision/recall/F1
(port of `deeplearning4j_tpu/eval/evaluation.py`, numpy only).

Reference parity: `eval/Evaluation.java:50` (`eval():218`, `stats():414`,
precision/recall/F1, confusion matrix) and `eval/ConfusionMatrix.java`.
Accumulates batch-wise; mask-aware for per-timestep RNN labels (the
reference's time-series eval path).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class ConfusionMatrix:
    """Reference: `eval/ConfusionMatrix.java`."""

    def __init__(self, num_classes: int):
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def actual_total(self, cls: int) -> int:
        return int(self.matrix[cls, :].sum())

    def predicted_total(self, cls: int) -> int:
        return int(self.matrix[:, cls].sum())


class Evaluation:
    """Streaming classification metrics. Reference: `eval/Evaluation.java`."""

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[Sequence[str]] = None):
        self.num_classes = num_classes
        self.label_names = list(labels) if labels else None
        self.confusion: Optional[ConfusionMatrix] = None
        # per-example Prediction records, populated only when record_meta
        # is passed to eval() (reference: eval/meta/, stored when
        # RecordMetaData flows through eval(labels, out, meta))
        self.predictions: list = []

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)
        if n > self.num_classes:
            # grow: a first batch that happened to miss high class indices
            # must not pin the matrix size for the rest of the evaluation
            old = self.confusion.matrix
            grown = np.zeros((n, n), old.dtype)
            grown[:old.shape[0], :old.shape[1]] = old
            self.num_classes = n
            self.confusion.matrix = grown

    def eval(self, labels, predictions, mask=None, record_meta=None):
        """Accumulate a batch. labels/predictions: one-hot or prob arrays
        [batch, n] or [batch, time, n]; integer class labels [batch] also
        accepted. `record_meta`: optional per-example RecordMetaData list
        — enables the per-example accessors (get_prediction_errors, ...).
        Reference: `eval():218` + evalTimeSeries + eval(..., meta)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:  # time series → flatten (with mask)
            if record_meta is not None:
                raise ValueError(
                    "record_meta is not supported with per-timestep (3-D) "
                    "labels — the reference's meta path is per-example")
            B, T, C = labels.shape
            labels = labels.reshape(B * T, C)
            predictions = predictions.reshape(B * T, -1)
            if mask is not None:
                m = np.asarray(mask).reshape(B * T) > 0
                labels, predictions = labels[m], predictions[m]
        elif mask is not None:
            # per-example mask for 2-D/1-D labels (padded batches)
            m = np.asarray(mask).reshape(len(labels)) > 0
            labels, predictions = labels[m], predictions[m]
            if record_meta is not None:
                record_meta = [r for r, keep in zip(record_meta, m) if keep]
        if labels.ndim == 2:
            actual = labels.argmax(axis=-1)
            n = labels.shape[-1]
        else:
            actual = labels.astype(np.int64)
            n = int(predictions.shape[-1])
        pred = predictions.argmax(axis=-1)
        # eval_indices validates record_meta BEFORE mutating, so a caught
        # error leaves the metrics un-double-countable on retry
        self.eval_indices(actual, pred, num_classes=n,
                          record_meta=record_meta)

    def eval_indices(self, actual, predicted,
                     num_classes: Optional[int] = None,
                     record_meta=None) -> None:
        """Accumulate pre-argmaxed class indices — the device-side fast
        path (model.evaluate computes argmax on device and ships only int
        vectors to host)."""
        actual = np.asarray(actual).astype(np.int64)
        predicted = np.asarray(predicted).astype(np.int64)
        if len(actual) == 0:
            if num_classes:  # keep metrics well-defined on empty input
                self._ensure(num_classes)
            return
        n = (num_classes if num_classes is not None
             else int(max(actual.max(), predicted.max())) + 1)
        n = max(n, int(max(actual.max(), predicted.max())) + 1)
        if record_meta is not None and len(record_meta) != len(actual):
            raise ValueError(
                f"record_meta has {len(record_meta)} entries for "
                f"{len(actual)} examples")
        self._ensure(n)
        np.add.at(self.confusion.matrix, (actual, predicted), 1)
        if record_meta is not None:
            from deeplearning4j_tpu_torch.eval.meta import Prediction

            self.predictions.extend(
                Prediction(int(a), int(p), m)
                for a, p, m in zip(actual, predicted, record_meta))

    @staticmethod
    def run_evaluation(evaluator, iterator, output_fn):
        """Feed every batch's outputs into any batch-wise evaluator with an
        `eval(labels, predictions)` method — backs the model-level
        evaluate_regression / evaluate_roc / evaluate_roc_multi_class
        (reference: MultiLayerNetwork.java:2668-2699).

        Masking/time-series normalization happens HERE (flatten [B,T,C] to
        [B·T, C] and drop masked rows, the reference's evalTimeSeries
        path), so evaluators that don't understand masks (ROC family)
        still get only valid examples. MultiDataSet batches evaluate the
        FIRST output (the reference's single-output contract)."""
        for ds in iterator:
            if hasattr(ds, "labels_masks"):   # MultiDataSet
                out = output_fn(*ds.features)
                if isinstance(out, (list, tuple)):
                    out = out[0]
                labels = np.asarray(ds.labels[0])
                mask = (ds.labels_masks[0]
                        if ds.labels_masks else None)
            else:
                out = output_fn(ds.features)
                labels = np.asarray(ds.labels)
                mask = ds.labels_mask
            preds = np.asarray(out)
            if labels.ndim == 3:
                B, T, C = labels.shape
                labels = labels.reshape(B * T, C)
                preds = preds.reshape(B * T, -1)
                if mask is not None:
                    keep = np.asarray(mask).reshape(B * T) > 0
                    labels, preds = labels[keep], preds[keep]
            elif mask is not None:
                keep = np.asarray(mask).reshape(len(labels)) > 0
                labels, preds = labels[keep], preds[keep]
            evaluator.eval(labels, preds)
        return evaluator

    def evaluate_iterator(self, iterator, *, output_fn, predict_indices_fn):
        """Shared batch loop for model.evaluate (MultiLayerNetwork and
        ComputationGraph): device-side argmax fast path for plain
        per-example labels (only int32 indices cross to host via
        `predict_indices_fn(features) -> (indices, head_width)`), full
        softmax through `output_fn` for masked/time-series labels.

        If the iterator collects RecordMetaData (`set_collect_meta_data` —
        `last_meta` set per batch), it flows into per-example Prediction
        records, so `get_prediction_errors()` works straight off
        `model.evaluate(it)` (reference: MultiLayerNetwork.doEvaluation
        passing meta into eval(labels, out, meta))."""
        for ds in iterator:
            labels = np.asarray(ds.labels)
            meta = getattr(iterator, "last_meta", None)
            if labels.ndim == 3 or ds.labels_mask is not None:
                self.eval(labels, np.asarray(output_fn(ds.features)),
                          mask=ds.labels_mask,
                          record_meta=None if labels.ndim == 3 else meta)
                continue
            pred, width = predict_indices_fn(ds.features)
            actual = (labels.argmax(-1) if labels.ndim == 2
                      else labels.astype(np.int64))
            # class count from the one-hot width, else the model head —
            # a batch missing high classes must not shrink the matrix
            n = labels.shape[-1] if labels.ndim == 2 else width
            self.eval_indices(actual, np.asarray(pred), num_classes=n,
                              record_meta=meta)
        return self

    # ---- per-example accessors (reference: eval/meta + Evaluation
    #      getPredictionErrors/getPredictionsByActualClass/...) ----
    def get_prediction_errors(self) -> list:
        """All misclassified examples' Prediction records."""
        return [p for p in self.predictions if p.actual != p.predicted]

    def get_predictions_by_actual_class(self, cls: int) -> list:
        return [p for p in self.predictions if p.actual == cls]

    def get_predictions_by_predicted_class(self, cls: int) -> list:
        return [p for p in self.predictions if p.predicted == cls]

    def get_predictions(self, actual: int, predicted: int) -> list:
        """Prediction records in one confusion cell. Reference:
        `Evaluation.getPredictions(actualClass, predictedClass)`."""
        return [p for p in self.predictions
                if p.actual == actual and p.predicted == predicted]

    def get_top_n_confusions(self, n: int = 5) -> list:
        """Most frequent OFF-diagonal (actual, predicted, count) cells,
        descending — 'what does the model confuse most'. Works off the
        confusion matrix, so it needs no RecordMetaData collection."""
        if self.confusion is None:
            return []
        m = self.confusion.matrix.copy()
        np.fill_diagonal(m, 0)
        pairs = np.argwhere(m > 0)
        order = sorted(pairs.tolist(), key=lambda ij: -m[ij[0], ij[1]])
        return [(int(a), int(p), int(m[a, p])) for a, p in order[:n]]

    # ---- metrics (reference method names) ----
    def _tp(self, c):
        return self.confusion.matrix[c, c]

    def accuracy(self) -> float:
        if self.confusion is None:   # nothing accumulated yet
            return 0.0
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def precision(self, cls: Optional[int] = None,
                  averaging: str = "macro") -> float:
        """Per-class, or averaged: "macro" (mean of per-class values,
        the reference default) or "micro" (global TP/(TP+FP) — equals
        accuracy for single-label multiclass). Reference:
        `eval/EvaluationAveraging.java` + Evaluation.precision."""
        if self.confusion is None:
            return 0.0
        m = self.confusion.matrix
        if cls is not None:
            denom = m[:, cls].sum()
            return float(m[cls, cls] / denom) if denom else 0.0
        if averaging == "micro":   # == accuracy for single-label multiclass
            return self.accuracy()
        if averaging != "macro":
            raise ValueError(f"averaging must be macro|micro, got {averaging!r}")
        vals = [self.precision(c) for c in range(self.num_classes)
                if m[:, c].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None,
               averaging: str = "macro") -> float:
        if self.confusion is None:
            return 0.0
        m = self.confusion.matrix
        if cls is not None:
            denom = m[cls, :].sum()
            return float(m[cls, cls] / denom) if denom else 0.0
        if averaging == "micro":   # == accuracy for single-label multiclass
            return self.accuracy()
        if averaging != "macro":
            raise ValueError(f"averaging must be macro|micro, got {averaging!r}")
        vals = [self.recall(c) for c in range(self.num_classes)
                if m[c, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None,
           averaging: str = "macro") -> float:
        return self.f_beta(1.0, cls, averaging)

    def f_beta(self, beta: float, cls: Optional[int] = None,
               averaging: str = "macro") -> float:
        """Reference: `eval/EvaluationUtils.java` fBeta."""
        p = self.precision(cls, averaging)
        r = self.recall(cls, averaging)
        if p == 0.0 or r == 0.0:
            return 0.0
        b2 = beta * beta
        return float((1 + b2) * p * r / (b2 * p + r))

    def g_measure(self, cls: Optional[int] = None,
                  averaging: str = "macro") -> float:
        """Geometric mean of precision and recall. Reference:
        `eval/EvaluationUtils.java` gMeasure."""
        p = self.precision(cls, averaging)
        r = self.recall(cls, averaging)
        return float(np.sqrt(p * r))

    def false_positive_rate(self, cls: int) -> float:
        m = self.confusion.matrix
        fp = m[:, cls].sum() - m[cls, cls]
        tn = m.sum() - m[cls, :].sum() - m[:, cls].sum() + m[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) else 0.0

    def matthews_correlation(self, cls: int) -> float:
        m = self.confusion.matrix
        tp = m[cls, cls]
        fp = m[:, cls].sum() - tp
        fn = m[cls, :].sum() - tp
        tn = m.sum() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    def stats(self) -> str:
        """Human-readable summary. Reference: `stats():414`."""
        if self.confusion is None:
            return "Evaluation: no examples accumulated"
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes: {self.num_classes}",
            f" Accuracy:  {self.accuracy():.4f}",
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "",
            "=========================Confusion Matrix=========================",
        ]
        m = self.confusion.matrix
        names = self.label_names or [str(i) for i in range(self.num_classes)]
        header = "      " + " ".join(f"{n:>6}" for n in names)
        lines.append(header)
        for i in range(self.num_classes):
            row = " ".join(f"{int(m[i, j]):>6}" for j in range(self.num_classes))
            lines.append(f"{names[i]:>5} {row}")
        return "\n".join(lines)

    def merge(self, other: "Evaluation") -> "Evaluation":
        """Combine evaluations from shards (used by distributed eval;
        reference: Spark-side evaluation aggregation)."""
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(other.num_classes)
        self.confusion.matrix = self.confusion.matrix + other.confusion.matrix
        self.predictions.extend(other.predictions)
        return self
