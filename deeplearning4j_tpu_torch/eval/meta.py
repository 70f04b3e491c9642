"""Per-example evaluation metadata (port of `deeplearning4j_tpu/eval/meta.py`).

Reference parity: `eval/meta/` (`Prediction.java`) + the RecordMetaData
plumbing (`datasets/datavec/RecordReaderDataSetIterator` carries
RecordMetaData through to `Evaluation.eval(labels, out, meta)`), so an
evaluation can answer WHICH examples were misclassified, not just how
many.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class RecordMetaData:
    """Where an example came from. Reference: datavec `RecordMetaData`
    (getLocation/getURI) — here source + location (e.g. file path + line
    or array index)."""

    source: str
    location: Any = None

    def __str__(self):
        return (f"{self.source}[{self.location}]"
                if self.location is not None else self.source)


@dataclasses.dataclass(frozen=True)
class Prediction:
    """One example's outcome. Reference: `eval/meta/Prediction.java`
    (actual/predicted class + record metadata)."""

    actual: int
    predicted: int
    record_meta: Optional[RecordMetaData] = None

    def __str__(self):
        return (f"actual={self.actual}, predicted={self.predicted}, "
                f"meta={self.record_meta}")
