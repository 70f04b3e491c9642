"""DataSet container — port of `deeplearning4j_tpu/data/dataset.py`
(features, labels, features mask, labels mask; the unit every iterator
yields and `fit` consumes). Arrays are host numpy until the fit loop
moves a batch to the net's device; a batch that was moved holds
tensors."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: Any
    labels: Optional[Any] = None
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        pick = lambda a: None if a is None else a[idx]  # noqa: E731
        return DataSet(self.features[idx], pick(self.labels),
                       pick(self.features_mask), pick(self.labels_mask))
