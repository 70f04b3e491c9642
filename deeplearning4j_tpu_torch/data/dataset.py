"""DataSet containers — port of `deeplearning4j_tpu/data/dataset.py`:
`DataSet` (features, labels, features mask, labels mask; the unit every
iterator yields and `fit` consumes) and `MultiDataSet` (lists of each,
one entry per network input or output of a `ComputationGraph`). Arrays
are host numpy until the fit loop moves a batch to the net's device; a
batch that was moved holds tensors."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional

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

    def save(self, path) -> str:
        """One .npz in the JAX package's layout (arrays `features`,
        `labels`, `features_mask`, `labels_mask`, each only where
        present); returns the path written (".npz" appended if
        missing)."""
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"
        arrays = {"features": np.asarray(self.features)}
        for k in ("labels", "features_mask", "labels_mask"):
            v = getattr(self, k)
            if v is not None:
                arrays[k] = np.asarray(v)
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        return path

    @staticmethod
    def load(path) -> "DataSet":
        with np.load(os.fspath(path)) as blob:
            def get(k):
                return blob[k] if k in blob.files else None
            return DataSet(blob["features"], get("labels"),
                           get("features_mask"), get("labels_mask"))


@dataclasses.dataclass
class MultiDataSet:
    """Multi-input/multi-output container (reference: ND4J
    MultiDataSet): features and labels matched to a graph's network
    inputs and outputs by position; a mask list may hold None for an
    input or output without a mask."""

    features: List[Any]
    labels: List[Any]
    features_masks: Optional[List[Optional[Any]]] = None
    labels_masks: Optional[List[Optional[Any]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    def save(self, path) -> str:
        """One .npz, in the JAX package's layout: arrays keyed
        f<i>/l<i>/fm<i>/lm<i>, each mask only where present. Returns the
        path written (".npz" appended if missing)."""
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"
        arrays = {}
        for i, f in enumerate(self.features):
            arrays[f"f{i}"] = np.asarray(f)
        for i, l in enumerate(self.labels):
            arrays[f"l{i}"] = np.asarray(l)
        for key, group in (("fm", self.features_masks),
                           ("lm", self.labels_masks)):
            for i, m in enumerate(group or []):
                if m is not None:
                    arrays[f"{key}{i}"] = np.asarray(m)
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        return path

    @staticmethod
    def load(path) -> "MultiDataSet":
        with np.load(os.fspath(path)) as blob:
            data = {k: blob[k] for k in blob.files}
        nf = sum(1 for k in data if k.startswith("f")
                 and not k.startswith("fm"))
        nl = sum(1 for k in data if k.startswith("l")
                 and not k.startswith("lm"))

        def group(prefix, n):
            out = [data.get(f"{prefix}{i}") for i in range(n)]
            return out if any(m is not None for m in out) else None

        return MultiDataSet([data[f"f{i}"] for i in range(nf)],
                            [data[f"l{i}"] for i in range(nl)],
                            group("fm", nf), group("lm", nl))
