"""ImageNet class labels + prediction decoding (a copy of
`deeplearning4j_tpu/zoo/imagenet.py`, numpy only).

Reference parity: `zoo/util/imagenet/ImageNetLabels.java` — loads the
1000-class index JSON (the reference fetches
`http://blob.deeplearning4j.org/utils/imagenet_class_index.json`, the
same `{"0": ["n01440764", "tench"], ...}` file Keras publishes) and
renders top-k prediction strings (`decodePredictions`).

Zero-egress behavior: resolution order is explicit path → cached file →
download; if all fail, deterministic placeholder labels ("class_i") are
used and flagged via `.synthetic` — the same honest-fallback policy as
`data/datasets.py`.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

JSON_URL = "http://blob.deeplearning4j.org/utils/imagenet_class_index.json"
_FILENAME = "imagenet_class_index.json"


class ImageNetLabels:
    """Reference: `ImageNetLabels.java` (getLabel / decodePredictions)."""

    def __init__(self, path: Optional[str] = None, *,
                 allow_download: bool = True):
        self.synthetic = False
        data = self._load(path, allow_download)
        if data is None:
            self.synthetic = True
            self._wnids = [f"n{i:08d}" for i in range(1000)]
            self._labels = [f"class_{i}" for i in range(1000)]
        else:
            n = len(data)
            self._wnids = [data[str(i)][0] for i in range(n)]
            self._labels = [data[str(i)][1] for i in range(n)]

    def _load(self, path, allow_download):
        from deeplearning4j_tpu_torch.zoo.pretrained import (
            _download, cache_dir,
        )

        candidates = []
        if path:
            candidates.append(path)
        cached = os.path.join(cache_dir(), _FILENAME)
        candidates.append(cached)
        for p in candidates:
            if os.path.exists(p):
                with open(p) as f:
                    return json.load(f)
        if allow_download:
            try:
                _download(JSON_URL, cached)
                with open(cached) as f:
                    return json.load(f)
            except Exception:
                if os.path.exists(cached):
                    os.remove(cached)
        return None

    def __len__(self) -> int:
        return len(self._labels)

    def get_label(self, idx: int) -> str:
        """Reference: `ImageNetLabels.getLabel(int)`."""
        return self._labels[idx]

    def wnid(self, idx: int) -> str:
        return self._wnids[idx]

    def decode_predictions(self, predictions, top: int = 5
                           ) -> List[List[Tuple[str, str, float]]]:
        """[batch, 1000] probabilities → per-example top-k
        (wnid, label, probability). Reference:
        `ImageNetLabels.decodePredictions(INDArray)`."""
        if hasattr(predictions, "detach"):     # a tensor, on any device
            predictions = predictions.detach().float().cpu().numpy()
        p = np.asarray(predictions)
        if p.ndim == 1:
            p = p[None]
        out = []
        for row in p:
            order = np.argsort(-row)[:top]
            out.append([(self._wnids[i], self._labels[i], float(row[i]))
                        for i in order])
        return out
