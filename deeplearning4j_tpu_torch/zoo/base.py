"""ZooModel base (port of `deeplearning4j_tpu/zoo/base.py`): `conf()`
builds the configuration, `init(device)` builds and seeds the network,
`init_pretrained(kind, path=..., device=...)` loads weights (an explicit
file, the model's cache file, or the catalog's download, Adler32-checked;
`zoo/pretrained.py`)."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Type

ZOO_REGISTRY: Dict[str, Type] = {}


def register_zoo(cls):
    ZOO_REGISTRY[cls.__name__.lower()] = cls
    return cls


class ZooModel:
    """Base: subclasses define conf()."""

    name: str = "zoomodel"
    num_classes: int = 1000
    input_shape: Tuple[int, ...] = (224, 224, 3)

    def __init__(self, num_classes: Optional[int] = None,
                 input_shape: Optional[Tuple[int, ...]] = None,
                 seed: int = 123, **kw):
        if num_classes is not None:
            self.num_classes = num_classes
        if input_shape is not None:
            self.input_shape = tuple(input_shape)
        self.seed = seed
        self.kw = kw

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """Build + seed the network on `device` (CUDA by default): a
        MultiLayerNetwork or, for a graph configuration, a
        ComputationGraph."""
        from deeplearning4j_tpu_torch.models import (
            ComputationGraph, MultiLayerNetwork,
        )
        from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration

        conf = self.conf()
        if isinstance(conf, MultiLayerConfiguration):
            return MultiLayerNetwork(conf, device=device).init()
        return ComputationGraph(conf, device=device).init()

    def pretrained_path(self, kind: str = "imagenet") -> str:
        """Kind-specific cache location (a kind-less name would let a
        cached imagenet file satisfy a cifar10 request)."""
        from deeplearning4j_tpu_torch.data.datasets import data_dir

        return os.path.join(data_dir(), "zoo",
                            f"{type(self).__name__.lower()}_{kind}.zip")

    def pretrained_available(self, kind: str = "imagenet") -> bool:
        """Reference: `ZooModel.pretrainedAvailable`."""
        from deeplearning4j_tpu_torch.zoo.pretrained import PRETRAINED_CATALOG

        return (type(self).__name__, kind) in PRETRAINED_CATALOG

    def init_pretrained(self, kind: str = "imagenet", *,
                        path: Optional[str] = None, device=None):
        """Reference: `ZooModel.initPretrained():40-75` — resolve weights
        (explicit path → model-named cache file → catalog fetch with
        Adler32 verification) and load any supported format (native zip,
        DL4J zip, Keras .h5) onto `device` (CUDA by default)."""
        from deeplearning4j_tpu_torch.zoo.pretrained import (
            fetch_pretrained, load_pretrained,
        )

        if path is None:
            local = self.pretrained_path(kind)
            if os.path.exists(local):
                path = local
            else:
                path = fetch_pretrained(type(self).__name__, kind)
        return load_pretrained(path, device=device)
