"""ZooModel base (port of `deeplearning4j_tpu/zoo/base.py`): `conf()`
builds the configuration, `init(device)` builds and seeds the network.
Pretrained weights are not part of the port: nothing is downloaded."""

from __future__ import annotations

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
