"""Transfer learning: freeze, replace, append layers of a trained network
(port of `deeplearning4j_tpu/models/transfer.py`).

Reference parity: `nn/transferlearning/TransferLearning.java:35` (Builder
`:37`, GraphBuilder `:428`), `FineTuneConfiguration.java`,
`TransferLearningHelper.java` (featurize-and-cache frozen prefix).

Configs are immutable data, so transfer learning is config surgery plus
parameter copying. The JAX package shares its (immutable) arrays between
the source and the new network; here the kept layers' tensors are
copied into the new network's own, so training one never moves the
other. A frozen layer gets the NoOp updater: its tensors are never
written. The helper's tail network, by contrast, shares the full
network's tensors, so its updates land in the full network in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.special import FrozenLayer
from deeplearning4j_tpu_torch.optim.updaters import resolve_updater


@dataclasses.dataclass
class FineTuneConfiguration:
    """Global overrides applied to every retained layer. Reference:
    `nn/transferlearning/FineTuneConfiguration.java`."""

    updater: Any = None
    learning_rate: Any = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    seed: Optional[int] = None

    def apply_to(self, layer: Layer) -> Layer:
        upd = {}
        if self.updater is not None:
            upd["updater"] = resolve_updater(self.updater)
        if self.learning_rate is not None:
            upd["learning_rate"] = self.learning_rate
        if self.l1 is not None:
            upd["l1"] = self.l1
        if self.l2 is not None:
            upd["l2"] = self.l2
        if self.dropout is not None:
            upd["dropout"] = self.dropout
        return dataclasses.replace(layer, **upd) if upd else layer


class TransferLearning:
    """Entry: `TransferLearning.builder(net)`. Reference: Builder `:37`."""

    @staticmethod
    def builder(net: MultiLayerNetwork) -> "TransferLearningBuilder":
        return TransferLearningBuilder(net)


class TransferLearningBuilder:
    def __init__(self, net: MultiLayerNetwork):
        if net.params_tree is None:
            raise RuntimeError("Source network must be initialized")
        self._net = net
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._remove_from: Optional[int] = None
        self._appended: List[Layer] = []
        self._replacements: Dict[int, Layer] = {}

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, layer_index: int):
        """Freeze layers [0..layer_index] inclusive. Reference:
        `setFeatureExtractor`."""
        self._freeze_until = layer_index
        return self

    def remove_layers_from_output(self, count: int):
        """Drop the last `count` layers. Reference:
        `removeLayersFromOutput`."""
        self._remove_from = len(self._net.layers) - count
        return self

    def remove_output_layer_and_below(self, n: int = 1):
        return self.remove_layers_from_output(n)

    def n_out_replace(self, layer_index: int, n_out: int,
                      weight_init: Optional[str] = None):
        """Replace a layer's output width (params re-initialized; next
        layer's n_in is rewired). Reference: `nOutReplace`."""
        old = self._net.layers[layer_index]
        new = dataclasses.replace(
            old, n_out=n_out,
            weight_init=weight_init or old.weight_init)
        self._replacements[layer_index] = new
        nxt = layer_index + 1
        if nxt < len(self._net.layers) and nxt not in self._replacements:
            nxt_layer = self._net.layers[nxt]
            if hasattr(nxt_layer, "n_in"):
                self._replacements[nxt] = dataclasses.replace(
                    nxt_layer, n_in=n_out)
        return self

    def add_layer(self, layer: Layer):
        """Append after the retained stack. Reference: `addLayer`."""
        self._appended.append(layer)
        return self

    def build(self) -> MultiLayerNetwork:
        src = self._net
        conf = src.conf
        n_keep = (self._remove_from if self._remove_from is not None
                  else len(conf.layers))
        new_layers: List[Layer] = []
        reinit: set = set()

        for i in range(n_keep):
            layer = conf.layers[i]
            if i in self._replacements:
                layer = self._replacements[i]
                reinit.add(i)
            if self._fine_tune is not None:
                layer = self._fine_tune.apply_to(layer)
            if self._freeze_until is not None and i <= self._freeze_until:
                if not isinstance(layer, FrozenLayer):
                    layer = dataclasses.replace(layer, frozen=True)
            new_layers.append(layer)

        base_idx = len(new_layers)
        for j, layer in enumerate(self._appended):
            if self._fine_tune is not None:
                layer = self._fine_tune.apply_to(layer)
            if layer.name is None:
                layer = dataclasses.replace(
                    layer,
                    name=f"layer{base_idx + j}_{type(layer).__name__.lower()}")
            new_layers.append(layer)
            reinit.add(base_idx + j)

        # Re-run shape inference through the new stack.
        cur = conf.input_type
        wired: List[Layer] = []
        for i, layer in enumerate(new_layers):
            if cur is not None:
                if i in conf.preprocessors and i < n_keep:
                    cur = conf.preprocessors[i].output_type(cur)
                layer = layer.infer_n_in(cur)
                try:
                    cur = layer.output_type(cur)
                except Exception:
                    cur = None
            wired.append(layer)

        new_conf = dataclasses.replace(
            conf,
            layers=tuple(wired),
            preprocessors={k: v for k, v in conf.preprocessors.items()
                           if k < n_keep},
            seed=(self._fine_tune.seed if self._fine_tune and
                  self._fine_tune.seed is not None else conf.seed),
        )
        new_net = MultiLayerNetwork(new_conf, device=src.device).init()

        # Copy params/state for retained, non-reinitialized layers.
        for i, layer in enumerate(wired):
            if i in reinit or i >= n_keep:
                continue
            src_name = conf.layers[i].name
            dst_name = layer.name
            if src_name in src.params_tree:
                _copy_into(new_net.params_tree[dst_name],
                           src.params_tree[src_name])
            if src_name in src.state_tree and src.state_tree[src_name]:
                _copy_into(new_net.state_tree[dst_name],
                           src.state_tree[src_name])
        return new_net


@torch.no_grad()
def _copy_into(dst, src) -> None:
    """Copy a layer's tensors into the new network's tensors of the same
    keys (their own storage, device and dtype)."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


class TransferLearningHelper:
    """Featurize through the frozen prefix once, then train only the
    unfrozen tail on cached features. Reference:
    `nn/transferlearning/TransferLearningHelper.java` (426 LoC)."""

    def __init__(self, net: MultiLayerNetwork):
        self.net = net
        self.split = 0
        for i, layer in enumerate(net.layers):
            if layer.frozen or isinstance(layer, FrozenLayer):
                self.split = i + 1
        if self.split == 0:
            raise ValueError("No frozen layers — nothing to featurize")

    @torch.no_grad()
    def featurize(self, features) -> np.ndarray:
        """Run inputs through the frozen prefix (eval mode); the features
        come back to the host."""
        x = torch.as_tensor(np.asarray(features), dtype=self.net.dtype,
                            device=self.net.device)
        x, _ = self.net._forward(self.net.params_tree, x, stop=self.split)
        return x.float().cpu().numpy() if x.dtype == torch.bfloat16 \
            else x.cpu().numpy()

    def unfrozen_network(self) -> MultiLayerNetwork:
        """A standalone net of the unfrozen tail sharing param arrays."""
        conf = self.net.conf
        tail = conf.layers[self.split:]
        tail_pp = {
            k - self.split: v for k, v in conf.preprocessors.items()
            if k >= self.split
        }
        new_conf = dataclasses.replace(
            conf, layers=tuple(tail), preprocessors=tail_pp, input_type=None)
        tail_net = MultiLayerNetwork(new_conf, device=self.net.device).init()
        for layer in tail:
            tail_net.params_tree[layer.name] = self.net.params_tree[layer.name]
            if self.net.state_tree.get(layer.name):
                tail_net.state_tree[layer.name] = \
                    self.net.state_tree[layer.name]
        return tail_net

    def fit_featurized(self, features, labels, **kw) -> MultiLayerNetwork:
        tail = self.unfrozen_network()
        tail.fit(self.featurize(features), labels, **kw)
        # copy trained tail params back into the full network
        for layer in tail.layers:
            self.net.params_tree[layer.name] = tail.params_tree[layer.name]
        return self.net
