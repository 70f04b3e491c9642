"""Parameter/batch sharding rules (port of
`deeplearning4j_tpu/parallel/sharding.py`).

A `ShardingRules` maps (layer_name, param_name) → PartitionSpec by
first match over (layer_glob, param_name_glob) patterns, as the JAX
package's. The rules place leaves (`MeshContext`, `shard_params`:
a rank's slice where a rule splits a leaf over the `data` axis), so a
checkpoint's shard bounds follow them as JAX's do; a rule on any other
axis (tensor-parallel, channel-parallel) raises naming ROADMAP A6's
second part, rather than being ignored or replicated. Training under
parameter rules (FSDP) is not ported: `ParallelWrapper` refuses them,
naming A6's second part too.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_MODEL, NamedSharding, P, PartitionSpec,
)

__all__ = ["ShardingRules", "replicate", "batch_sharding", "shard_params",
           "fsdp_rules", "tensor_parallel_rules", "conv_channel_rules",
           "check_rule_axes"]


@dataclasses.dataclass
class ShardingRules:
    """Ordered (layer_glob, param_name_glob) → PartitionSpec rules."""

    rules: List[Tuple[str, str, PartitionSpec]] = dataclasses.field(
        default_factory=list)
    default: PartitionSpec = dataclasses.field(default_factory=P)

    def spec_for(self, layer_name: str, param_name: str) -> PartitionSpec:
        for lg, pg, spec in self.rules:
            if fnmatch.fnmatch(layer_name, lg) and \
                    fnmatch.fnmatch(param_name, pg):
                return PartitionSpec(*spec)
        return PartitionSpec(*self.default)

    def tree_specs(self, params: Dict) -> Dict:
        """PartitionSpec tree matching a {layer: {param: tensor}} tree."""
        def leaf_specs(layer_name, sub, path=""):
            out = {}
            for k, v in sub.items():
                if isinstance(v, dict):
                    out[k] = leaf_specs(layer_name, v, path + k + "/")
                else:
                    out[k] = self.spec_for(layer_name, path + k)
            return out
        return {ln: leaf_specs(ln, sub) for ln, sub in params.items()}

    def axes(self) -> set:
        """Every mesh axis a rule (or the default) names."""
        specs = [s for _, _, s in self.rules] + [self.default]
        return {a for s in specs for a in s if a is not None}


def check_rule_axes(rules: Optional[ShardingRules],
                    batch_axis: str = AXIS_DATA) -> None:
    """Raise naming ROADMAP A6 (its second part) for a rule on an axis
    other than `batch_axis`: the port places leaves by data-axis rules
    only."""
    if rules is None:
        return
    other = sorted(rules.axes() - {batch_axis})
    if other:
        raise NotImplementedError(
            f"sharding rules on the mesh axes {other} (tensor, pipeline or "
            f"expert parallelism) are not ported yet (ROADMAP.md A6, its "
            f"second part); the port places leaves by {batch_axis!r}-axis "
            f"rules only and refuses the rest rather than ignore it")


def replicate(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh, ndim: int, axis: str = AXIS_DATA) -> NamedSharding:
    """Shard the leading (batch) dim over `axis`, replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def shard_params(params, mesh, rules: Optional[ShardingRules] = None,
                 batch_axis: str = AXIS_DATA):
    """This rank's placement of a param tree under the rules: each leaf
    its slice (a copy) where a rule splits it over `batch_axis`, the
    whole tensor where it replicates. With no rules: fully replicated."""
    check_rule_axes(rules, batch_axis)
    specs = rules.tree_specs(params) if rules is not None else None

    def place(x, spec):
        if spec is None or len(spec) > x.ndim:
            return x
        return NamedSharding(mesh, spec).local_slice(x).clone()

    def walk(sub, spec_sub):
        if isinstance(sub, dict):
            return {k: walk(v, None if spec_sub is None else spec_sub[k])
                    for k, v in sub.items()}
        if isinstance(sub, torch.Tensor):
            return place(sub, spec_sub)
        return sub

    return walk(params, specs)


def tensor_parallel_rules(layer_names: List[str],
                          axis: str = AXIS_MODEL) -> ShardingRules:
    """Megatron-style alternating column/row parallel over a sequential
    stack (the JAX package's rules). The port builds them; applying them
    raises naming A6 (`check_rule_axes`)."""
    rules: List[Tuple[str, str, PartitionSpec]] = []
    n = len(layer_names)
    for i, name in enumerate(layer_names):
        if i == n - 1:
            rules.append((name, "*", P()))
            continue
        if i % 2 == 0:
            rules.append((name, "W", P(None, axis)))
            rules.append((name, "RW", P(None, axis)))
            rules.append((name, "b", P(axis)))
        else:
            rules.append((name, "W", P(axis, None)))
            rules.append((name, "RW", P(axis, None)))
            rules.append((name, "b", P()))
    return ShardingRules(rules=rules)


def conv_channel_rules(layer_names: List[str], axis: str = AXIS_MODEL
                       ) -> ShardingRules:
    """Channel-parallel conv stacks: conv kernels split on the output
    channel (HWIO → (None, None, None, model)); the classifier
    replicates. Built as JAX's; applying them raises naming A6."""
    rules: List[Tuple[str, str, PartitionSpec]] = []
    for i, name in enumerate(layer_names):
        if i == len(layer_names) - 1:
            rules.append((name, "*", P()))
        else:
            rules.append((name, "W", P(None, None, None, axis)))
            rules.append((name, "b", P(axis)))
    return ShardingRules(rules=rules)


def fsdp_rules(layer_names: List[str], axis: str = AXIS_DATA) -> ShardingRules:
    """ZeRO/FSDP-style: every W / RW split on its FIRST dim over the data
    axis; its optimizer moments split with it (`MeshContext`). Built as
    JAX's; training under them is not ported (`ParallelWrapper` refuses
    them naming ROADMAP A6, its second part)."""
    return ShardingRules(rules=[("*", "W", P(axis)), ("*", "RW", P(axis))])
