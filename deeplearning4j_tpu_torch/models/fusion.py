"""Graph-level conv+BN fusion (port of `deeplearning4j_tpu/models/fusion.py`).

`fuse_conv_bn(net)` rewrites every eligible conv -> batch-norm pair of a
ComputationGraph into one `FusedConvBNLayer`, whose training forward
takes the batch statistics out of the convolution kernel itself (B7a,
B7b: `ops/conv_fused.py`). Eligible, checked structurally as in JAX:

- a `ConvolutionLayer` with no bias, identity activation, no dilation
  and no dropout, of a fusable shape (`fusable_conv_shape`): 1×1 of any
  stride with zero padding (or "same" mode), or 3×3 stride 1 with
  SAME-equivalent padding;
- whose ONLY consumer is a `BatchNormalization` with learnable gamma and
  beta that consumes nothing else, neither carrying a preprocessor, and
  with the same per-layer training knobs.

The fused vertex keeps the BN vertex's NAME, so every other edge and key
stays; the conv weights, gamma/beta and the running statistics (as
float32) transfer, and the fused pair's updater state starts afresh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.layers.convolution import _pair

_CARRIED = ("l1", "l2", "l1_bias", "l2_bias", "updater", "learning_rate",
            "frozen")


def fusable_conv_shape(kernel, stride, padding, mode) -> bool:
    """Whether a conv of this geometry has a fused conv+BN kernel: the one
    shape predicate of the fusion pass and of the zoo builders."""
    k = _pair(kernel)
    if k == (1, 1):
        # for k = 1 SAME is VALID; other modes need zero explicit padding
        return mode == "same" or _pair(padding) == (0, 0)
    if k == (3, 3):
        if _pair(stride) != (1, 1):
            return False
        return (mode == "same"
                or (_pair(padding) == (1, 1)
                    and mode in ("strict", "truncate")))
    return False


def _eligible_conv(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.layers import ConvolutionLayer

    if type(layer) is not ConvolutionLayer:
        return False
    if _pair(layer.dilation) != (1, 1) or layer.has_bias:
        return False
    if (layer.activation or "identity") != "identity" or layer.dropout:
        return False
    return fusable_conv_shape(layer.kernel, layer.stride, layer.padding,
                              layer.convolution_mode)


def _eligible_bn(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.layers import BatchNormalization

    return (type(layer) is BatchNormalization and not layer.lock_gamma_beta
            and layer.scale and layer.center)


def _copy_tree(tree):
    from deeplearning4j_tpu_torch.optim.updaters import tree_map

    return tree_map(torch.clone, tree)


def fuse_conv_bn(net):
    """A NEW initialized ComputationGraph with the eligible pairs of `net`
    fused (the input is untouched), on `net`'s device; `.fused_pairs` on
    the result lists the (conv, bn) names rewritten."""
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph import LayerVertex, toposort
    from deeplearning4j_tpu_torch.nn.layers import FusedConvBNLayer

    conf = net.conf
    if not hasattr(conf, "vertices"):
        raise TypeError("fuse_conv_bn operates on ComputationGraph models")
    consumers: Dict[str, list] = {}
    for name, ins in conf.vertex_inputs.items():
        for i in ins:
            consumers.setdefault(i, []).append(name)

    pairs = []   # (conv_name, bn_name)
    for cname, v in conf.vertices.items():
        if not isinstance(v, LayerVertex) or not _eligible_conv(v.layer):
            continue
        if v.preprocessor is not None or cname in conf.network_outputs:
            continue
        cons = consumers.get(cname, [])
        if len(cons) != 1:
            continue
        b = conf.vertices[cons[0]]
        if not isinstance(b, LayerVertex) or not _eligible_bn(b.layer):
            continue
        if b.preprocessor is not None or \
                tuple(conf.vertex_inputs[cons[0]]) != (cname,):
            continue
        if not all(getattr(v.layer, k) == getattr(b.layer, k)
                   for k in _CARRIED):
            continue
        pairs.append((cname, cons[0]))

    vertices = dict(conf.vertices)
    vertex_inputs = {k: tuple(v) for k, v in conf.vertex_inputs.items()}
    for conv_name, bn_name in pairs:
        conv = vertices[conv_name].layer
        bn = vertices[bn_name].layer
        fused = FusedConvBNLayer(
            name=bn_name, n_in=conv.n_in, n_out=conv.n_out,
            kernel=_pair(conv.kernel), stride=_pair(conv.stride),
            decay=bn.decay, eps=bn.eps,
            activation=bn.activation or "identity",
            weight_init=conv.weight_init,
            **{k: getattr(conv, k) for k in _CARRIED})
        vertices[bn_name] = dataclasses.replace(vertices[bn_name],
                                                layer=fused)
        vertex_inputs[bn_name] = vertex_inputs[conv_name]
        del vertices[conv_name]
        del vertex_inputs[conv_name]
    new_conf = dataclasses.replace(
        conf, vertices=vertices, vertex_inputs=vertex_inputs,
        topological_order=tuple(toposort(vertex_inputs,
                                         conf.network_inputs)))
    out = ComputationGraph(new_conf, device=net.device).init()

    fused_of = {bn: conv for conv, bn in pairs}
    convs = set(fused_of.values())
    for name, p in net.params_tree.items():
        if name in convs:
            continue
        if name in fused_of:
            out.params_tree[name] = _copy_tree({
                "W": net.params_tree[fused_of[name]]["W"],
                "gamma": p["gamma"], "beta": p["beta"]})
            out.state_tree[name] = {
                k: net.state_tree[name][k].to(torch.float32).clone()
                for k in ("mean", "var")}
            continue
        out.params_tree[name] = _copy_tree(p)
        if name in net.state_tree:
            out.state_tree[name] = _copy_tree(net.state_tree[name])
        if name in net.updater_state:
            # optimizer state carries over for untouched vertices; only
            # a fused pair restarts its moments (its params changed)
            out.updater_state[name] = _copy_tree(net.updater_state[name])
    out.fused_pairs = pairs
    return out
