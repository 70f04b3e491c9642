"""Shared builders of the A4 parity tests (`test_torch_lockstep.py`,
`test_torch_beam.py`, `test_torch_checkpointing.py`): a JAX net and the
port's twin from the JAX configuration's JSON with the JAX weights
carried across (`params_from_numpy`), as a `MultiLayerNetwork` or as a
chain `ComputationGraph` of the same layers (vertex names = the layer
names, so one params tree fits both runtimes). Float64 on both sides,
so a greedy argmax never meets a float32 near-tie."""

import dataclasses

import jax
import numpy as np

from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.zoo.models import TextGenerationLSTM as JaxTGL
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.models import (
    ComputationGraph, MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration

# the two example flows' zoo configurations, cut to tiny widths:
# examples/transformer_text_generation.py (learned positions) and
# examples/modern_llm_decode.py (RoPE, RMSNorm, SwiGLU, 2 KV heads)
CONFIGS = {
    "text_generation": dict(d_model=32, num_heads=4, num_blocks=2),
    "modern_llm": dict(d_model=32, num_heads=4, num_kv_heads=2,
                       num_blocks=2, pos_encoding="rope", norm="rms",
                       ffn_activation="swiglu", max_decode=24),
    "ring": dict(d_model=16, num_heads=4, num_kv_heads=2, num_blocks=2,
                 pos_encoding="rope", norm="rms", ffn_activation="swiglu",
                 window=4, rolling_cache=True),
}
RUNTIMES = ("multilayer", "graph")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tgt_conf(config: str, T: int = 12, vocab: int = 11, **kw):
    """A JAX zoo transformer configuration in float64."""
    conf = JaxTGT(input_shape=(T, 1), num_classes=vocab,
                  **{**CONFIGS[config], **kw}).conf()
    return dataclasses.replace(conf, dtype="float64")


def tgl_conf(T: int = 8, vocab: int = 11, hidden: int = 8):
    """The zoo's TextGenerationLSTM, narrowed, in float64."""
    conf = JaxTGL(num_classes=vocab, input_shape=(T, vocab)).conf()
    layers = tuple(dataclasses.replace(l, n_out=hidden, n_in=(
        vocab if i == 0 else hidden)) if i < 2 else
        dataclasses.replace(l, n_in=hidden)
        for i, l in enumerate(conf.layers))
    return dataclasses.replace(conf, layers=layers, dtype="float64")


def chain_graph_conf(seq_conf):
    """The layers of a JAX sequential configuration as a chain graph of
    vertices named after them."""
    g = (JaxNNC.builder().seed(seq_conf.seed).updater(seq_conf.updater)
         .graph_builder().add_inputs("in")
         .set_input_types(seq_conf.input_type))
    prev = "in"
    for layer in seq_conf.layers:
        g.add_layer(layer.name, layer, prev)
        prev = layer.name
    g.set_outputs(prev)
    return dataclasses.replace(
        g.build(), dtype=seq_conf.dtype,
        gradient_checkpointing=seq_conf.gradient_checkpointing)


def pair(jconf, runtime: str = "multilayer"):
    """(JAX net, the port's net on the CPU), the same weights."""
    if runtime == "graph":
        jconf = chain_graph_conf(jconf)
        jnet = JaxGraph(jconf).init()
        pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
    else:
        jnet = JaxNet(jconf).init()
        pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, np_tree(jnet.params_tree))
    return jnet, pnet


def port_twin(jnet, runtime: str = "multilayer", **conf_changes):
    """Another port net of `jnet`'s configuration (changed by
    `conf_changes`) with `jnet`'s current weights."""
    conf = jnet.conf
    if runtime == "graph":
        pconf = ComputationGraphConfiguration.from_json(conf.to_json())
        cls = ComputationGraph
    else:
        pconf = MultiLayerConfiguration.from_json(conf.to_json())
        cls = MultiLayerNetwork
    pnet = cls(dataclasses.replace(pconf, **conf_changes),
               device="cpu").init()
    params_from_numpy(pnet, np_tree(jnet.params_tree))
    return pnet
