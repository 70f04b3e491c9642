"""The CNN / ComputationGraph runtime of the PyTorch port against the JAX
package, on the CPU: every new layer, vertex and preprocessor on the same
seeded inputs and parameters (with XLA's asymmetric SAME padding and
the biased batch variance each checked on its own), the graph
configuration's JSON both ways, the conv+BN fusion pass, ResNet-50's
`output()` on weights and running statistics carried across
(`params_from_numpy`, `state_from_numpy`), unfused and fused, two
Nesterovs train steps of the full fused ResNet-50 at 32x32 in float64
(JAX runs its Pallas kernels in interpret mode: about 60 s on one
worker), and the refusals of what is not ported yet.

Tolerances: layers and vertices within 1e-5 (float32 sums in another
order); ResNet-50's softmax outputs within 1e-5 absolute; the float64
train steps (53 training-mode batch norms over batches of 4: at 1x1 maps
in the last stage a channel's statistics come from four values, which
amplifies float64 rounding to ~1e-9) within 1e-9 relative on losses and
1e-7 of each tensor's largest magnitude on parameters and running
statistics; a semantic difference shows at 1e-3 or more."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn.graph as jgraph
import deeplearning4j_tpu.nn.layers as jlayers
import deeplearning4j_tpu.nn.preprocessors as jpre
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.optim.listeners import (
    CollectScoresIterationListener as JaxScores,
)
from deeplearning4j_tpu.optim.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.zoo import ResNet50 as JaxResNet50
import deeplearning4j_tpu_torch.nn.graph as pgraph
import deeplearning4j_tpu_torch.nn.layers as players
import deeplearning4j_tpu_torch.nn.preprocessors as ppre
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import ComputationGraph
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, state_from_numpy,
)
from deeplearning4j_tpu_torch.models.fusion import fuse_conv_bn
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraphConfiguration, MergeVertex,
)
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.optim.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.optim.updaters import Adam, Sgd, tree_leaves
from deeplearning4j_tpu_torch.ops import conv_fused as cf
from deeplearning4j_tpu_torch.zoo import ResNet50, fold_stem_kernel

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_params(rng, tree):
    """Random values of the JAX init's shapes (gamma near 1, var > 0)."""
    out = {}
    for k, v in tree.items():
        a = rng.standard_normal(np.shape(v)) * 0.5
        if k in ("gamma", "var"):
            a = 1.0 + np.abs(a) if k == "var" else 1.0 + a
        out[k] = a.astype(np.float32)
    return out


def _run_layer_twin(cls, kw, in_shape, *, train=False, mask=None, seed=0):
    jl, pl = getattr(jlayers, cls)(**kw), getattr(players, cls)(**kw)
    rng = np.random.default_rng(seed)
    jp, js = jl.init_params(jax.random.PRNGKey(seed), None, jnp.float32)
    params = _random_params(rng, jp)
    state = _random_params(rng, js)
    x = rng.standard_normal(in_shape).astype(np.float32)
    jy, jst = jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x),
                       state={k: jnp.asarray(v) for k, v in state.items()},
                       train=train,
                       mask=None if mask is None else jnp.asarray(mask))
    py, pst = pl.apply({k: torch.tensor(v) for k, v in params.items()},
                       torch.tensor(x),
                       state={k: torch.tensor(v) for k, v in state.items()},
                       train=train,
                       mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(_np(py), np.asarray(jy), **TOL)
    for k in state:
        np.testing.assert_allclose(_np(pst[k]), np.asarray(jst[k]), **TOL,
                                   err_msg=k)
    return x, py, pst


def _same_output_type(pv, jv, shapes):
    pt = pv.output_type(*[InputType(**s) for s in shapes])
    jt = jv.output_type(*[JaxInputType(**s) for s in shapes])
    assert dataclasses.asdict(pt) == dataclasses.asdict(jt)


def _cnn(h, w, c):
    return dict(kind="cnn", height=h, width=w, channels=c)


# ------------------------------------------------------------------ layers
LAYER_CASES = [
    ("conv3x3_truncate_pad1", "ConvolutionLayer",
     dict(n_in=3, n_out=4, kernel=(3, 3), padding=(1, 1),
          activation="relu"), (2, 7, 7, 3)),
    ("conv3x3_same_stride2_asymmetric", "ConvolutionLayer",
     dict(n_in=3, n_out=4, kernel=(3, 3), stride=(2, 2),
          convolution_mode="same"), (2, 8, 8, 3)),
    ("conv2x2_same_stride2_odd", "ConvolutionLayer",
     dict(n_in=3, n_out=5, kernel=(2, 2), stride=(2, 2),
          convolution_mode="same"), (2, 7, 7, 3)),
    ("conv7x7_stride2_stem", "ConvolutionLayer",
     dict(n_in=3, n_out=4, kernel=(7, 7), stride=(2, 2), has_bias=False),
     (2, 14, 14, 3)),
    ("conv3x3_same_dilated", "ConvolutionLayer",
     dict(n_in=3, n_out=4, kernel=(3, 3), dilation=(2, 2),
          convolution_mode="same"), (2, 9, 9, 3)),
    ("conv3x3_strict_stride2", "ConvolutionLayer",
     dict(n_in=3, n_out=4, kernel=(3, 3), stride=(2, 2), padding=(1, 1),
          convolution_mode="strict"), (2, 9, 9, 3)),
    ("maxpool3x3_same_stride2_asymmetric", "SubsamplingLayer",
     dict(pooling="max", kernel=(3, 3), stride=(2, 2),
          convolution_mode="same"), (2, 8, 8, 3)),
    ("maxpool3x3_same_stride2_symmetric", "SubsamplingLayer",
     dict(pooling="max", kernel=(3, 3), stride=(2, 2),
          convolution_mode="same"), (2, 7, 7, 3)),
    ("avgpool3x3_same_stride2_real_count", "SubsamplingLayer",
     dict(pooling="avg", kernel=(3, 3), stride=(2, 2),
          convolution_mode="same"), (2, 8, 8, 3)),
    ("avgpool2x2_truncate", "SubsamplingLayer",
     dict(pooling="avg", kernel=(2, 2), stride=(2, 2)), (2, 7, 6, 3)),
    ("sumpool3x3_same", "SubsamplingLayer",
     dict(pooling="sum", kernel=(3, 3), stride=(1, 1),
          convolution_mode="same"), (2, 5, 5, 3)),
    ("pnormpool2x2", "SubsamplingLayer",
     dict(pooling="pnorm", kernel=(2, 2), stride=(2, 2), pnorm=3),
     (2, 6, 6, 3)),
    ("maxpool3x3_truncate_pad1", "SubsamplingLayer",
     dict(pooling="max", kernel=(3, 3), stride=(2, 2), padding=(1, 1)),
     (2, 7, 7, 3)),
    ("zeropad_symmetric", "ZeroPaddingLayer", dict(pad=(1, 2)),
     (2, 4, 5, 3)),
    ("zeropad_per_side", "ZeroPaddingLayer", dict(pad=((2, 1), (0, 3))),
     (2, 4, 5, 3)),
    ("space_to_depth", "SpaceToDepthLayer", dict(block=2), (2, 4, 6, 3)),
    ("activation_relu", "ActivationLayer", dict(activation="relu"),
     (2, 3, 4)),
    ("dropout_eval", "DropoutLayer", dict(dropout=0.5), (2, 5)),
    ("bn_eval_nhwc", "BatchNormalization", dict(n_out=3, activation="relu"),
     (2, 4, 4, 3)),
    ("bn_eval_locked", "BatchNormalization",
     dict(n_out=5, lock_gamma_beta=True), (4, 5)),
    ("globalpool_max", "GlobalPoolingLayer", dict(pooling="max"),
     (2, 3, 4, 5)),
    ("globalpool_avg", "GlobalPoolingLayer", dict(pooling="avg"),
     (2, 3, 4, 5)),
    ("globalpool_sum", "GlobalPoolingLayer", dict(pooling="sum"),
     (2, 6, 5)),
    ("globalpool_pnorm", "GlobalPoolingLayer", dict(pooling="pnorm"),
     (2, 3, 4, 5)),
    ("fused1x1_eval_tanh", "FusedConvBNLayer",
     dict(n_in=4, n_out=6, kernel=(1, 1), stride=(2, 2),
          activation="tanh"), (2, 5, 5, 4)),
    ("fused3x3_eval_relu", "FusedConvBNLayer",
     dict(n_in=4, n_out=6, kernel=(3, 3), activation="relu"),
     (2, 5, 5, 4)),
]


@pytest.mark.parametrize("cls,kw,shape", [c[1:] for c in LAYER_CASES],
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(cls, kw, shape):
    _run_layer_twin(cls, kw, shape)
    if len(shape) == 4:
        _same_output_type(getattr(players, cls)(**kw),
                          getattr(jlayers, cls)(**kw), [_cnn(*shape[1:])])


TRAIN_CASES = [
    ("bn_train_nhwc", "BatchNormalization", dict(n_out=3), (4, 3, 3, 3)),
    ("bn_train_ff", "BatchNormalization", dict(n_out=5, decay=0.8), (6, 5)),
    ("bn_train_rnn", "BatchNormalization", dict(n_out=4), (3, 5, 4)),
    ("fused1x1_train_stride2", "FusedConvBNLayer",
     dict(n_in=4, n_out=6, kernel=(1, 1), stride=(2, 2),
          activation="relu"), (2, 5, 5, 4)),
    ("fused3x3_train_identity", "FusedConvBNLayer",
     dict(n_in=4, n_out=6, kernel=(3, 3)), (2, 5, 5, 4)),
]


@pytest.mark.parametrize("cls,kw,shape", [c[1:] for c in TRAIN_CASES],
                         ids=[c[0] for c in TRAIN_CASES])
def test_layer_train_mode_matches_jax(cls, kw, shape):
    """Batch statistics and the running-statistics update."""
    _run_layer_twin(cls, kw, shape, train=True, seed=3)


def test_batchnorm_uses_the_biased_variance():
    x, _, state = _run_layer_twin("BatchNormalization",
                                  dict(n_out=3, decay=0.0), (2, 2, 2, 3),
                                  train=True)
    # decay 0: the running var IS the batch variance, over 8 values
    biased = x.reshape(-1, 3).var(axis=0)
    np.testing.assert_allclose(_np(state["var"]), biased, rtol=1e-5)
    assert not np.allclose(biased, x.reshape(-1, 3).var(axis=0, ddof=1))


def test_asymmetric_same_pooling_differs_from_symmetric_padding():
    """XLA pads the 3x3/2 SAME pool over an even map 0 before and 1
    after; PyTorch's padding=1 would shift every window."""
    x, y, _ = _run_layer_twin("SubsamplingLayer", dict(
        pooling="max", kernel=(3, 3), stride=(2, 2),
        convolution_mode="same"), (1, 8, 8, 2))
    sym = torch.nn.functional.max_pool2d(
        torch.tensor(x).permute(0, 3, 1, 2), 3, 2, padding=1
    ).permute(0, 2, 3, 1)
    assert sym.shape == y.shape and not torch.allclose(sym, y)


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_masked_matches_jax(pooling):
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    _run_layer_twin("GlobalPoolingLayer", dict(pooling=pooling), (2, 5, 3),
                    mask=mask)


def test_dropout_layer_in_training():
    layer = players.DropoutLayer(dropout=0.25)
    x = torch.ones(64, 32)
    y, _ = layer.apply({}, x, train=True,
                       rng=torch.Generator().manual_seed(0))
    vals = set(np.unique(_np(y)).tolist())
    assert vals <= {0.0, float(np.float32(1.0 / 0.75))} and len(vals) == 2


def test_fused_layer_rejects_unfusable_geometry():
    with pytest.raises(ValueError, match="kernels"):
        players.FusedConvBNLayer(n_out=4, kernel=(5, 5))
    with pytest.raises(ValueError, match="stride-1"):
        players.FusedConvBNLayer(n_out=4, kernel=(3, 3), stride=(2, 2))


# ---------------------------------------------------------------- vertices
PRE_CASES = [
    ("CnnToFeedForward", dict(height=2, width=3, channels=4), (2, 2, 3, 4),
     _cnn(2, 3, 4)),
    ("FeedForwardToCnn", dict(height=2, width=3, channels=4), (2, 24),
     dict(kind="ff", size=24)),
    ("FeedForwardToRnn", {}, (2, 6), dict(kind="ff", size=6)),
    ("RnnToFeedForward", {}, (2, 5, 6), dict(kind="rnn", size=6,
                                              timesteps=5)),
    ("RnnToCnn", dict(height=2, width=2, channels=3), (2, 4, 12),
     dict(kind="rnn", size=12, timesteps=4)),
    ("CnnToRnn", {}, (2, 2, 3, 4), _cnn(2, 3, 4)),
]


@pytest.mark.parametrize("cls,kw,shape,itype", PRE_CASES,
                         ids=[c[0] for c in PRE_CASES])
def test_preprocessor_vertex_matches_jax(cls, kw, shape, itype):
    jv = jgraph.PreprocessorVertex(preprocessor=getattr(jpre, cls)(**kw))
    pv = pgraph.PreprocessorVertex(preprocessor=getattr(ppre, cls)(**kw))
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jy, _ = jv.apply({}, [jnp.asarray(x)])
    py, _ = pv.apply({}, [torch.tensor(x)])
    np.testing.assert_array_equal(_np(py), np.asarray(jy))
    _same_output_type(pv, jv, [itype])


VERTEX_CASES = [
    ("add3", "ElementWiseVertex", dict(op="add"), [(2, 3, 3, 4)] * 3),
    ("subtract", "ElementWiseVertex", dict(op="subtract"), [(2, 5)] * 2),
    ("product", "ElementWiseVertex", dict(op="product"), [(2, 5)] * 3),
    ("average", "ElementWiseVertex", dict(op="average"), [(2, 5)] * 3),
    ("max", "ElementWiseVertex", dict(op="max"), [(2, 4, 5)] * 2),
    ("merge_cnn", "MergeVertex", {}, [(2, 3, 3, 4), (2, 3, 3, 2)]),
    ("merge_ff", "MergeVertex", {}, [(2, 4), (2, 3)]),
    ("subset", "SubsetVertex", dict(from_=1, to=3), [(2, 6)]),
    ("stack", "StackVertex", {}, [(2, 5), (3, 5)]),
    ("unstack", "UnstackVertex", dict(from_=1, stack_size=2), [(4, 5)]),
    ("scale", "ScaleVertex", dict(scale=2.5), [(2, 5)]),
    ("shift", "ShiftVertex", dict(shift=-1.5), [(2, 5)]),
    ("reshape", "ReshapeVertex", dict(shape=(2, 6)), [(3, 12)]),
    ("l2normalize", "L2NormalizeVertex", {}, [(3, 6)]),
    ("l2", "L2Vertex", {}, [(3, 6), (3, 6)]),
    ("poolhelper", "PoolHelperVertex", {}, [(2, 4, 5, 3)]),
]


def _itype(shape):
    if len(shape) == 4:
        return _cnn(*shape[1:])
    if len(shape) == 3:
        return dict(kind="rnn", size=shape[2], timesteps=shape[1])
    return dict(kind="ff", size=shape[1])


@pytest.mark.parametrize("cls,kw,shapes", [c[1:] for c in VERTEX_CASES],
                         ids=[c[0] for c in VERTEX_CASES])
def test_vertex_matches_jax(cls, kw, shapes):
    jv, pv = getattr(jgraph, cls)(**kw), getattr(pgraph, cls)(**kw)
    rng = np.random.default_rng(len(shapes))
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jy, _ = jv.apply({}, [jnp.asarray(x) for x in xs])
    py, _ = pv.apply({}, [torch.tensor(x) for x in xs])
    np.testing.assert_allclose(_np(py), np.asarray(jy), **TOL)
    if cls not in ("StackVertex", "UnstackVertex", "ReshapeVertex"):
        _same_output_type(pv, jv, [_itype(s) for s in shapes])


def test_elementwise_vertex_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="identical shapes"):
        pgraph.ElementWiseVertex().output_type(
            InputType.feed_forward(3), InputType.feed_forward(4))


# ------------------------------------------------------------------- config
def test_graph_configuration_json_both_ways():
    jconf = JaxResNet50(num_classes=10, input_shape=(32, 32, 3),
                        fused=True).conf()
    pconf = ResNet50(num_classes=10, input_shape=(32, 32, 3),
                     fused=True).conf()
    text = jconf.to_json()
    assert pconf.to_json() == text
    assert ComputationGraphConfiguration.from_json(text).to_json() == text
    assert jgraph.ComputationGraphConfiguration.from_json(
        pconf.to_json()).to_json() == text
    assert pconf.topological_order == jconf.topological_order


def test_graph_configuration_refuses_unported_vertex():
    """`LastTimeStepVertex` (refused until A3) now reads and writes back
    JAX's JSON; a vertex holding a layer the port has not ported yet
    (`MoEFeedForward`, A6; `Upsampling2DLayer` until A2b) is still
    refused when the configuration is read."""
    g = (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .set_input_types(InputType.recurrent(4, 3)))
    g.add_vertex("last", pgraph.LastTimeStepVertex(mask_input="in"), "in")
    g.add_layer("d", players.DenseLayer(n_out=4), "last")
    g.set_outputs("d")
    text = g.build().to_json()
    conf = ComputationGraphConfiguration.from_json(text)
    assert conf.vertices["last"] == pgraph.LastTimeStepVertex(
        name="last", mask_input="in")
    assert conf.to_json() == text
    assert jgraph.ComputationGraphConfiguration.from_json(
        text).to_json() == text
    bad = text.replace('"@class": "DenseLayer"',
                       '"@class": "MoEFeedForward"')
    with pytest.raises(NotImplementedError, match="MoEFeedForward"):
        ComputationGraphConfiguration.from_json(bad)


def test_graph_builder_checks():
    g = (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .set_input_types(InputType.feed_forward(4)))
    g.add_layer("a", players.DenseLayer(n_out=3), "in")
    g.add_layer("b", players.DenseLayer(n_out=3), "c")
    g.add_layer("c", players.DenseLayer(n_out=3), "b")
    with pytest.raises(ValueError, match="cycle"):
        g.build()
    g = (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .set_input_types(InputType.feed_forward(4)))
    g.add_layer("a", players.DenseLayer(n_out=3, activation="nope"), "in")
    with pytest.raises(ValueError, match="nope"):
        g.build()
    g = (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .set_input_types(InputType.feed_forward(4)))
    g.add_layer("a", players.DenseLayer(n_out=3), "missing")
    with pytest.raises(ValueError, match="unknown input"):
        g.build()


def test_fold_stem_kernel_matches_jax():
    from deeplearning4j_tpu.zoo.resnet import fold_stem_kernel as jfold

    w = np.random.default_rng(0).standard_normal((7, 7, 3, 4))
    got, pads = fold_stem_kernel(w)
    want, jpads = jfold(w)
    np.testing.assert_array_equal(got, want)
    assert pads == jpads


# ------------------------------------------------------------------- fusion
def _graph(conv_kw=None, two_consumers=False, updater=None, l2=None):
    """in -> conv -> bn -> gap -> output (+ a second consumer of conv)."""
    b = NeuralNetConfiguration.builder().seed(5).updater(
        updater or Sgd(0.05))
    if l2:
        b = b.l2(l2)
    g = (b.graph_builder().add_inputs("in")
         .set_input_types(InputType.convolutional(8, 8, 3)))
    ckw = {"kernel": (1, 1), "has_bias": False, "activation": "identity"}
    ckw.update(conv_kw or {})
    g.add_layer("c", players.ConvolutionLayer(n_out=8, **ckw), "in")
    g.add_layer("b", players.BatchNormalization(activation="relu"), "c")
    g.add_layer("gap", players.GlobalPoolingLayer(pooling="avg"), "b")
    if two_consumers:
        g.add_layer("gap2", players.GlobalPoolingLayer(pooling="avg"), "c")
        g.add_vertex("m", MergeVertex(), "gap", "gap2")
        g.add_layer("output", players.OutputLayer(n_out=3,
                                                  activation="softmax"), "m")
    else:
        g.add_layer("output", players.OutputLayer(n_out=3,
                                                  activation="softmax"),
                    "gap")
    g.set_outputs("output")
    return ComputationGraph(g.build(), device="cpu").init()


def _data():
    r = np.random.default_rng(0)
    x = r.standard_normal((4, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 4)]
    return DataSet(x, y)


@pytest.mark.parametrize("conv_kw", [None, {"kernel": (3, 3),
                                            "convolution_mode": "same"}],
                         ids=["1x1", "3x3"])
def test_pair_rewritten_with_training_parity(conv_kw):
    net = _graph(conv_kw)
    fused = fuse_conv_bn(net)
    assert fused.fused_pairs == [("c", "b")]
    assert isinstance(fused.conf.vertices["b"].layer,
                      players.FusedConvBNLayer)
    assert "c" not in fused.conf.vertices
    ds = _data()
    np.testing.assert_allclose(_np(net.output(ds.features)),
                               _np(fused.output(ds.features)), **TOL)
    net.fit(ds)
    fused.fit(ds)
    np.testing.assert_allclose(_np(net.output(ds.features)),
                               _np(fused.output(ds.features)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(net.state_tree["b"]["mean"]),
                               _np(fused.state_tree["b"]["mean"]), **TOL)
    assert fused.state_tree["b"]["mean"].dtype == torch.float32


@pytest.mark.parametrize("conv_kw", [
    {"kernel": (3, 3)},
    {"kernel": (3, 3), "convolution_mode": "same", "stride": (2, 2)},
    {"kernel": (5, 5), "convolution_mode": "same"},
    {"has_bias": True},
    {"activation": "relu"},
], ids=["3x3_valid", "3x3_strided", "5x5", "bias", "relu"])
def test_ineligible_convs_left_alone(conv_kw):
    fused = fuse_conv_bn(_graph(conv_kw))
    assert fused.fused_pairs == [] and "c" in fused.conf.vertices


def test_multi_consumer_conv_not_fused():
    assert fuse_conv_bn(_graph(two_consumers=True)).fused_pairs == []


def test_3x3_explicit_pad_same_equivalent_fuses():
    fused = fuse_conv_bn(_graph({"kernel": (3, 3), "padding": (1, 1)}))
    assert fused.fused_pairs == [("c", "b")]


def test_sequential_net_rejected():
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    net = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(0)
        .list(players.DenseLayer(n_out=4),
              players.OutputLayer(n_out=2, activation="softmax"))
        .set_input_type(InputType.feed_forward(3)).build(),
        device="cpu").init()
    with pytest.raises(TypeError, match="ComputationGraph"):
        fuse_conv_bn(net)


def test_training_config_and_updater_state_carry_over():
    net = _graph(updater=Adam(1e-3), l2=1e-3)
    ds = _data()
    net.fit(ds)
    fused = fuse_conv_bn(net)
    assert fused.conf.vertices["b"].layer.l2 == pytest.approx(1e-3)
    old, new = (tree_leaves(n.updater_state["output"]) for n in (net, fused))
    for a, b in zip(old, new):
        assert torch.equal(a, b)
    assert any(t.abs().max() > 0 for t in new)
    assert net.score(ds) == pytest.approx(fused.score(ds), rel=1e-5)


# ---------------------------------------------------------------- ResNet-50
@pytest.fixture(scope="module")
def jax_resnets():
    """JAX ResNet-50s at 32x32, 8 classes, unfused and fused, with random
    running statistics (so eval normalizes with non-trivial ones)."""
    rng = np.random.default_rng(0)
    nets = {}
    for fused in (False, True):
        conf = JaxResNet50(num_classes=8, input_shape=(32, 32, 3),
                           fused=fused,
                           updater=JaxNesterovs(0.01, 0.9)).conf()
        net = JaxGraph(conf).init()
        state = {n: _random_params(rng, s) if s else {}
                 for n, s in _np_tree(net.state_tree).items()}
        net.state_tree = jax.tree_util.tree_map(jnp.asarray, state)
        nets[fused] = net
    return nets


def _port_twin(jnet):
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(net, _np_tree(jnet.params_tree))
    state_from_numpy(net, _np_tree(jnet.state_tree))
    return net


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet50_output_on_jax_weights(jax_resnets, fused):
    jnet = jax_resnets[fused]
    net = _port_twin(jnet)
    x = np.random.default_rng(4).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    cf.reset_counts()
    got = net.output(x)
    assert sum(cf.LAUNCHES.values()) == 0
    np.testing.assert_allclose(_np(got), np.asarray(jnet.output(x)),
                               rtol=0, atol=1e-5)
    n_fused = sum(isinstance(getattr(v, "layer", None),
                             players.FusedConvBNLayer)
                  for v in net.conf.vertices.values())
    assert n_fused == (52 if fused else 0)


def test_resnet50_fusion_pass_covers_52_pairs(jax_resnets):
    net = _port_twin(jax_resnets[False])
    fused = fuse_conv_bn(net)
    # 16 blocks x (two 1x1s + one 3x3) + 4 projection shortcuts; the 7x7
    # stem stays unfused
    assert len(fused.fused_pairs) == 52
    assert "stem_conv" in fused.conf.vertices
    x = np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(net.output(x)), _np(fused.output(x)),
                               rtol=0, atol=1e-5)


def test_resnet50_fused_nesterovs_steps_match_jax():
    """The full fused ResNet-50 (52 fused conv+BN vertices, the unfused
    stem, pooling, the residual adds) through two Nesterovs(0.01, 0.9)
    steps of `fit` on JAX's weights, in float64: at 32x32 and batch 4
    the last stage's batch statistics come from four values a channel,
    which amplifies float32 rounding by orders of magnitude in training
    mode, so the algorithm is compared where rounding is negligible."""
    conf = JaxResNet50(num_classes=8, input_shape=(32, 32, 3), fused=True,
                       updater=JaxNesterovs(0.01, 0.9)).conf()
    jnet = JaxGraph(dataclasses.replace(conf, dtype="float64")).init()
    net = _port_twin(jnet)
    assert net.dtype == torch.float64
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 32, 32, 3))
    y = np.eye(8)[rng.integers(0, 8, 4)]
    jscores, scores = JaxScores(), CollectScoresIterationListener()
    jnet.set_listeners(jscores)
    net.listeners.append(scores)
    jnet.fit(JaxDataSet(x, y), epochs=2)
    net.fit(DataSet(x, y), epochs=2)
    np.testing.assert_allclose([s for _, s in scores.scores],
                               [s for _, s in jscores.scores], rtol=1e-9)
    for tree, jtree in ((net.params_tree, jnet.params_tree),
                        (net.state_tree, jnet.state_tree)):
        jtree = _np_tree(jtree)
        for name, sub in tree.items():
            for k, v in sub.items():
                want = jtree[name][k]
                np.testing.assert_allclose(
                    v.numpy(), want, rtol=0,
                    atol=1e-7 * max(np.abs(want).max(), 1.0),
                    err_msg=f"{name}/{k}")


# ----------------------------------------------------------------- refusals
REFUSALS = [
    (dict(checkpointer="ckpt"), "A6"),
    (dict(stop_fn=lambda *_: False), "A6"),
]


@pytest.mark.parametrize("kw,item", REFUSALS,
                         ids=["checkpointer", "stop_fn"])
def test_fit_refuses_what_is_not_ported(kw, item, tmp_path):
    """Refused naming `item` until slice 30; a graph's fit now takes the
    recovery arguments (`optim/recovery.py`): a checkpointer commits its
    last step, a stop_fn that never fires trains every batch, each with
    the plain fit's parameters."""
    from deeplearning4j_tpu_torch.parallel import ShardedCheckpointer

    if "checkpointer" in kw:
        kw = dict(checkpointer=ShardedCheckpointer(str(tmp_path / "ck")))
    net, plain = _graph(), _graph()
    net.fit(_data(), **kw)
    plain.fit(_data())
    assert net.iteration == plain.iteration and not net.stopped_early
    for name, sub in plain.params_tree.items():
        for k, v in sub.items():
            assert torch.equal(net.params_tree[name][k], v), (name, k)
    if "checkpointer" in kw:
        assert kw["checkpointer"].latest_step() == net.iteration


@pytest.mark.parametrize("field,value", [
    ("optimization_algo", "lbfgs"),
    ("tbptt_fwd_length", 5),
], ids=["solver", "tbptt"])
def test_fit_refuses_unported_config(field, value):
    """Both configurations, once refused, fit. A solver (refused naming
    A1 until slice 17): one L-BFGS run a batch lowers the loss (its
    parity with JAX is in `test_torch_a1b_solvers.py`). tBPTT (refused
    naming A3 until slice 18) applies, as in JAX, only to a batch whose
    inputs are all 3-D: on this graph's 2-D batch the step is the plain
    one, bit for bit (the chunked fit is in
    `test_torch_graph_recurrent.py`)."""
    net = _graph()
    net.conf = dataclasses.replace(net.conf, **{field: value})
    if field == "tbptt_fwd_length":
        plain = _graph()
        net.fit(_data())
        plain.fit(_data())
        for name, leaves in plain.params_tree.items():
            for k, a in leaves.items():
                assert torch.equal(net.params_tree[name][k], a), (name, k)
        return
    net.conf = dataclasses.replace(net.conf, solver_iterations=5)
    before = net.score(_data())
    net.fit(_data())
    assert net.score(_data()) < before
    assert net._solver.algo == value and net._solver.solver_syncs >= 5


def test_fit_with_gradient_checkpointing_runs():
    """Gradient checkpointing (once refused naming A4) recomputes each
    layer vertex in the backward: the same step as without it, bit for
    bit, batch-norm statistics included."""
    plain, ckpt = _graph(), _graph()
    ckpt.conf = dataclasses.replace(ckpt.conf, gradient_checkpointing=True)
    for net in (plain, ckpt):
        net.fit(_data())
    for v, sub in plain.params_tree.items():
        for k, t in sub.items():
            assert torch.equal(t, ckpt.params_tree[v][k]), f"{v}/{k}"
    for v, sub in plain.state_tree.items():
        for k, t in sub.items():
            assert torch.equal(t, ckpt.state_tree[v][k]), f"{v}/{k}"


def test_stepping_pretraining_and_multi_input_feeding_are_refused():
    """`pretrain` (once refused naming A1) runs: a graph without a
    pretrainable vertex is left as it was (its parity with JAX is in
    `test_torch_a1b_layers.py`). Stepping (once refused naming A3) runs:
    an LSTM graph stepped in two calls equals its full forward;
    multi-input feeding (once refused naming A1) takes a MultiDataSet,
    while a plain DataSet lacks the second input."""
    net = _graph()
    before = net.params().clone()
    assert net.pretrain(_data()) is net
    assert torch.equal(net.params(), before) and not net.pretrain_losses
    r = (NeuralNetConfiguration.builder().seed(2).graph_builder()
         .add_inputs("in").set_input_types(InputType.recurrent(3, 5)))
    r.add_layer("lstm", players.LSTM(n_out=4, activation="tanh"), "in")
    r.add_layer("out", players.RnnOutputLayer(n_out=2,
                                              activation="softmax"), "lstm")
    r.set_outputs("out")
    rnet = ComputationGraph(r.build(), device="cpu").init()
    x = np.random.default_rng(1).standard_normal((2, 5, 3)).astype(
        np.float32)
    stepped = torch.cat([rnet.rnn_time_step(x[:, :2]),
                         rnet.rnn_time_step(x[:, 2:])], dim=1)
    torch.testing.assert_close(stepped, rnet.output(x), rtol=1e-6,
                               atol=1e-6)
    g = (NeuralNetConfiguration.builder().graph_builder()
         .add_inputs("a", "b")
         .set_input_types(InputType.feed_forward(3),
                          InputType.feed_forward(3)))
    g.add_vertex("m", MergeVertex(), "a", "b")
    g.add_layer("out", players.OutputLayer(n_out=2, activation="softmax"),
                "m")
    g.set_outputs("out")
    two = ComputationGraph(g.build(), device="cpu").init()
    assert tuple(two.output(np.ones((2, 3), np.float32),
                            np.ones((2, 3), np.float32)).shape) == (2, 2)
    two.fit(MultiDataSet([np.ones((2, 3), np.float32),
                          np.ones((2, 3), np.float32)],
                         [np.eye(2, dtype=np.float32)]))
    assert two.iteration == 1
    with pytest.raises(KeyError, match="b"):
        two.fit(DataSet(np.ones((2, 3), np.float32),
                        np.eye(2, dtype=np.float32)))
