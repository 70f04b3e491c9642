"""Input preprocessors in the port's sequential runtime against the JAX
package, on the CPU: a LeNet-shaped list (conv 5x5x20, max-pool 2x2,
Dense 50, Output 10) built by each package's own `ListBuilder` under
`InputType.convolutional` and `convolutional_flat` gets the same
preprocessor map; `output()`, the loss and one SGD step agree on JAX's
weights carried across with `params_from_numpy`; an explicit
`input_preprocessor` is kept; the configuration JSON with its
preprocessors crosses between the packages with int keys and
round-trips.

Tolerances, float32: outputs within 1e-5 absolute (probabilities from
sums of at most 2880 products taken in another order); losses within
1e-5 relative; parameters after a step within 1e-6 absolute."""

import dataclasses

import numpy as np
import pytest

import jax

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import preprocessors as jpp
from deeplearning4j_tpu.nn.config import (
    MultiLayerConfiguration as JaxConf, NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers.convolution import (
    ConvolutionLayer as JaxConv, SubsamplingLayer as JaxPool,
)
from deeplearning4j_tpu.nn.layers.feedforward import (
    DenseLayer as JaxDense, OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.optim.updaters import Sgd as JaxSgd
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn import preprocessors as pp
from deeplearning4j_tpu_torch.nn.config import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optim.updaters import Sgd

OUT_TOL = dict(rtol=0, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=0, atol=1e-6)
KINDS = ["convolutional", "convolutional_flat"]
# the two packages' classes, by role
SIDES = {
    "jax": dict(nnc=JaxNNC, it=JaxInputType, conv=JaxConv, pool=JaxPool,
                dense=JaxDense, out=JaxOutput, sgd=JaxSgd, pp=jpp),
    "torch": dict(nnc=NeuralNetConfiguration, it=InputType,
                  conv=ConvolutionLayer, pool=SubsamplingLayer,
                  dense=DenseLayer, out=OutputLayer, sgd=Sgd, pp=pp),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conf(side, input_type, *, dense=True, explicit=()):
    """The LeNet-shaped list (without the Dense layer when `dense` is
    false, so a preprocessor lands on the output layer) built by one
    package's own builder; `explicit` = ((idx, class name, kwargs), ...)
    given with `input_preprocessor`."""
    s = SIDES[side]
    layers = [s["conv"](n_out=20, kernel=(5, 5), activation="relu"),
              s["pool"](kernel=(2, 2), stride=(2, 2))]
    if dense:
        layers.append(s["dense"](n_out=50, activation="relu"))
    layers.append(s["out"](n_out=10, activation="softmax", loss="mcxent"))
    b = s["nnc"].builder().seed(7).updater(s["sgd"](0.1)).list(*layers)
    for idx, cls, kw in explicit:
        b = b.input_preprocessor(idx, getattr(s["pp"], cls)(**kw))
    kind, shape = input_type
    return b.set_input_type(getattr(s["it"], kind)(*shape)).build()


def _map(conf):
    """{idx: (class name, fields)} of a configuration's preprocessors."""
    return {i: (type(p).__name__, dataclasses.asdict(p))
            for i, p in conf.preprocessors.items()}


def _nets(input_type, **kw):
    jconf = _conf("jax", input_type, **kw)
    pconf = _conf("torch", input_type, **kw)
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(pconf, device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    return jnet, pnet


def _batch(input_type, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    kind, (h, w, c) = input_type
    shape = (batch, h, w, c) if kind == "convolutional" \
        else (batch, h * w * c)
    x = rng.standard_normal(shape).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    return x, y


@pytest.mark.parametrize("kind", KINDS)
def test_builder_inserts_the_preprocessors_jax_inserts(kind):
    it = (kind, (28, 28, 1))
    jmap, pmap = _map(_conf("jax", it)), _map(_conf("torch", it))
    assert pmap == jmap
    want = {2: ("CnnToFeedForward",
                dict(height=12, width=12, channels=20))}
    if kind == "convolutional_flat":
        want[0] = ("FeedForwardToCnn", dict(height=28, width=28, channels=1))
    assert pmap == want


@pytest.mark.parametrize("dense", [True, False], ids=["lenet", "no_dense"])
@pytest.mark.parametrize("kind", KINDS)
def test_output_and_one_sgd_step_match_jax(kind, dense):
    """`output()`, the loss and one SGD step; without the Dense layer the
    flattening preprocessor sits on the output layer itself, whose input
    the loss scores."""
    it = (kind, (28, 28, 1))
    jnet, pnet = _nets(it, dense=dense)
    x, y = _batch(it)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **OUT_TOL)
    np.testing.assert_allclose(pnet.score(x, y), float(jnet.score(x, y)),
                               **LOSS_TOL)
    jnet.fit(x, y, batch_size=4, epochs=1)
    pnet.fit(x, y, batch_size=4, epochs=1)
    np.testing.assert_allclose(pnet.score_, jnet.score_, **LOSS_TOL)
    for name, sub in pnet.params_tree.items():
        for k, v in sub.items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jnet.params_tree[name][k]),
                                       **PARAM_TOL, err_msg=f"{name}/{k}")


def test_explicit_input_preprocessor_is_kept():
    """A flat feed-forward input cannot be shaped into a map by the
    builder (both packages raise); an explicit FeedForwardToCnn at layer
    0 is kept, and the builder still inserts the flattening one."""
    it = ("feed_forward", (784,))
    for side in SIDES:
        with pytest.raises(ValueError, match="convolutional_flat"):
            _conf(side, it)
    explicit = ((0, "FeedForwardToCnn",
                 dict(height=28, width=28, channels=1)),)
    jconf = _conf("jax", it, explicit=explicit)
    pconf = _conf("torch", it, explicit=explicit)
    assert _map(pconf) == _map(jconf)
    assert _map(pconf)[0] == ("FeedForwardToCnn",
                              dict(height=28, width=28, channels=1))
    assert _map(pconf)[2][0] == "CnnToFeedForward"
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(pconf, device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    x, _ = _batch(("convolutional_flat", (28, 28, 1)))
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **OUT_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_config_json_with_preprocessors_crosses_and_round_trips(kind):
    it = (kind, (28, 28, 1))
    jconf = _conf("jax", it)
    pconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert all(isinstance(i, int) for i in pconf.preprocessors)
    assert all(isinstance(p, pp.Preprocessor)
               for p in pconf.preprocessors.values())
    assert _map(pconf) == _map(jconf)
    again = MultiLayerConfiguration.from_json(pconf.to_json())
    assert again == pconf
    back = JaxConf.from_json(pconf.to_json())
    assert _map(back) == _map(jconf)
    # the net built from the crossed JSON runs as JAX's does
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(pconf, device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    x, _ = _batch(it)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **OUT_TOL)


def test_json_naming_an_unported_preprocessor_is_refused():
    text = _conf("torch", ("convolutional", (28, 28, 1))).to_json()
    text = text.replace('"CnnToFeedForward"', '"SomeOtherPreProcessor"')
    with pytest.raises(NotImplementedError, match="SomeOtherPreProcessor"):
        MultiLayerConfiguration.from_json(text)


def test_auto_preprocessor_matches_jax():
    """Every transition the builder asks about, in both packages."""
    shapes = {"ff": (12,), "rnn": (12, 5), "cnn": (4, 3, 2),
              "cnn_flat": (4, 3, 2)}
    makers = {"ff": "feed_forward", "rnn": "recurrent",
              "cnn": "convolutional", "cnn_flat": "convolutional_flat"}
    for src in shapes:
        for to in ("ff", "cnn", "rnn"):
            got, want = [], []
            for side, out in (("torch", got), ("jax", want)):
                it = getattr(SIDES[side]["it"], makers[src])(*shapes[src])
                try:
                    p = SIDES[side]["pp"].auto_preprocessor(it, to)
                    out.append(None if p is None else
                               (type(p).__name__, dataclasses.asdict(p)))
                except ValueError as e:
                    out.append(("ValueError", str(e)))
            assert got == want, (src, to)
