"""AlexNet and the Inception zoo (GoogLeNet, InceptionResNetV1,
FaceNetNN4Small2) against the JAX package's, on the CPU.

- The configurations at their default sizes (224, 160 and 96; 1000 and
  5749 classes) write JAX's JSON byte for byte, and JAX's JSON loads
  in the port and writes back the same: block counts 5/10/5, the
  `ScaleVertex` scales 0.17 and 0.10, the updaters (Nesterovs for
  AlexNet and GoogLeNet, Adam for the other two), FaceNet's
  `L2NormalizeVertex` embedding under the `CenterLossOutputLayer`.
- At a tiny input (32×32, AlexNet 67×67: the smallest its three
  truncate-mode pools leave a pixel of; 10 classes), in float64 with
  dropout set to 0 in the JSON both packages read: the same weights
  (`_random_weights`) in both, carried across with `params_from_numpy`,
  one `output()` and two `fit` steps
  (loss, parameters, updater state, running statistics and FaceNet's
  class centers) within the tolerances below.
- One dropout invariant: in training, GoogLeNet's 0.4 dropout zeroes
  about 40% of its inputs and scales the rest by 1/0.6.

Tolerances, float64: outputs 1e-10; losses 1e-9 relative; parameters,
updater state and statistics 1e-8 absolute after two steps (batch norm
over a 4×1×1 batch amplifies last-bit differences of the sums), and the
output after them 1e-7 (InceptionResNetV1's 15 residual blocks carry
those 1e-8 differences to 1.8e-8)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.config import (
    MultiLayerConfiguration as JaxMLConf,
)
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.optim.listeners import (
    CollectScoresIterationListener as JaxScores,
)
from deeplearning4j_tpu import zoo as jax_zoo
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.models import (
    ComputationGraph, MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, state_from_numpy, updater_state_from_numpy,
)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraphConfiguration, ScaleVertex,
)
from deeplearning4j_tpu_torch.optim.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs

OUT_TOL = dict(rtol=0, atol=1e-10)
LOSS_TOL = dict(rtol=1e-9, atol=0)
PARAM_TOL = dict(rtol=0, atol=1e-8)
STEPPED_OUT_TOL = dict(rtol=0, atol=1e-7)
MODELS = ["AlexNet", "GoogLeNet", "InceptionResNetV1", "FaceNetNN4Small2"]
TINY = {"AlexNet": (67, 67, 3)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, path="", **tol):
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            _close(port[k], ref[k], f"{path}/{k}", **tol)
    elif isinstance(port, tuple):
        assert port == () and len(ref) == 0, path
    else:
        np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                                   **tol, err_msg=path)


@pytest.mark.parametrize("name", MODELS)
def test_default_configuration_is_jax_json(name):
    text = getattr(jax_zoo, name)().conf().to_json()
    assert getattr(zoo, name)().conf().to_json() == text
    loads = (MultiLayerConfiguration if name == "AlexNet"
             else ComputationGraphConfiguration).from_json
    assert loads(text).to_json() == text
    assert name.lower() in zoo.ZOO_REGISTRY


def test_inception_structure_and_defaults():
    g = zoo.GoogLeNet().conf()
    assert isinstance(g.updater, Nesterovs)
    assert g.input_types["input"].height == 224
    assert sum(n.startswith("i") and "_" not in n for n in g.vertices) == 9
    r = zoo.InceptionResNetV1().conf()
    assert isinstance(r.updater, Adam)
    assert r.input_types["input"].height == 160
    assert sum(n.endswith("_scale") for n in r.vertices) == 15
    scales = {n[0]: v.scale for n, v in r.vertices.items()
              if isinstance(v, ScaleVertex)}
    assert scales == {"a": 0.17, "b": 0.10}
    f = zoo.FaceNetNN4Small2().conf()
    assert f.input_types["input"].height == 96
    assert type(f.vertices["embeddings"]).__name__ == "L2NormalizeVertex"
    assert type(f.vertices["lossLayer"].layer).__name__ == \
        "CenterLossOutputLayer"
    assert f.vertex_inputs["lossLayer"] == ("embeddings",)
    assert isinstance(zoo.AlexNet().conf().updater, Nesterovs)


def _tiny_json(name, dropout_off=True):
    """JAX's configuration at the tiny input, in float64, with every
    dropout set to 0 (None) unless `dropout_off` is false, and every
    weight init "zero" (`_random_weights` fills the weights)."""
    shape = TINY.get(name, (32, 32, 3))
    d = json.loads(getattr(jax_zoo, name)(num_classes=10,
                                          input_shape=shape).conf().to_json())
    d["dtype"] = "float64"

    def walk(o):
        if isinstance(o, dict):
            if dropout_off and isinstance(o.get("dropout"), float):
                o["dropout"] = None
            if "weight_init" in o:
                o["weight_init"] = "zero"
            for v in o.values():
                walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)

    walk(d)
    return json.dumps(d), shape


def _pair(name, dropout_off=True):
    text, shape = _tiny_json(name, dropout_off)
    if name == "AlexNet":
        jnet = JaxNet(JaxMLConf.from_json(text)).init()
        pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(text),
                                 device="cpu").init()
    else:
        jnet = JaxGraph(JaxGraphConf.from_json(text)).init()
        pnet = ComputationGraph(ComputationGraphConfiguration.from_json(text),
                                device="cpu").init()
    jnet.params_tree = _random_weights(_np(jnet.params_tree))
    params_from_numpy(pnet, _np(jnet.params_tree))
    state_from_numpy(pnet, _np(jnet.state_tree))
    updater_state_from_numpy(pnet, _np(jnet.updater_state))
    return jnet, pnet, shape


def _random_weights(tree, seed=7):
    """He-scaled normal kernels (std √(2 / fan-in)), biases and batch-norm
    shifts N(0, 0.1²), scales 1 + N(0, 0.1²), drawn by numpy. JAX's own
    initializers compile one program a shape (25 s for GoogLeNet's on
    the CPU), so both nets start from zero-initialized configurations
    and take these."""
    rng = np.random.default_rng(seed)

    def draw(name, a):
        if name == "W":
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.standard_normal(a.shape) * np.sqrt(2.0 / fan_in)
        if name == "gamma":
            return 1.0 + 0.1 * rng.standard_normal(a.shape)
        return 0.1 * rng.standard_normal(a.shape)

    return {v: {k: jnp.asarray(draw(k, a)) for k, a in p.items()}
            for v, p in tree.items()}


def _data(shape, n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + shape)
    y = np.eye(10)[rng.integers(0, 10, n)]
    return x, y


def _out(y):
    return y[0] if isinstance(y, (list, tuple)) else y


@pytest.mark.parametrize("name", MODELS)
def test_output_and_two_fit_steps_match_jax(name):
    jnet, pnet, shape = _pair(name)
    assert pnet.num_params() == jnet.num_params()
    x, y = _data(shape)
    np.testing.assert_allclose(_out(pnet.output(x)).numpy(),
                               np.asarray(_out(jnet.output(x))), **OUT_TOL)
    js, ps = JaxScores(), CollectScoresIterationListener()
    jnet.listeners.append(js)
    pnet.listeners.append(ps)
    jnet.fit(x, y, batch_size=4, epochs=2)
    pnet.fit(x, y, batch_size=4, epochs=2)
    assert pnet.iteration == jnet.iteration == 2
    np.testing.assert_allclose([s for _, s in ps.scores],
                               [s for _, s in js.scores], **LOSS_TOL)
    _close(pnet.params_tree, _np(jnet.params_tree), **PARAM_TOL)
    _close(pnet.updater_state, _np(jnet.updater_state), **PARAM_TOL)
    _close(pnet.state_tree, _np(jnet.state_tree), **PARAM_TOL)
    np.testing.assert_allclose(_out(pnet.output(x)).numpy(),
                               np.asarray(_out(jnet.output(x))),
                               **STEPPED_OUT_TOL)


def test_googlenet_dropout_invariant():
    """GoogLeNet's `DropoutLayer(0.4)` in training: about 40% of the
    pooled features are dropped, the rest scaled by 1/0.6; in eval it is
    the identity."""
    _, pnet, shape = _pair("GoogLeNet", dropout_off=False)
    layer = pnet.conf.vertices["dropout"].layer
    assert layer.dropout == 0.4
    x = torch.ones(64, 1024, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    y, _ = layer.apply({}, x, train=True, rng=gen)
    kept = y != 0
    assert abs(kept.double().mean().item() - 0.6) < 0.02
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.6, rtol=1e-15)
    y_eval, _ = layer.apply({}, x, train=False, rng=gen)
    assert torch.equal(y_eval, x)
