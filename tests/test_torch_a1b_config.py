"""The port's activations, weight initializers and builder calls against
the JAX package's, on the CPU in float64.

Every JAX activation name and the "name:value" forms: forward and
gradient within 1e-12. `distribution`'s six laws: constant exact, the
others by their moments and support (the two packages' random streams
differ). The `Activation` / `WeightInit` constants and registries. The
builder calls (`optimization_algo`, `mini_batch`, `pretrain`,
`backprop`, `layer_names`) and the refusal of a solver with tBPTT at
`build()` on both builders. A JAX configuration using them loads in the
port, writes back the same JSON, and gives JAX's forward on JAX's
weights within 1e-10."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import initializers as jinit
from deeplearning4j_tpu.nn.config import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn import activations as pact
from deeplearning4j_tpu_torch.nn import initializers as pinit
from deeplearning4j_tpu_torch.nn.config import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn import layers as players

NAMES = jact.Activation.names()
PARAMETRISED = ["leakyrelu:0.2", "elu:0.5", "clippedrelu:2.5",
                "thresholdedrelu:0.7", "LeakyReLU:0.05"]


def _x(seed=0, shape=(5, 7)):
    # no entry on a kink (0, 6, 2.5, 0.7, +-1): every gradient is defined
    x = np.random.default_rng(seed).uniform(-3.0, 8.0, shape)
    return x + 1e-3 * (np.abs(x - np.round(x * 10) / 10) < 1e-3)


@pytest.mark.parametrize("name", NAMES + PARAMETRISED)
def test_activation_forward_and_gradient_match_jax(name):
    x = _x()
    w = np.random.default_rng(1).standard_normal(x.shape)
    jf, pf = jact.Activation.get(name), pact.Activation.get(name)
    jy = np.asarray(jf(jnp.asarray(x)))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jf(v) * w))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    py = pf(xt)
    pg, = torch.autograd.grad((py * torch.tensor(w)).sum(), xt)
    np.testing.assert_allclose(py.detach().numpy(), jy, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(pg.numpy(), jg, rtol=1e-12, atol=1e-12)


def test_activation_registry_constants_and_errors():
    assert pact.Activation.names() == NAMES
    for k, v in vars(jact.Activation).items():
        if k.isupper():
            assert getattr(pact.Activation, k) == v, k
    with pytest.raises(ValueError, match="Unknown activation"):
        pact.Activation.get("nope")
    with pytest.raises(ValueError, match="Unknown activation"):
        pact.Activation.get("nope:0.5")
    pact.Activation.register("Twice", lambda x: 2 * x)
    try:
        assert pact.resolve("twice")(torch.ones(2)).tolist() == [2.0, 2.0]
    finally:
        del pact._REGISTRY["twice"]


def test_weight_init_constants_registry_and_lecun_normal():
    for k, v in vars(jinit.WeightInit).items():
        if k.isupper():
            assert getattr(pinit.WeightInit, k) == v, k
    assert set(pinit._REGISTRY) == set(jinit._REGISTRY)
    assert pinit.WeightInit.get("lecun_normal") is pinit.lecun_normal
    gen = torch.Generator().manual_seed(0)
    w = pinit.lecun_normal(gen, (400, 300), torch.float64)
    assert abs(float(w.std()) - math.sqrt(1 / 400)) < 0.02 * math.sqrt(1 / 400)
    pinit.WeightInit.register("Half", lambda g, s, d=torch.float32:
                              torch.full(tuple(s), 0.5, dtype=d))
    try:
        assert float(pinit.resolve("half")(gen, (2,))[0]) == 0.5
    finally:
        del pinit._REGISTRY["half"]
    with pytest.raises(ValueError, match="Unknown weight init"):
        pinit.WeightInit.get("nope")


N = 200_000


@pytest.mark.parametrize("dist,kw", [
    ("normal", dict(mean=0.5, std=2.0)), ("gaussian", dict(mean=-1.0)),
    ("uniform", dict(lower=-0.5, upper=1.5)),
    ("constant", dict(value=0.25)),
    ("truncated_normal", dict(mean=1.0, std=0.5)),
    ("lognormal", dict(mean=0.1, std=0.3)),
    ("binomial", dict(n=5, p=0.3))])
def test_distribution_laws(dist, kw):
    """Constant exactly as JAX's; the others by the law's moments and
    support, beside JAX's draws of the same law."""
    init = pinit.distribution(dist, **kw)
    jx = np.asarray(jinit.distribution(dist, **kw)(
        jax.random.PRNGKey(0), (N,), jnp.float64))
    px = init(torch.Generator().manual_seed(0), (N,), torch.float64).numpy()
    assert px.shape == (N,) and px.dtype == np.float64
    assert init.__name__ == f"distribution_{dist}"
    if dist == "constant":
        np.testing.assert_array_equal(px, jx)
        return
    mean, std = kw.get("mean", 0.0), kw.get("std", 1.0)
    if dist in ("normal", "gaussian"):
        want_mean, want_std = mean, std
    elif dist == "uniform":
        lo, hi = kw["lower"], kw["upper"]
        assert px.min() >= lo and px.max() < hi
        want_mean, want_std = (lo + hi) / 2, (hi - lo) / math.sqrt(12)
    elif dist == "truncated_normal":
        assert np.all(np.abs(px - mean) <= 2 * std)
        want_mean, want_std = mean, 0.8796 * std
    elif dist == "lognormal":
        assert px.min() > 0
        px, jx = np.log(px), np.log(jx)
        want_mean, want_std = mean, std
    else:
        n, p = kw["n"], kw["p"]
        assert set(np.unique(px)) <= set(range(n + 1))
        want_mean, want_std = n * p, math.sqrt(n * p * (1 - p))
    for got in (px, jx):
        assert abs(got.mean() - want_mean) < 0.01 * want_std + 1e-3
        assert abs(got.std() - want_std) < 0.01 * want_std
    with pytest.raises(ValueError, match="Unknown distribution"):
        pinit.distribution("cauchy")(None, (2,))


def test_builder_calls_and_solver_tbptt_refusal():
    b = (NeuralNetConfiguration.builder().optimization_algo("CG", 7)
         .mini_batch(False))
    conf = (b.list(players.DenseLayer(n_out=3),
                   players.OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(4))
            .pretrain(True).backprop(False).build())
    assert (conf.optimization_algo, conf.solver_iterations) == \
        ("conjugate_gradient", 7)
    assert not conf.mini_batch and conf.pretrain and not conf.backprop
    assert conf.layer_names() == ["layer0_denselayer", "layer1_outputlayer"]
    assert NeuralNetConfiguration.builder().optimization_algo("sgd") \
        ._opt_algo == "stochastic_gradient_descent"
    with pytest.raises(ValueError, match="Unknown optimization"):
        NeuralNetConfiguration.builder().optimization_algo("newton")
    with pytest.raises(ValueError, match="Truncated BPTT"):
        (NeuralNetConfiguration.builder().optimization_algo("lbfgs")
         .list(players.LSTM(n_in=3, n_out=4),
               players.RnnOutputLayer(n_in=4, n_out=2,
                                      activation="softmax"))
         .tbptt(5).build())
    g = (NeuralNetConfiguration.builder().optimization_algo("lbfgs", 3)
         .graph_builder().add_inputs("in")
         .set_input_types(InputType.recurrent(3, 5)))
    g.add_layer("lstm", players.LSTM(n_out=4), "in")
    g.add_layer("out", players.RnnOutputLayer(n_out=2, activation="softmax"),
                "lstm")
    g.set_outputs("out")
    gconf = g.build()
    assert (gconf.optimization_algo, gconf.solver_iterations) == ("lbfgs", 3)
    with pytest.raises(ValueError, match="Truncated BPTT"):
        g.tbptt(2).build()


def _jax_conf():
    return (JaxNNC.builder().seed(3).dtype("float64")
            .weight_init("lecun_normal")
            .optimization_algo("line_gradient_descent", iterations=4)
            .mini_batch(False)
            .list(jlayers.DenseLayer(n_out=9, activation="elu:0.5"),
                  jlayers.DenseLayer(n_out=8, activation="selu",
                                     weight_init="relu_uniform"),
                  jlayers.PReLULayer(alpha_init=0.1),
                  jlayers.DenseLayer(n_out=7, activation="leakyrelu:0.2",
                                     weight_init="sigmoid_uniform"),
                  jlayers.DenseLayer(n_out=6, activation="mish"),
                  jlayers.DenseLayer(n_out=6, activation="rationaltanh"),
                  jlayers.AutoEncoder(n_out=5, activation="softplus"),
                  jlayers.DenseLayer(n_out=5,
                                     activation="thresholdedrelu:0.1"),
                  jlayers.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JaxInputType.feed_forward(6))
            .pretrain(True).backprop(True).build())


def test_jax_config_json_loads_and_forwards_within_1e10():
    jconf = _jax_conf()
    pconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert pconf.to_json() == jconf.to_json()
    assert pconf.layer_names() == jconf.layer_names()
    assert pconf.optimization_algo == "line_gradient_descent"
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(pconf, device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    x = np.random.default_rng(4).standard_normal((10, 6))
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=1e-10,
                               atol=1e-10)
    for pa, ja in zip(pnet.feed_forward(x), jnet.feed_forward(x)):
        np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-10,
                                   atol=1e-10)
