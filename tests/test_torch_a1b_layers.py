"""The port's pretrainable and special layers, its flat parameter view
and layerwise pretraining against the JAX package's, on the CPU in
float64.

- `params()` equals JAX's `params()` element for element (a dense net
  with batch norm, a convolution net carried across by
  `models.convert`), and `set_params` round-trips by copying in place.
- `LossLayer`, `PReLULayer`, `FrozenLayer`, `CenterLossOutputLayer`
  (loss and new centers), `AutoEncoder` (with corruption), RBM (CD-2)
  and VAE (gaussian and bernoulli, 2 samples) scores and gradients
  within 1e-10, JAX's random draws fed through the private helpers.
- `pretrain` of an AutoEncoder (corruption 0) on both runtimes under
  Sgd and Nesterovs (the plain B1b): parameters within 1e-9 of JAX's
  after 5 steps; RBM and VAE pretraining by JAX's invariants
  (`tests/test_layers.py`); a frozen encoder under a center-loss head.
- `feed_forward`, `clone`, `set_listeners` / `add_listener`.

Learning rates are powers of two, exact in the float32 scalar the
port's updaters carry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.inputs import InputType as JaxIT
from deeplearning4j_tpu.optim import updaters as ju
from deeplearning4j_tpu_torch.models import (
    ComputationGraph, MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, state_from_numpy,
)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import feedforward as pff
from deeplearning4j_tpu_torch.nn.layers import special as psp
from deeplearning4j_tpu_torch.optim.listeners import (
    CollectScoresIterationListener,
)

TOL = dict(rtol=1e-10, atol=1e-10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(port, jax_tree, **tol):
    if isinstance(port, dict):
        assert set(port) == set(jax_tree)
        for k in port:
            _close(port[k], jax_tree[k], **tol)
        return
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(jax_tree),
                               **(tol or TOL))


def _pair(layers, n_in, updater=None, seed=0):
    b = JaxNNC.builder().seed(seed).dtype("float64")
    if updater is not None:
        b = b.updater(updater)
    jnet = JaxNet(b.list(*layers).set_input_type(JaxIT.feed_forward(n_in))
                  .build()).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    state_from_numpy(pnet, _np(jnet.state_tree))
    return jnet, pnet


def _x(shape, seed=0, binary=False):
    r = np.random.default_rng(seed).random(shape)
    return (r > 0.5).astype(np.float64) if binary else r


# ---------------------------------------------------------- flat view
def test_params_equal_jax_and_set_params_copies_in_place():
    jnet, pnet = _pair([jl.DenseLayer(n_out=5, activation="tanh"),
                        jl.BatchNormalization(),
                        jl.VariationalAutoencoder(n_out=2,
                                                  encoder_sizes=(3, 4)),
                        jl.OutputLayer(n_out=3, activation="softmax")], 4)
    flat = pnet.params()
    np.testing.assert_array_equal(flat.numpy(), jnet.params())
    assert pnet.num_params() == jnet.num_params() == flat.shape[0]
    ptrs = [t.data_ptr() for t in _leaves(pnet.params_tree)]
    new = np.random.default_rng(1).standard_normal(flat.shape[0])
    pnet.set_params(new)
    jnet.set_params(new)
    np.testing.assert_array_equal(pnet.params().numpy(), new)
    assert ptrs == [t.data_ptr() for t in _leaves(pnet.params_tree)]
    _close(pnet.params_tree, jnet.params_tree, rtol=0, atol=0)
    x = _x((6, 4))
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)
    with pytest.raises(ValueError, match="flat vector"):
        pnet.set_params(new[:-1])


def _leaves(tree):
    from deeplearning4j_tpu_torch.utils.pytrees import ravel_leaves
    return ravel_leaves(tree)


def test_conv_params_share_jax_layout():
    """Convolution kernels are HWIO in both packages: the flat vectors
    agree and a vector set on one side gives the other's output."""
    conf = (JaxNNC.builder().seed(2).dtype("float64")
            .list(jl.ConvolutionLayer(n_out=3, kernel=(3, 2),
                                      activation="relu"),
                  jl.OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(JaxIT.convolutional(5, 4, 2)).build())
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.set_params(jnet.params())
    _close(pnet.params_tree, jnet.params_tree, rtol=0, atol=0)
    x = _x((3, 5, 4, 2))
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)


# ------------------------------------------------------------- layers
def _grads(fn, params):
    live = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True),
                                  params)
    val = fn(live)
    leaves = jax.tree_util.tree_leaves(live)
    gs = torch.autograd.grad(val, leaves)
    return val.detach(), jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(live), list(gs))


def test_loss_and_prelu_layers_match_jax():
    jl_, pl_ = jl.LossLayer(loss="mse", activation="tanh"), \
        pff.LossLayer(loss="mse", activation="tanh")
    x, y = _x((4, 3)), _x((4, 3), 1)
    np.testing.assert_allclose(
        float(pl_.score({}, torch.tensor(x), torch.tensor(y))),
        float(jl_.score({}, jnp.asarray(x), jnp.asarray(y))), **TOL)
    np.testing.assert_allclose(pl_.apply({}, torch.tensor(x))[0].numpy(),
                               np.tanh(x), **TOL)
    jp = jl.PReLULayer().infer_n_in(JaxIT.convolutional(2, 2, 3))
    pp = pff.PReLULayer().infer_n_in(
        pff.InputType.convolutional(2, 2, 3))
    assert jp.n_out == pp.n_out == 3
    alpha = np.array([0.1, -0.2, 0.3])
    xc = np.random.default_rng(2).standard_normal((2, 2, 2, 3))
    np.testing.assert_allclose(
        pp.apply({"alpha": torch.tensor(alpha)}, torch.tensor(xc))[0].numpy(),
        np.asarray(jp.apply({"alpha": jnp.asarray(alpha)},
                            jnp.asarray(xc))[0]), **TOL)
    p, _ = pp.init_params(None, None, torch.float64)
    assert p["alpha"].tolist() == [0.0, 0.0, 0.0]


def test_frozen_layer_applies_inner_and_passes_no_gradient():
    inner = pff.DenseLayer(n_in=3, n_out=2, activation="tanh")
    fr = psp.FrozenLayer(layer=inner)
    assert fr.frozen
    p = {"W": torch.randn(3, 2, dtype=torch.float64, requires_grad=True),
         "b": torch.zeros(2, dtype=torch.float64, requires_grad=True)}
    x = torch.tensor(_x((4, 3)))
    y, _ = fr.apply(p, x)
    torch.testing.assert_close(y, inner.apply(p, x)[0])
    assert not y.requires_grad
    jy, _ = jl.FrozenLayer(layer=jl.DenseLayer(
        n_in=3, n_out=2, activation="tanh")).apply(
        _np({k: v.detach().numpy() for k, v in p.items()}), jnp.asarray(
            x.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_center_loss_score_and_centers_match_jax():
    jc = jl.CenterLossOutputLayer(n_in=4, n_out=3, activation="softmax",
                                  alpha=0.25, lambda_=0.5)
    pc = psp.CenterLossOutputLayer(n_in=4, n_out=3, activation="softmax",
                                   alpha=0.25, lambda_=0.5)
    rng = np.random.default_rng(3)
    params = {"W": rng.standard_normal((4, 3)), "b": rng.standard_normal(3)}
    state = {"centers": rng.standard_normal((3, 4))}
    x = rng.standard_normal((6, 4))
    y = np.eye(3)[rng.integers(0, 3, 6)]
    jloss, jst = jc.score_and_state(_np(params), jnp.asarray(x),
                                    jnp.asarray(y), _np(state))
    jg = jax.grad(lambda p: jc.score_and_state(
        p, jnp.asarray(x), jnp.asarray(y), _np(state))[0])(_np(params))
    pst = {}

    def f(p):
        loss, pst["s"] = pc.score_and_state(p, torch.tensor(x),
                                            torch.tensor(y), _t(state))
        return loss

    ploss, pg = _grads(f, _t(params))
    np.testing.assert_allclose(float(ploss), float(jloss), **TOL)
    _close(pst["s"], jst)
    _close(pg, jg)
    p, st = pc.init_params(torch.Generator().manual_seed(0), None,
                           torch.float64)
    assert st["centers"].shape == (3, 4) and not st["centers"].any()


def test_autoencoder_score_with_jax_corruption(monkeypatch):
    jae = jl.AutoEncoder(n_in=6, n_out=4, activation="sigmoid",
                         corruption_level=0.4)
    pae = pff.AutoEncoder(n_in=6, n_out=4, activation="sigmoid",
                          corruption_level=0.4)
    rng = np.random.default_rng(4)
    params = {"W": rng.standard_normal((6, 4)), "b": rng.standard_normal(4),
              "vb": rng.standard_normal(6)}
    x = _x((5, 6), 5)
    key = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(key, 0.6, x.shape))
    monkeypatch.setattr(pff, "_keep_mask",
                        lambda gen, k, shape, dev: torch.tensor(keep))
    gen = torch.Generator()
    jv, jg = jax.value_and_grad(lambda p: jae.reconstruction_score(
        p, jnp.asarray(x), rng=key))(_np(params))
    pv, pg = _grads(lambda p: pae.reconstruction_score(
        p, torch.tensor(x), rng=gen), _t(params))
    np.testing.assert_allclose(float(pv), float(jv), **TOL)
    _close(pg, jg)
    # no generator (or level 0): no corruption, and no draw
    monkeypatch.setattr(pff, "_keep_mask", None)
    np.testing.assert_allclose(
        float(pae.reconstruction_score(_t(params), torch.tensor(x))),
        float(jae.reconstruction_score(_np(params), jnp.asarray(x))), **TOL)


def test_rbm_cd2_score_with_jax_draws(monkeypatch):
    jr, pr = jl.RBM(n_in=6, n_out=4, k=2), psp.RBM(n_in=6, n_out=4, k=2)
    rng = np.random.default_rng(6)
    params = {"W": rng.standard_normal((6, 4)), "hb": rng.standard_normal(4),
              "vb": rng.standard_normal(6)}
    v0 = _x((5, 6), 7, binary=True)
    key = jax.random.PRNGKey(3)
    us, k = [], key
    for _ in range(2):
        k, k1, _ = jax.random.split(k, 3)
        us.append(torch.tensor(np.asarray(
            jax.random.uniform(k1, (5, 4), jnp.float64))))
    draws = list(us)
    monkeypatch.setattr(psp, "_bernoulli",
                        lambda gen, p: (draws.pop(0) < p).to(p.dtype))
    jv, jg = jax.value_and_grad(lambda p: jr.reconstruction_score(
        p, jnp.asarray(v0), rng=key))(_np(params))
    pv, pg = _grads(lambda p: pr.reconstruction_score(
        p, torch.tensor(v0), rng=None), _t(params))
    assert not draws
    np.testing.assert_allclose(float(pv), float(jv), **TOL)
    _close(pg, jg)
    np.testing.assert_allclose(
        pr.apply(_t(params), torch.tensor(v0))[0].numpy(),
        np.asarray(jr.apply(_np(params), jnp.asarray(v0))[0]), **TOL)


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_vae_elbo_with_jax_draws(monkeypatch, dist):
    kw = dict(n_in=5, n_out=2, encoder_sizes=(4, 3), decoder_sizes=(3,),
              reconstruction_distribution=dist, num_samples=2,
              activation="tanh")
    jv_, pv_ = jl.VariationalAutoencoder(**kw), \
        psp.VariationalAutoencoder(**kw)
    jp, _ = jv_.init_params(jax.random.PRNGKey(1), None, jnp.float64)
    pp, _ = pv_.init_params(torch.Generator().manual_seed(0), None,
                            torch.float64)
    assert jax.tree_util.tree_map(np.shape, _np(jp)) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), pp)
    x = _x((4, 5), 8, binary=dist == "bernoulli")
    key = jax.random.PRNGKey(5)
    eps, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        eps.append(torch.tensor(np.asarray(
            jax.random.normal(sub, (4, 2), jnp.float64))))
    monkeypatch.setattr(psp, "_eps", lambda gen, shape, dt, dev: eps.pop(0))
    jv, jg = jax.value_and_grad(lambda p: jv_.reconstruction_score(
        p, jnp.asarray(x), rng=key))(jp)
    pv, pg = _grads(lambda p: pv_.reconstruction_score(
        p, torch.tensor(x)), _t(jp))
    assert not eps
    np.testing.assert_allclose(float(pv), float(jv), **TOL)
    _close(pg, jg)
    np.testing.assert_allclose(
        pv_.apply(_t(jp), torch.tensor(x))[0].numpy(),
        np.asarray(jv_.apply(jp, jnp.asarray(x))[0]), **TOL)


# ------------------------------------------------------- pretraining
UPDATERS = {"sgd": lambda m: m.Sgd(0.25),
            "nesterovs": lambda m: m.Nesterovs(0.25, 0.5)}


def _ae_layers(m):
    return [m.DenseLayer(n_out=7, activation="tanh"),
            m.AutoEncoder(n_out=5, activation="sigmoid",
                          corruption_level=0.0),
            m.OutputLayer(n_out=2, activation="softmax")]


@pytest.mark.parametrize("upd", sorted(UPDATERS))
def test_sequential_pretrain_matches_jax(upd):
    from deeplearning4j_tpu_torch.nn import layers as pl
    from deeplearning4j_tpu_torch.optim import updaters as pu

    jnet, pnet = _pair(_ae_layers(jl), 6, UPDATERS[upd](ju))
    assert isinstance(pnet.conf.layers[1], pl.AutoEncoder)
    assert pnet._layer_updaters[pnet.conf.layers[1].name] == \
        UPDATERS[upd](pu)
    x = _x((40, 6), 9)
    jnet.pretrain(x, epochs=1, batch_size=8)
    pnet.pretrain(x, epochs=1, batch_size=8)
    assert len(pnet.pretrain_losses["layer1_autoencoder"]) == 5
    _close(pnet.params_tree, jnet.params_tree, rtol=0, atol=1e-9)


def _ae_graph(m, nnc, it, upd):
    g = (nnc.builder().seed(0).dtype("float64").updater(upd)
         .graph_builder().add_inputs("in").set_input_types(
             it.feed_forward(6)))
    a, ae, out = _ae_layers(m)
    g.add_layer("dense", a, "in")
    g.add_layer("ae", ae, "dense")
    g.add_layer("out", out, "ae")
    g.set_outputs("out")
    return g.build()


@pytest.mark.parametrize("upd", sorted(UPDATERS))
def test_graph_pretrain_matches_jax(upd):
    """Once refused naming A1: a ComputationGraph pretrains its
    AutoEncoder vertex as JAX's does."""
    jnet = JaxGraph(_ae_graph(jl, JaxNNC, JaxIT, UPDATERS[upd](ju))).init()
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    x = _x((40, 6), 10)
    jnet.pretrain(x, epochs=1, batch_size=8)
    pnet.pretrain(x, epochs=1, batch_size=8)
    assert len(pnet.pretrain_losses["ae"]) == 5
    _close(pnet.params_tree, jnet.params_tree, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pnet.params().numpy(), jnet.params(), rtol=0,
                               atol=1e-9)


def test_vae_and_rbm_pretraining_invariants():
    """JAX's `TestPretraining` on the port: the VAE's ELBO and the
    AutoEncoder's reconstruction fall, an RBM's weights move, the other
    layers stay put."""
    from deeplearning4j_tpu_torch.nn import layers as pl
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.optim.updaters import Adam, Sgd

    def net(layer, n_in, upd, act):
        return MultiLayerNetwork(
            NeuralNetConfiguration.builder().seed(0).updater(upd)
            .activation(act).list(layer, pl.OutputLayer(
                n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(n_in)).build(),
            device="cpu").init()

    x = torch.tensor((np.random.default_rng(0).random((64, 12)) > 0.5)
                     .astype(np.float32))
    vnet = net(pl.VariationalAutoencoder(
        n_out=4, encoder_sizes=(16,), decoder_sizes=(16,),
        reconstruction_distribution="bernoulli"), 12, Adam(1e-2), "tanh")
    vae = vnet.conf.layers[0]

    def elbo():
        return float(vae.reconstruction_score(
            vnet.params_tree[vae.name], x,
            rng=torch.Generator().manual_seed(0)))

    out_w = vnet.params_tree[vnet.conf.layers[1].name]["W"].clone()
    e0 = elbo()
    vnet.pretrain(x.numpy(), epochs=20, batch_size=32)
    assert elbo() < e0
    assert torch.equal(out_w, vnet.params_tree[vnet.conf.layers[1].name]["W"])
    ls = [float(v) for v in vnet.pretrain_losses[vae.name]]
    assert np.mean(ls[-4:]) < np.mean(ls[:4])

    anet = net(pl.AutoEncoder(n_out=8, corruption_level=0.0), 12,
               Adam(1e-2), "sigmoid")
    ae = anet.conf.layers[0]

    def rec():
        return float(ae.reconstruction_score(anet.params_tree[ae.name], x))

    r0 = rec()
    anet.pretrain(x.numpy(), epochs=30, batch_size=32)
    assert rec() < r0

    rnet = net(pl.RBM(n_out=6), 12, Sgd(0.05), None)
    w0 = rnet.params_tree[rnet.conf.layers[0].name]["W"].clone()
    rnet.pretrain(x.numpy(), epochs=5, batch_size=16)
    assert not torch.allclose(w0, rnet.params_tree[
        rnet.conf.layers[0].name]["W"])


def test_frozen_encoder_under_center_loss_head():
    """A pretrained encoder wrapped in FrozenLayers under a
    CenterLossOutputLayer: the fit leaves the frozen leaves bit-equal,
    moves the centers, and matches JAX's fit (center loss in `_loss`)."""
    layers = [jl.FrozenLayer(layer=jl.DenseLayer(n_out=5,
                                                 activation="tanh")),
              jl.DenseLayer(n_out=4, activation="tanh"),
              jl.CenterLossOutputLayer(n_out=3, activation="softmax",
                                       alpha=0.5, lambda_=0.25)]
    jnet, pnet = _pair(layers, 6, ju.Sgd(0.5))
    frozen = pnet.conf.layers[0].name
    assert pnet._layer_updaters[frozen].__class__.__name__ == "NoOp"
    w0 = {k: v.clone() for k, v in pnet.params_tree[frozen].items()}
    rng = np.random.default_rng(11)
    x, y = rng.random((16, 6)), np.eye(3)[rng.integers(0, 3, 16)]
    jnet.fit(x, y, epochs=2, batch_size=8)
    pnet.fit(x, y, epochs=2, batch_size=8)
    for k, v in pnet.params_tree[frozen].items():
        assert torch.equal(v, w0[k])
    head = pnet.conf.layers[2].name
    assert pnet.state_tree[head]["centers"].abs().sum() > 0
    _close(pnet.params_tree, jnet.params_tree, rtol=0, atol=1e-10)
    _close(pnet.state_tree, jnet.state_tree, rtol=0, atol=1e-10)
    np.testing.assert_allclose(pnet.score_, float(jnet.score_), **TOL)


def test_feed_forward_clone_and_listeners():
    jnet, pnet = _pair([jl.DenseLayer(n_out=4, activation="relu"),
                        jl.OutputLayer(n_out=2, activation="softmax")], 3,
                       ju.Sgd(0.5))
    x = _x((5, 3))
    acts = pnet.feed_forward(x)
    assert len(acts) == 2
    for a, b in zip(acts, jnet.feed_forward(x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    twin = pnet.clone()
    assert twin is not pnet and torch.equal(twin.params(), pnet.params())
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        _leaves(twin.params_tree), _leaves(pnet.params_tree)))
    one, two = CollectScoresIterationListener(), \
        CollectScoresIterationListener()
    pnet.set_listeners(one)
    pnet.add_listener(two)
    assert pnet.listeners == [one, two]
    pnet.fit(x, np.eye(2)[[0, 1, 0, 1, 1]], batch_size=5)
    assert len(one.scores) == len(two.scores) == 1
    assert not torch.equal(twin.params(), pnet.params())
