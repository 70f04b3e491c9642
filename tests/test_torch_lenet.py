"""The port's zoo CNNs against the JAX package's, on the CPU: LeNet,
SimpleCNN, VGG16 and VGG19 configurations (the JAX JSON loads in the
port and writes back byte-identical JSON; the port's own zoo writes the
same; equal parameter counts), LeNet's training under SGD, Adam and
Nesterovs (3 steps, float32, batch 16, on JAX's weights carried across
with `params_from_numpy`), SimpleCNN's `output()` (eval mode, JAX's
weights and running statistics) and its batch-norm running statistics
after a step, and AlexNet's configuration (its refusal until A2b).

Tolerances, float32: losses within 1e-5 relative; parameters within
2e-5 absolute after three steps (sums taken in another order, amplified
by Adam's division by √v; Adam runs with ε 1e-3, as in
`test_torch_training.py`); probabilities within 1e-5 absolute; running
statistics within 1e-5 relative (a variance over up to 18,432 float32 values
summed in another order)."""

import numpy as np
import pytest

import jax

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optim.listeners import (
    CollectScoresIterationListener as JaxScores,
)
from deeplearning4j_tpu.optim.updaters import (
    Adam as JaxAdam, Nesterovs as JaxNesterovs, Sgd as JaxSgd,
)
from deeplearning4j_tpu.zoo import models as jax_zoo
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, state_from_numpy,
)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.optim.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs, Sgd
from deeplearning4j_tpu_torch.zoo import ZOO_REGISTRY
from deeplearning4j_tpu_torch.zoo import models as zoo

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=0, atol=2e-5)
OUT_TOL = dict(rtol=0, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
CNNS = ["LeNet", "SimpleCNN", "VGG16", "VGG19"]
UPDATERS = {"sgd": (JaxSgd(0.1), Sgd(0.1)),
            "adam": (JaxAdam(1e-2, epsilon=1e-3), Adam(1e-2, epsilon=1e-3)),
            "nesterovs": (JaxNesterovs(0.01, 0.9), Nesterovs(0.01, 0.9))}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(port_tree, jax_tree, path="", **tol):
    """Nested dicts leaf by leaf (`()`, a stateless updater's state, on
    both sides)."""
    if isinstance(port_tree, dict):
        assert set(port_tree) == set(jax_tree), path
        for k, v in port_tree.items():
            _assert_trees(v, jax_tree[k], f"{path}/{k}", **tol)
    elif isinstance(port_tree, tuple):
        assert port_tree == () and len(jax_tree) == 0, path
    else:
        np.testing.assert_allclose(port_tree.detach().float().numpy(),
                                   np.asarray(jax_tree), **tol, err_msg=path)


def _pair(name, updaters=None, **kw):
    """The JAX net and the port's on the CPU with JAX's weights and
    state; `updaters` = (JAX's, the port's) replaces the default."""
    jkw, pkw = dict(kw), dict(kw)
    if updaters is not None:
        jkw["updater"], pkw["updater"] = updaters
    jnet = JaxNet(getattr(jax_zoo, name)(**jkw).conf()).init()
    pnet = MultiLayerNetwork(getattr(zoo, name)(**pkw).conf(),
                             device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    state_from_numpy(pnet, _np(jnet.state_tree))
    return jnet, pnet


def _images(rng, n, shape, classes=10):
    x = rng.random((n,) + shape, dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


@pytest.mark.parametrize("name", CNNS)
def test_jax_config_loads_and_writes_back_the_same_json(name):
    jax_json = getattr(jax_zoo, name)().conf().to_json()
    assert MultiLayerConfiguration.from_json(jax_json).to_json() == jax_json
    assert getattr(zoo, name)().conf().to_json() == jax_json
    assert name.lower() in ZOO_REGISTRY


@pytest.mark.parametrize("name", CNNS)
def test_parameter_count_matches_jax(name):
    """At a 32x32x3 input and 10 classes for the VGGs (the same layers;
    224x224 would hold 138M parameters in each package)."""
    kw = ({} if name in ("LeNet", "SimpleCNN")
          else dict(input_shape=(32, 32, 3), num_classes=10))
    jnet, pnet = _pair(name, **kw)
    assert pnet.num_params() == jnet.num_params()
    if name == "LeNet":
        assert pnet.num_params() == 431_080


def test_lenet_defaults():
    conf = zoo.LeNet().conf()
    assert conf.updater == Adam(1e-3)
    assert conf.input_type.kind == "cnn_flat"
    assert list(conf.preprocessors) == [0, 4]


@pytest.mark.parametrize("updater", list(UPDATERS))
def test_lenet_three_steps_match_jax(updater):
    jnet, pnet = _pair("LeNet", UPDATERS[updater])
    x, y = _images(np.random.default_rng(3), 16, (784,))
    js, ps = JaxScores(), CollectScoresIterationListener()
    jnet.listeners.append(js)
    pnet.listeners.append(ps)
    jnet.fit(x, y, batch_size=16, epochs=3)
    pnet.fit(x, y, batch_size=16, epochs=3)
    np.testing.assert_allclose([s for _, s in ps.scores],
                               [s for _, s in js.scores], **LOSS_TOL)
    _assert_trees(pnet.params_tree, jnet.params_tree, **PARAM_TOL)
    _assert_trees(pnet.updater_state, jnet.updater_state, **PARAM_TOL)
    assert pnet.iteration == jnet.iteration == 3


def test_simplecnn_output_matches_jax():
    jnet, pnet = _pair("SimpleCNN")
    x, _ = _images(np.random.default_rng(4), 4, (48, 48, 3))
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **OUT_TOL)
    np.testing.assert_array_equal(pnet.predict(x), np.asarray(jnet.predict(x)))


def test_simplecnn_running_statistics_after_a_step_match_jax():
    """The batch norms sit before the dropout, so their running
    statistics after one step do not depend on its draw."""
    jnet, pnet = _pair("SimpleCNN", (JaxSgd(0.01), Sgd(0.01)))
    x, y = _images(np.random.default_rng(5), 8, (48, 48, 3))
    jnet.fit(x, y, batch_size=8, epochs=1)
    pnet.fit(x, y, batch_size=8, epochs=1)
    bn = [n for n in pnet.state_tree if pnet.state_tree[n]]
    assert len(bn) == 4
    for n in bn:
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                pnet.state_tree[n][k].numpy(),
                np.asarray(jnet.state_tree[n][k]), **STATE_TOL,
                err_msg=f"{n}/{k}")
        assert not np.allclose(pnet.state_tree[n]["var"].numpy(), 1.0)


def test_alexnet_refuses_naming_a2b():
    """AlexNet refused naming A2b until its LocalResponseNormalization
    was ported; now its configuration is JAX's and it builds."""
    conf = zoo.AlexNet().conf()
    assert conf.to_json() == jax_zoo.AlexNet().conf().to_json()
    assert "alexnet" in ZOO_REGISTRY


def test_quickstart_zoo_fit_evaluate_save_load(tmp_path, monkeypatch):
    """The README's LeNet flow on the CPU, on the synthetic surrogate:
    zoo → fit → evaluate → save_model → load_model, which resumes at the
    saved iteration with the same outputs."""
    from deeplearning4j_tpu_torch.data import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.serialize import (
        load_model, save_model,
    )

    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "none"))
    lenet = zoo.LeNet().init(device="cpu")
    train = MnistDataSetIterator(64, num_examples=256)
    assert train.synthetic
    test = MnistDataSetIterator(100, train=False, num_examples=300,
                                shuffle=False)
    first = lenet.score(next(iter(test)))
    lenet.fit(train, epochs=2)
    assert lenet.score(next(iter(test))) < first
    ev = lenet.evaluate(test)
    assert ev.confusion.matrix.sum() == 300
    save_model(lenet, tmp_path / "lenet.zip")
    back = load_model(tmp_path / "lenet.zip", device="cpu")
    assert (back.iteration, back.epoch) == (8, 2)
    x = next(iter(test)).features
    np.testing.assert_array_equal(back.output(x).numpy(),
                                  lenet.output(x).numpy())
    assert back.evaluate(test).stats() == ev.stats()
