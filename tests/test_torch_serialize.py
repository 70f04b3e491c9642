"""Model files between the port and the JAX package, on the CPU: a LeNet
saved by JAX (float32, trained two Adam steps, so with moments) loads in
the port with equal trees, `iteration` and `epoch`, and the port's file
loads in JAX the same way; both zips hold the same members, npz keys and
dtypes; a JAX bfloat16 file loads in the port bit for bit (and the
port's own bfloat16 file round-trips), which JAX's own `load_model`
refuses (ROADMAP C8, shown here on the JAX package as it is); a JAX file
saved mid-training resumes in the port with the next two losses of
JAX's own continuation; a ComputationGraph with batch-norm state
round-trips.

Tolerances: trees read from a file are bit-equal to what was written;
`output()` within 1e-6 absolute (float32 probabilities from sums in
another order); resumed losses within 1e-5 relative and parameters
within 2e-5 absolute (as `test_torch_training.py`, Adam at ε 1e-3)."""

import dataclasses
import io
import zipfile

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.models import serialize as jser
from deeplearning4j_tpu.optim.listeners import (
    CollectScoresIterationListener as JaxScores,
)
from deeplearning4j_tpu.optim.updaters import Adam as JaxAdam
from deeplearning4j_tpu.zoo import models as jax_zoo
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.models import serialize as pser
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization, ConvolutionLayer, GlobalPoolingLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.optim.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.optim.updaters import Adam, Sgd, tree_leaves
from deeplearning4j_tpu_torch.zoo import models as zoo

OUT_TOL = dict(rtol=0, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=0, atol=2e-5)
MEMBERS = ["configuration.json", "coefficients.npz", "netState.npz",
           "updaterState.npz", "metadata.json"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a JAX tree or a port tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        return {}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return {prefix[:-1]: (t.view(torch.int16).numpy()
                              if t.dtype == torch.bfloat16 else t.numpy())}
    a = np.asarray(tree)
    return {prefix[:-1]: a.view(np.int16) if a.dtype.itemsize == 2
            and a.dtype.kind not in "iuf" else a}


def _assert_bit_equal(port_tree, jax_tree):
    p, j = _flat(port_tree), _flat(jax_tree)
    assert sorted(p) == sorted(j)
    for k in p:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def _trained_jax_lenet(steps=2, dtype="float32"):
    conf = jax_zoo.LeNet(updater=JaxAdam(1e-2, epsilon=1e-3)).conf()
    conf = dataclasses.replace(conf, dtype=dtype)
    net = JaxNet(conf).init()
    x, y = _data(0)
    net.fit(x, y, batch_size=16, epochs=steps)
    return net


def _data(seed, n=16):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 784), dtype=np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]


def _npz_layout(path):
    with zipfile.ZipFile(path) as zf:
        names = sorted(zf.namelist())
        npz = {}
        for n in names:
            if n.endswith(".npz"):
                z = np.load(io.BytesIO(zf.read(n)))
                npz[n] = {k: z[k].dtype.kind + str(z[k].dtype.itemsize)
                          for k in z.files}
    return names, npz


def test_jax_file_loads_in_the_port(tmp_path):
    jnet = _trained_jax_lenet()
    jser.save_model(jnet, tmp_path / "j.zip")
    pnet = pser.load_model(tmp_path / "j.zip", device="cpu")
    assert isinstance(pnet, MultiLayerNetwork)
    assert (pnet.iteration, pnet.epoch) == (jnet.iteration, jnet.epoch) \
        == (2, 2)
    _assert_bit_equal(pnet.params_tree, jnet.params_tree)
    _assert_bit_equal(pnet.updater_state, jnet.updater_state)
    x, _ = _data(1, 8)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **OUT_TOL)


def test_port_file_loads_in_jax_with_the_same_layout(tmp_path):
    jnet = _trained_jax_lenet()
    pnet = MultiLayerNetwork(zoo.LeNet(updater=Adam(1e-2, epsilon=1e-3))
                             .conf(), device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    x, y = _data(0)
    pnet.fit(x, y, batch_size=16, epochs=2)
    pser.save_model(pnet, tmp_path / "p.zip")
    jser.save_model(jnet, tmp_path / "j.zip")
    back = jser.load_model(tmp_path / "p.zip")
    assert (back.iteration, back.epoch) == (2, 2)
    _assert_bit_equal(pnet.params_tree, back.params_tree)
    _assert_bit_equal(pnet.updater_state, back.updater_state)
    xo, _ = _data(1, 8)
    np.testing.assert_allclose(np.asarray(back.output(xo)),
                               pnet.output(xo).numpy(), **OUT_TOL)
    names, layout = _npz_layout(tmp_path / "p.zip")
    assert names == sorted(MEMBERS)
    assert (names, layout) == _npz_layout(tmp_path / "j.zip")
    assert "layer0_convolutionlayer/m/W" in layout["updaterState.npz"]


def test_jax_bfloat16_file_loads_bit_equal(tmp_path):
    jnet = _trained_jax_lenet(steps=1, dtype="bfloat16")
    jser.save_model(jnet, tmp_path / "j16.zip")
    _, layout = _npz_layout(tmp_path / "j16.zip")
    assert set(layout["coefficients.npz"].values()) == {"V2"}
    pnet = pser.load_model(tmp_path / "j16.zip", device="cpu")
    assert pnet.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in
               tree_leaves(pnet.params_tree))
    _assert_bit_equal(pnet.params_tree, jnet.params_tree)
    _assert_bit_equal(pnet.updater_state, jnet.updater_state)
    pser.save_model(pnet, tmp_path / "p16.zip")
    assert _npz_layout(tmp_path / "p16.zip") == _npz_layout(
        tmp_path / "j16.zip")
    again = pser.load_model(tmp_path / "p16.zip", device="cpu")
    _assert_bit_equal(again.params_tree, jnet.params_tree)
    x, _ = _data(2, 4)
    assert torch.equal(again.output(x), pnet.output(x))


def test_jax_cannot_load_its_own_bfloat16_file(tmp_path):
    """Reference-side fault C8, on the JAX package as it is: its
    `load_model` hands the raw 2-byte leaves to `jnp.asarray`."""
    jser.save_model(_trained_jax_lenet(steps=1, dtype="bfloat16"),
                    tmp_path / "j16.zip")
    with pytest.raises(TypeError, match="V2"):
        jser.load_model(tmp_path / "j16.zip")


def test_a_raw_two_byte_leaf_only_loads_into_a_bfloat16_leaf():
    raw = {"W": np.arange(3, dtype=np.int16).view("V2")}
    got = pser._flat_dict_to_tree(
        raw, {"W": torch.zeros(3, dtype=torch.bfloat16)})
    assert got["W"].dtype == torch.bfloat16
    assert got["W"].view(torch.int16).tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="raw"):
        pser._flat_dict_to_tree(raw, {"W": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        pser._flat_dict_to_tree(
            raw, {"W": torch.zeros(4, dtype=torch.bfloat16)})


def test_resumed_trajectory_equals_jax(tmp_path):
    """Two Adam steps in JAX, saved; then two more in JAX and, from the
    file, two in the port: Adam's bias correction restarts from the
    file's iteration."""
    jnet = _trained_jax_lenet(steps=2)
    jser.save_model(jnet, tmp_path / "mid.zip")
    pnet = pser.load_model(tmp_path / "mid.zip", device="cpu")
    x, y = _data(3)
    js, ps = JaxScores(), CollectScoresIterationListener()
    jnet.listeners.append(js)
    pnet.listeners.append(ps)
    jnet.fit(x, y, batch_size=16, epochs=2)
    pnet.fit(x, y, batch_size=16, epochs=2)
    assert [i for i, _ in ps.scores] == [i for i, _ in js.scores] == [3, 4]
    np.testing.assert_allclose([s for _, s in ps.scores],
                               [s for _, s in js.scores], **LOSS_TOL)
    for k, v in _flat(pnet.params_tree).items():
        np.testing.assert_allclose(v, _flat(jnet.params_tree)[k],
                                   **PARAM_TOL, err_msg=k)


def _graph_conf():
    g = (NeuralNetConfiguration.builder().seed(5).updater(Sgd(0.05))
         .graph_builder().add_inputs("in")
         .set_input_types(InputType.convolutional(8, 8, 3)))
    g.add_layer("c", ConvolutionLayer(n_out=4, kernel=(3, 3)), "in")
    g.add_layer("b", BatchNormalization(activation="relu"), "c")
    g.add_layer("gap", GlobalPoolingLayer(pooling="avg"), "b")
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax"), "gap")
    g.set_outputs("out")
    return g.build()


def test_computation_graph_round_trips(tmp_path):
    net = ComputationGraph(_graph_conf(), device="cpu").init()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    net.fit(x, y, batch_size=4, epochs=2)
    pser.save_model(net, tmp_path / "g.zip")
    back = pser.load_model(tmp_path / "g.zip", device="cpu")
    assert isinstance(back, ComputationGraph)
    assert back.iteration == 2 and back.epoch == 2
    _assert_bit_equal(back.params_tree, net.params_tree)
    _assert_bit_equal(back.state_tree, net.state_tree)
    assert torch.equal(back.output(x), net.output(x))
    jback = jser.load_model(tmp_path / "g.zip")
    assert isinstance(jback, JaxGraph)
    _assert_bit_equal(net.state_tree, jback.state_tree)
    np.testing.assert_allclose(np.asarray(jback.output(x)),
                               net.output(x).numpy(), **OUT_TOL)
