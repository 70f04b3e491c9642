"""The port's Keras import against the JAX package's, on the CPU, over
every fixture `tests/test_keras_import.py` imports (the same files,
written here by the same builders) and the layers of slice 21.

For each `.h5` file both packages import: the configuration JSON is
byte-identical, every parameter and running statistic the file holds
lands equal in the net's float32 (bit for bit; JAX, under the tests'
float64 flag, keeps a float64 array of a file as float64), and the
predictions
on the same inputs agree within 1e-5 (float32; sums in another order).
A fixture whose layers take no weights from the file (initializers and
regularizers only, the config-only JSON and YAML imports) carries JAX's
weights across with `params_from_numpy` before its predictions are
compared. Errors (a causal padding, an unknown layer, a file without a
model) are raised by both with the same message text.

`Conv2DTranspose` (C15): the port maps Keras's kernel K [kh, kw, out, in]
to W = swap(flip(K)); its output equals `lax.conv_transpose(x, K,
transpose_kernel=True)` (Keras's own semantics) in "valid" and "same"
padding. JAX copies K as it is, so its layer reads K's out axis as its
input channels and refuses the input (reference-side)."""

import json

import h5py
import numpy as np
import pytest
import torch

import jax
from jax import lax

import test_keras_import as jk
from keras_fixtures import (
    _FunctionalH5Builder, make_dense_sequential_h5, make_inception_v3_h5,
)
from keras_fixtures import write_sequential_h5 as _seq_h5

from deeplearning4j_tpu import keras_import as jki
from deeplearning4j_tpu_torch import keras_import as pki
from deeplearning4j_tpu_torch.models.convert import params_from_numpy

OUT_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _out(y):
    y = y[0] if isinstance(y, (list, tuple)) else y
    return y.detach().numpy() if isinstance(y, torch.Tensor) else \
        np.asarray(y)


def _equal_trees(port, ref, path=""):
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            _equal_trees(port[k], ref[k], f"{path}/{k}")
    else:
        got = port.detach().numpy()
        np.testing.assert_array_equal(got, np.asarray(ref).astype(got.dtype),
                                      err_msg=path)


def _both(path):
    jnet = jki.import_keras_model_and_weights(path)
    pnet = pki.import_keras_model_and_weights(path, device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    return jnet, pnet


def _same_predictions(jnet, pnet, x):
    np.testing.assert_allclose(_out(pnet.output(x)), _out(jnet.output(x)),
                               **OUT_TOL)


# ------------------------------------------------------------ fixtures


def _dense_seq(p):
    jk._make_sequential_h5(p)
    return (5, 8)


def _functional(p):
    jk._make_functional_h5(p)
    return (4, 6)


def _dense_helper(p):
    make_dense_sequential_h5(p, scale=0.5)
    return (3, 8)


def _separable(p):
    rng = np.random.default_rng(4)
    cin, dm, cout = 3, 2, 5
    dk = rng.standard_normal((1, 1, cin, dm)).astype(np.float32)
    pk = rng.standard_normal((1, 1, cin * dm, cout)).astype(np.float32)
    pb = rng.standard_normal(cout).astype(np.float32)
    _seq_h5(p, [
        {"class_name": "SeparableConv2D",
         "config": {"name": "sep", "filters": cout, "kernel_size": [1, 1],
                    "strides": [1, 1], "padding": "same",
                    "depth_multiplier": dm, "use_bias": True,
                    "activation": "linear",
                    "batch_input_shape": [None, 4, 4, cin]}},
        {"class_name": "GlobalAveragePooling2D", "config": {"name": "g"}},
        {"class_name": "Dense",
         "config": {"name": "out", "units": 2, "activation": "softmax",
                    "use_bias": True}},
    ], {"sep": [dk, pk, pb],
        "out": [rng.standard_normal((cout, 2)).astype(np.float32),
                np.zeros(2, np.float32)]})
    return (2, 4, 4, cin)


def _gru(reset_after):
    def build(p):
        rng = np.random.default_rng(5 if reset_after else 9)
        F, H, T = 4, 3, 5
        K = rng.standard_normal((F, 3 * H)).astype(np.float32) * 0.5
        R = rng.standard_normal((H, 3 * H)).astype(np.float32) * 0.5
        bias = rng.standard_normal((2, 3 * H) if reset_after
                                   else (3 * H,)).astype(np.float32) * 0.1
        wo = rng.standard_normal((H, 2)).astype(np.float32)
        _seq_h5(p, [
            {"class_name": "GRU",
             "config": {"name": "gru", "units": H, "activation": "tanh",
                        "recurrent_activation": "sigmoid",
                        "reset_after": reset_after,
                        "return_sequences": False,
                        "batch_input_shape": [None, T, F]}},
            {"class_name": "Dense",
             "config": {"name": "out", "units": 2, "activation": "softmax",
                        "use_bias": True}},
        ], {"gru": [K, R, bias], "out": [wo, np.zeros(2, np.float32)]})
        return (2, T, F)
    return build


def _bidirectional(use_bias):
    def build(p):
        rng = np.random.default_rng(6 if use_bias else 11)
        F, H, T = 3, 4, 5
        n = 3 if use_bias else 2
        shapes = [(F, 4 * H), (H, 4 * H), (4 * H,)][:n]
        wf = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in shapes]
        wb = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in shapes]
        inner = {"units": H, "activation": "tanh",
                 "recurrent_activation": "sigmoid",
                 "return_sequences": not use_bias}
        if not use_bias:
            inner["use_bias"] = False
        layers = [{"class_name": "Bidirectional",
                   "config": {"name": "bi", "merge_mode": "concat",
                              "layer": {"class_name": "LSTM",
                                        "config": inner},
                              "batch_input_shape": [None, T, F]}}]
        if not use_bias:
            layers.append({"class_name": "GlobalAveragePooling1D",
                           "config": {"name": "g"}})
        layers.append({"class_name": "Dense",
                       "config": {"name": "out", "units": 2,
                                  "activation": "softmax",
                                  "use_bias": True}})
        _seq_h5(p, layers,
                {"bi": wf + wb,
                 "out": [rng.standard_normal((2 * H, 2)).astype(np.float32),
                         np.zeros(2, np.float32)]})
        return (2, T, F)
    return build


def _prelu(p):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    alpha = np.abs(rng.standard_normal(6).astype(np.float32))
    wo = rng.standard_normal((6, 3)).astype(np.float32)
    _seq_h5(p, [
        {"class_name": "Dense",
         "config": {"name": "d", "units": 6, "activation": "linear",
                    "use_bias": False, "batch_input_shape": [None, 4]}},
        {"class_name": "LeakyReLU", "config": {"name": "lr", "alpha": 0.2}},
        {"class_name": "PReLU", "config": {"name": "pr"}},
        {"class_name": "Dense",
         "config": {"name": "out", "units": 3, "activation": "softmax",
                    "use_bias": True}},
    ], {"d": [w], "pr": [alpha], "out": [wo, np.zeros(3, np.float32)]})
    return (3, 4)


def _conv1d(p):
    rng = np.random.default_rng(8)
    k = rng.standard_normal((3, 2, 4)).astype(np.float32)
    wo = rng.standard_normal((4, 2)).astype(np.float32)
    _seq_h5(p, [
        {"class_name": "Conv1D",
         "config": {"name": "c", "filters": 4, "kernel_size": [3],
                    "strides": [1], "padding": "same",
                    "activation": "relu", "use_bias": True,
                    "batch_input_shape": [None, 8, 2]}},
        {"class_name": "MaxPooling1D",
         "config": {"name": "mp", "pool_size": [2], "strides": [2],
                    "padding": "valid"}},
        {"class_name": "GlobalAveragePooling1D", "config": {"name": "g"}},
        {"class_name": "Dense",
         "config": {"name": "out", "units": 2, "activation": "softmax",
                    "use_bias": True}},
    ], {"c": [k, np.zeros(4, np.float32)],
        "out": [wo, np.zeros(2, np.float32)]})
    return (2, 8, 2)


def _cnn_a2b(p):
    """The slice's layers with weights from the file: a 3x3 depthwise
    convolution at multiplier 2 (the [kh, kw, in, mult] reshape),
    UpSampling2D, Cropping2D, AveragePooling1D after a Conv1D is covered
    above; GaussianNoise is dropped."""
    rng = np.random.default_rng(12)
    dk = rng.standard_normal((3, 3, 3, 2)).astype(np.float32) * 0.3
    db = rng.standard_normal(6).astype(np.float32) * 0.1
    ck = rng.standard_normal((3, 3, 6, 4)).astype(np.float32) * 0.2
    wo = rng.standard_normal((4, 3)).astype(np.float32)
    _seq_h5(p, [
        {"class_name": "DepthwiseConv2D",
         "config": {"name": "dw", "kernel_size": [3, 3], "strides": [1, 1],
                    "padding": "same", "depth_multiplier": 2,
                    "activation": "relu", "use_bias": True,
                    "batch_input_shape": [None, 6, 5, 3]}},
        {"class_name": "GaussianNoise", "config": {"name": "gn",
                                                   "stddev": 0.1}},
        {"class_name": "UpSampling2D", "config": {"name": "up",
                                                  "size": [2, 2]}},
        {"class_name": "Cropping2D", "config": {"name": "cr",
                                                "cropping": [[1, 2],
                                                             [0, 1]]}},
        {"class_name": "Conv2D",
         "config": {"name": "c", "filters": 4, "kernel_size": [3, 3],
                    "strides": [2, 2], "padding": "valid",
                    "activation": "tanh", "use_bias": False}},
        {"class_name": "GlobalMaxPooling2D", "config": {"name": "g"}},
        {"class_name": "Dense",
         "config": {"name": "out", "units": 3, "activation": "softmax",
                    "use_bias": True}},
    ], {"dw": [dk, db], "c": [ck], "out": [wo, np.zeros(3, np.float32)]})
    return (2, 6, 5, 3)


def _merge(kind, mode=None):
    """A functional model joining two dense branches through one Keras
    merge layer (Keras 1 `Merge` with its mode, or the Keras 2 layer)."""
    def build(p):
        b = _FunctionalH5Builder(seed=13)
        x = b.input((6,))
        branches = []
        for n in ("da", "db"):
            w = b.rng.standard_normal((6, 4)).astype(np.float32)
            branches.append(b.add("Dense", {"units": 4, "activation": "tanh",
                                            "use_bias": True}, [x], name=n,
                                  weights=[w, np.zeros(4, np.float32)]))
        cfg = {"mode": mode} if mode else {}
        m = b.add(kind, cfg, branches, name="merge")
        width = 8 if (mode or kind) in ("concat", "Concatenate") else 4
        w = b.rng.standard_normal((width, 3)).astype(np.float32)
        out = b.add("Dense", {"units": 3, "activation": "softmax",
                              "use_bias": True}, [m], name="out",
                    weights=[w, np.zeros(3, np.float32)])
        b.finish(p, out)
        return (4, 6)
    return build


FIXTURES = {
    "sequential_dense": _dense_seq,
    "functional_concat": _functional,
    "dense_sequential_helper": _dense_helper,
    "separable_conv": _separable,
    "gru_reset_after": _gru(True),
    "gru_reset_before": _gru(False),
    "bidirectional_lstm": _bidirectional(True),
    "bidirectional_lstm_no_bias": _bidirectional(False),
    "leaky_relu_prelu": _prelu,
    "conv1d_pooling1d": _conv1d,
    "depthwise_upsampling_cropping_noise": _cnn_a2b,
    "keras1_merge_concat": _merge("Merge", "concat"),
    "keras1_merge_sum": _merge("Merge", "sum"),
    "keras1_merge_mul": _merge("Merge", "mul"),
    "keras1_merge_ave": _merge("Merge", "ave"),
    "add": _merge("Add"),
    "subtract": _merge("Subtract"),
    "concatenate": _merge("Concatenate"),
    "average": _merge("Average"),
    "multiply": _merge("Multiply"),
    "maximum": _merge("Maximum"),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_h5_fixture_imports_as_jax_imports_it(name, tmp_path):
    p = str(tmp_path / f"{name}.h5")
    shape = FIXTURES[name](p)
    jnet, pnet = _both(p)
    _equal_trees(pnet.params_tree, _np(jnet.params_tree))
    _equal_trees(pnet.state_tree, _np(jnet.state_tree))
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _same_predictions(jnet, pnet, x)


def test_gaussian_noise_is_dropped(tmp_path):
    p = str(tmp_path / "gn.h5")
    _cnn_a2b(p)
    _, pnet = _both(p)
    names = [type(l).__name__ for l in pnet.conf.layers]
    assert names[:3] == ["DepthwiseConvolution2DLayer", "Upsampling2DLayer",
                         "Cropping2DLayer"]


def test_inception_v3_fixture_imports_as_jax_imports_it(tmp_path):
    p = str(tmp_path / "inception_v3.h5")
    make_inception_v3_h5(p, scale=16, classes=8, input_size=75)
    jnet, pnet = _both(p)
    _equal_trees(pnet.params_tree, _np(jnet.params_tree))
    _equal_trees(pnet.state_tree, _np(jnet.state_tree))
    x = np.random.default_rng(0).standard_normal(
        (2, 75, 75, 3)).astype(np.float32)
    _same_predictions(jnet, pnet, x)


def test_imported_model_trains_as_jax_trains(tmp_path):
    """The imported dense model's 5 epochs of `fit` (the JAX test's
    trainability fixture) under both packages' default updater."""
    p = str(tmp_path / "seq.h5")
    jk._make_sequential_h5(p)
    jnet, pnet = _both(p)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    s0 = pnet.score(x, y)
    np.testing.assert_allclose(s0, jnet.score(x, y), rtol=1e-6)
    jnet.fit(x, y, epochs=5, batch_size=16)
    pnet.fit(x, y, epochs=5, batch_size=16)
    assert pnet.score(x, y) < s0
    np.testing.assert_allclose(pnet.score(x, y), jnet.score(x, y),
                               rtol=1e-5)


def test_initializers_and_regularizers_import_as_jax(tmp_path):
    p = str(tmp_path / "reg.h5")
    _seq_h5(p, [
        {"class_name": "Dense",
         "config": {"name": "d", "units": 4, "activation": "relu",
                    "use_bias": True,
                    "kernel_initializer": {"class_name": "GlorotUniform",
                                           "config": {}},
                    "kernel_regularizer": {"class_name": "L1L2",
                                           "config": {"l1": 0.01,
                                                      "l2": 0.02}},
                    "bias_regularizer": {"class_name": "L1L2",
                                         "config": {"l1": 0.0,
                                                    "l2": 0.005}},
                    "batch_input_shape": [None, 3]}},
        {"class_name": "Dense",
         "config": {"name": "out", "units": 2, "activation": "softmax",
                    "use_bias": True,
                    "kernel_initializer": {
                        "class_name": "VarianceScaling",
                        "config": {"scale": 2.0, "mode": "fan_in",
                                   "distribution": "truncated_normal"}}}},
    ], {})
    jnet, pnet = _both(p)
    d = pnet.conf.layers[0]
    assert (d.weight_init, d.l1, d.l2, d.l2_bias) == (
        "xavier_uniform", 0.01, 0.02, 0.005)
    assert pnet.conf.layers[1].weight_init == "relu"
    params_from_numpy(pnet, _np(jnet.params_tree))
    x = np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
    np.testing.assert_allclose(pnet.score(x, y), jnet.score(x, y), rtol=1e-6)
    _same_predictions(jnet, pnet, x)


YAML_SEQ = """
class_name: Sequential
config:
  layers:
  - class_name: Dense
    config:
      name: d1
      units: 10
      activation: relu
      use_bias: true
      batch_input_shape: [null, 6]
  - class_name: Dense
    config:
      name: d2
      units: 3
      activation: softmax
      use_bias: true
"""

JSON_FUNCTIONAL = json.dumps({
    "class_name": "Model",
    "config": {
        "layers": [
            {"class_name": "InputLayer", "name": "in",
             "config": {"name": "in", "batch_input_shape": [None, 5]},
             "inbound_nodes": []},
            {"class_name": "Dense", "name": "out",
             "config": {"name": "out", "units": 2,
                        "activation": "softmax", "use_bias": True},
             "inbound_nodes": [[["in", 0, 0, {}]]]},
        ],
        "input_layers": [["in", 0, 0]],
        "output_layers": [["out", 0, 0]],
    },
})


@pytest.mark.parametrize("text,shape", [(YAML_SEQ, (2, 6)),
                                        (JSON_FUNCTIONAL, (3, 5))],
                         ids=["yaml_sequential", "json_functional"])
def test_configuration_only_import_matches_jax(text, shape, tmp_path):
    jnet = jki.import_keras_configuration(text)
    pnet = pki.import_keras_configuration(text, device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    params_from_numpy(pnet, _np(jnet.params_tree))
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    _same_predictions(jnet, pnet, x)
    f = tmp_path / "conf.txt"
    f.write_text(text)
    assert pki.import_keras_configuration(
        str(f), device="cpu").conf.to_json() == jnet.conf.to_json()


def test_errors_match_jax(tmp_path):
    causal = str(tmp_path / "causal.h5")
    _seq_h5(causal, [
        {"class_name": "Conv1D",
         "config": {"name": "c", "filters": 4, "kernel_size": [3],
                    "padding": "causal", "activation": "relu",
                    "use_bias": True, "batch_input_shape": [None, 8, 2]}},
    ], {})
    bad = str(tmp_path / "bad.h5")
    config = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Lambda",
         "config": {"name": "l", "batch_input_shape": [None, 4]}}]}}
    with h5py.File(bad, "w") as f:
        f.attrs["model_config"] = json.dumps(config)
        f.create_group("model_weights").attrs["layer_names"] = []
    plain = str(tmp_path / "plain.h5")
    with h5py.File(plain, "w") as f:
        f.create_dataset("x", data=np.zeros(3))
    for path, match in ((causal, "causal"), (bad, "Lambda"),
                        (plain, "model_config")):
        with pytest.raises(Exception, match=match) as ej:
            jki.import_keras_model_and_weights(path)
        with pytest.raises(Exception, match=match) as ep:
            pki.import_keras_model_and_weights(path, device="cpu")
        assert str(ep.value) == str(ej.value)


# ------------------------------------------------------------------ C15


@pytest.mark.parametrize("padding", ["valid", "same"])
def test_conv2d_transpose_follows_keras_not_jax(padding, tmp_path):
    rng = np.random.default_rng(14)
    k = rng.standard_normal((3, 3, 4, 2)).astype(np.float32) * 0.3  # out, in
    kb = rng.standard_normal(4).astype(np.float32) * 0.1
    p = str(tmp_path / "deconv.h5")
    _seq_h5(p, [
        {"class_name": "Conv2DTranspose",
         "config": {"name": "dc", "filters": 4, "kernel_size": [3, 3],
                    "strides": [2, 2], "padding": padding,
                    "activation": "linear", "use_bias": True,
                    "batch_input_shape": [None, 4, 5, 2]}},
    ], {"dc": [k, kb]})
    jnet = jki.import_keras_model_and_weights(p)
    pnet = pki.import_keras_model_and_weights(p, device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    np.testing.assert_array_equal(
        pnet.params_tree["dc"]["W"].numpy(),
        np.swapaxes(k[::-1, ::-1], 2, 3))
    x = rng.standard_normal((2, 4, 5, 2)).astype(np.float32)
    want = np.asarray(lax.conv_transpose(
        x, k, strides=(2, 2), padding=padding.upper(),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        transpose_kernel=True)) + kb
    got = _out(pnet.output(x))
    assert got.shape == want.shape == (
        (2, 9, 11, 4) if padding == "valid" else (2, 8, 10, 4))
    np.testing.assert_allclose(got, want, **OUT_TOL)
    # JAX's layer takes K [kh, kw, out, in] as HWIO, unflipped: with
    # in != out its convolution refuses the input's channels
    with pytest.raises(ValueError, match="feature"):
        jnet.output(x)


def test_json_with_numpy_weights_is_the_h5_import(tmp_path):
    """`import_keras_configuration(json, weights=...)` (no h5py: the card's
    path) gives the `.h5` import of the same model: the configuration of
    `chip_smoke.keras_vgg` at 1/16 width on 64x64 inputs (every layer of
    the slice among VGG16's convolutions), its JSON equal to JAX's
    config-only import, every tensor equal to the `.h5` import's, the
    same predictions."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    text, weights, last_conv = smoke.keras_vgg(
        np.random.default_rng(3), size=64, classes=5, div=16)
    from_json = pki.import_keras_configuration(text, device="cpu",
                                               weights=weights)
    assert from_json.conf.to_json() == \
        jki.import_keras_configuration(text).conf.to_json()
    kinds = {type(l).__name__ for l in from_json.layers}
    assert {"DepthwiseConvolution2DLayer", "SeparableConvolution2DLayer",
            "Deconvolution2DLayer", "Upsampling2DLayer",
            "Cropping2DLayer"} <= kinds
    assert type(from_json.layers[last_conv]).__name__ == "SubsamplingLayer"
    p = str(tmp_path / "vgg.h5")
    _seq_h5(p, json.loads(text)["config"]["layers"], weights)
    from_h5 = pki.import_keras_model_and_weights(p, device="cpu")
    _equal_trees(from_json.params_tree, jax.tree_util.tree_map(
        lambda t: t.numpy(), from_h5.params_tree))
    x = np.random.default_rng(4).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(_out(from_json.output(x)),
                                  _out(from_h5.output(x)))


def test_weights_of_another_shape_are_refused():
    """The importers write through `params_from_numpy(partial=True)`: a
    Keras kernel of another shape than the mapped layer's raises, keys
    the file leaves out keep their values, and only a key named in
    `resize` (PReLU's alpha) may take another shape."""
    text = json.dumps({"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Dense",
         "config": {"name": "d", "units": 3, "activation": "linear",
                    "use_bias": True, "batch_input_shape": [None, 4]}}]}})
    with pytest.raises(ValueError, match="d/W"):
        pki.import_keras_configuration(
            text, device="cpu",
            weights={"d": [np.zeros((3, 4), np.float32),
                           np.zeros(3, np.float32)]})
    net = pki.import_keras_configuration(text, device="cpu")
    b = net.params_tree["d"]["b"].clone()
    w = np.full((4, 3), 0.5, np.float32)
    params_from_numpy(net, {"d": {"W": w}}, partial=True)
    np.testing.assert_array_equal(net.params_tree["d"]["W"].numpy(), w)
    assert torch.equal(net.params_tree["d"]["b"], b)
    with pytest.raises(KeyError, match="keys differ"):
        params_from_numpy(net, {"d": {"W": w, "alpha": w}}, partial=True)
    with pytest.raises(KeyError, match="keys differ"):
        params_from_numpy(net, {"d": {"W": w}})
    with pytest.raises(KeyError, match="layers differ"):
        params_from_numpy(net, {"e": {"W": w}}, partial=True)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(net, {"d": {"b": np.zeros(4)}}, partial=True,
                          resize=("alpha",))
    params_from_numpy(net, {"d": {"b": np.ones(4)}}, partial=True,
                      resize=("b",))
    assert tuple(net.params_tree["d"]["b"].shape) == (4,)
