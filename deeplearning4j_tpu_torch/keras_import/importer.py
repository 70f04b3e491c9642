"""Keras JSON/YAML-config → native config mapping + weight copying (port
of `deeplearning4j_tpu/keras_import/importer.py`).

Reference parity: `KerasModel.java` (689 LoC, `getComputationGraph():105`),
`KerasSequentialModel.java`, `KerasLayer.java` (1,207 LoC per-type mapping),
entry `KerasModelImport.java:48-192` (importKerasModelAndWeights +
importKerasModelConfiguration from JSON/YAML).

Convention notes (why little transposing happens here): Keras/TF and this
framework share NHWC activations, HWIO conv kernels, [in,out] dense kernels,
and i,f,c,o LSTM gate order — so most weights copy through; the reference's
NCHW transposes (`KerasLayer.java` weight-copy paths) are unnecessary. The
exceptions handled below: depthwise kernels ([kh,kw,in,mult] → [kh,kw,1,
in*mult] for feature_group_count grouping), GRU gate order (Keras z,r,h →
ours r,z,n) and transposed-convolution kernels: Keras's Conv2DTranspose
kernel K [kh, kw, out, in] is the kernel of the convolution it
transposes, so `Deconvolution2DLayer` (the dilated input correlated with
W [kh, kw, in, out] unflipped) takes W = swap(flip(K)). The JAX importer
copies K as it is (C15, reference-side).

The weights are copied into the network's own tensors on its device
(`params_from_numpy`'s shape checks; PReLU's alpha keeps Keras's shape),
and the updater state is rebuilt from them.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.keras_import.h5 import Hdf5Archive
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ElementWiseVertex, MergeVertex
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalization, Bidirectional, ConvolutionLayer,
    Convolution1DLayer, Cropping2DLayer, Deconvolution2DLayer, DenseLayer,
    DepthwiseConvolution2DLayer, DropoutLayer, EmbeddingSequenceLayer,
    GlobalPoolingLayer, GRU, LSTM, LastTimeStep, OutputLayer, PReLULayer,
    SeparableConvolution2DLayer, SimpleRnn, SubsamplingLayer,
    Subsampling1DLayer, Upsampling2DLayer, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.models import (
    ComputationGraph, MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, state_from_numpy,
)

_ACT = {
    "relu": "relu", "softmax": "softmax", "sigmoid": "sigmoid",
    "tanh": "tanh", "linear": "identity", "elu": "elu", "selu": "selu",
    "softplus": "softplus", "softsign": "softsign",
    "hard_sigmoid": "hardsigmoid", "swish": "swish", "gelu": "gelu",
    "silu": "silu", "mish": "mish", "leaky_relu": "leakyrelu",
    "relu6": "relu6", "exponential": "exp", None: "identity",
}

# Keras initializer (class or Keras-1 string) → native WeightInit name.
# Reference: KerasLayer.java mapWeightInitialization.
_INIT_MAP = {
    "glorotuniform": "xavier_uniform", "glorotnormal": "xavier",
    "henormal": "relu", "heuniform": "relu_uniform",
    "lecunnormal": "lecun_normal", "lecununiform": "lecun_uniform",
    "zeros": "zero", "zero": "zero", "ones": "ones", "one": "ones",
    "randomnormal": "normal", "normal": "normal",
    "randomuniform": "uniform", "uniform": "uniform",
    "truncatednormal": "normal", "orthogonal": "orthogonal",
    "identity": "identity",
}


def _act(cfg: dict, key: str = "activation") -> str:
    a = cfg.get(key)
    if isinstance(a, dict):  # Keras 3 serialized activation object
        a = a.get("config", {}).get("name", a.get("class_name", "")).lower()
    if a not in _ACT:
        raise ValueError(f"Unsupported Keras activation {a!r}")
    return _ACT[a]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _first(v, default=1):
    if isinstance(v, (list, tuple)):
        return v[0] if v else default
    return v if v is not None else default


def _winit_name(cfg: dict, key: str = "kernel_initializer") -> Optional[str]:
    """Keras initializer → native weight_init (None keeps the default)."""
    init = cfg.get(key, cfg.get("init"))
    if init is None:
        return None
    if isinstance(init, dict):
        cname = init.get("class_name", "")
        c = init.get("config", {}) or {}
        if cname == "VarianceScaling":
            mode = c.get("mode", "fan_in")
            dist = str(c.get("distribution", "normal"))
            scale = float(c.get("scale", 1.0))
            uni = "uniform" in dist
            if mode == "fan_avg":
                return "xavier_uniform" if uni else "xavier"
            if mode == "fan_in" and scale >= 2.0:
                return "relu_uniform" if uni else "relu"
            return "lecun_uniform" if uni else "lecun_normal"
        k = cname.lower().replace("_", "")
    else:
        k = str(init).lower().replace("_", "")
    return _INIT_MAP.get(k)


def _l1l2(cfg: dict, *keys) -> Tuple[Optional[float], Optional[float]]:
    """Extract (l1, l2) from a Keras regularizer config dict."""
    for key in keys:
        r = cfg.get(key)
        if isinstance(r, dict):
            c = r.get("config", r)
            l1 = float(c.get("l1") or 0.0) or None
            l2 = float(c.get("l2") or 0.0) or None
            return l1, l2
    return None, None


def _common(cfg: dict) -> dict:
    """Weight-init + regularizer fields shared by parameterized layers.
    Reference: KerasLayer.java getWeightRegularizerFromConfig /
    mapWeightInitialization."""
    l1, l2 = _l1l2(cfg, "kernel_regularizer", "W_regularizer")
    l1b, l2b = _l1l2(cfg, "bias_regularizer", "b_regularizer")
    out = {}
    wi = _winit_name(cfg)
    if wi is not None:
        out["weight_init"] = wi
    if l1 is not None:
        out["l1"] = l1
    if l2 is not None:
        out["l2"] = l2
    if l1b is not None:
        out["l1_bias"] = l1b
    if l2b is not None:
        out["l2_bias"] = l2b
    return out


def _input_type_from_shape(shape) -> Optional[InputType]:
    """batch_input_shape (batch dim first, None) → InputType."""
    if shape is None:
        return None
    dims = [d for d in shape[1:]]
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 3:
        h, w, c = dims
        return InputType.convolutional(h, w, c)
    raise ValueError(f"Unsupported input shape {shape}")


class _Unsupported(Exception):
    pass


def _conv_mode(cfg: dict) -> str:
    pad = cfg.get("padding", cfg.get("border_mode", "valid"))
    if pad == "causal":
        raise _Unsupported(
            "Keras padding='causal' (left-padded temporal conv) has no "
            "native counterpart yet")
    return "same" if pad == "same" else "truncate"


def _map_layer(class_name: str, cfg: dict, *, is_last: bool):
    """One Keras layer config → native layer(s). Reference:
    `KerasLayer.java` per-type mapping (1,207 LoC of the same dispatch)."""
    name = cfg.get("name")
    common = _common(cfg)
    if class_name == "Dense":
        act = _act(cfg)
        units = cfg.get("units", cfg.get("output_dim"))
        if is_last:
            loss = "mcxent" if act == "softmax" else (
                "xent" if act == "sigmoid" else "mse")
            return OutputLayer(name=name, n_out=units, activation=act,
                               loss=loss, has_bias=cfg.get("use_bias", True),
                               **common)
        return DenseLayer(name=name, n_out=units, activation=act,
                          has_bias=cfg.get("use_bias", True), **common)
    if class_name in ("Conv2D", "Convolution2D"):
        return ConvolutionLayer(
            name=name, n_out=cfg.get("filters", cfg.get("nb_filter")),
            kernel=_pair(cfg.get("kernel_size", (cfg.get("nb_row", 3),
                                                 cfg.get("nb_col", 3)))),
            stride=_pair(cfg.get("strides", cfg.get("subsample", (1, 1)))),
            dilation=_pair(cfg.get("dilation_rate", (1, 1))),
            convolution_mode=_conv_mode(cfg),
            activation=_act(cfg), has_bias=cfg.get("use_bias", True), **common)
    if class_name in ("Conv1D", "Convolution1D"):
        return Convolution1DLayer(
            name=name, n_out=cfg.get("filters", cfg.get("nb_filter")),
            kernel=_first(cfg.get("kernel_size",
                                  cfg.get("filter_length", 3)), 3),
            stride=_first(cfg.get("strides", cfg.get("subsample_length", 1))),
            convolution_mode=_conv_mode(cfg),
            activation=_act(cfg), has_bias=cfg.get("use_bias", True), **common)
    if class_name == "SeparableConv2D":
        return SeparableConvolution2DLayer(
            name=name, n_out=cfg["filters"],
            depth_multiplier=cfg.get("depth_multiplier", 1),
            kernel=_pair(cfg.get("kernel_size", 3)),
            stride=_pair(cfg.get("strides", (1, 1))),
            convolution_mode=_conv_mode(cfg),
            activation=_act(cfg), has_bias=cfg.get("use_bias", True), **common)
    if class_name == "DepthwiseConv2D":
        return DepthwiseConvolution2DLayer(
            name=name, depth_multiplier=cfg.get("depth_multiplier", 1),
            kernel=_pair(cfg.get("kernel_size", 3)),
            stride=_pair(cfg.get("strides", (1, 1))),
            convolution_mode=_conv_mode(cfg),
            activation=_act(cfg), has_bias=cfg.get("use_bias", True), **common)
    if class_name in ("Conv2DTranspose", "Deconvolution2D"):
        return Deconvolution2DLayer(
            name=name, n_out=cfg["filters"],
            kernel=_pair(cfg.get("kernel_size", 3)),
            stride=_pair(cfg.get("strides", (1, 1))),
            convolution_mode=_conv_mode(cfg),
            activation=_act(cfg), has_bias=cfg.get("use_bias", True), **common)
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        return SubsamplingLayer(
            name=name,
            pooling="max" if class_name.startswith("Max") else "avg",
            kernel=_pair(cfg.get("pool_size", (2, 2))),
            stride=_pair(cfg.get("strides") or cfg.get("pool_size", (2, 2))),
            convolution_mode=_conv_mode(cfg))
    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        return Subsampling1DLayer(
            name=name,
            pooling="max" if class_name.startswith("Max") else "avg",
            kernel=_first(cfg.get("pool_size", cfg.get("pool_length", 2)), 2),
            stride=_first(cfg.get("strides") or cfg.get("stride")
                          or cfg.get("pool_size", 2), 2),
            convolution_mode=_conv_mode(cfg))
    if class_name in ("GlobalAveragePooling2D", "GlobalMaxPooling2D",
                      "GlobalAveragePooling1D", "GlobalMaxPooling1D"):
        return GlobalPoolingLayer(
            name=name,
            pooling="avg" if "Average" in class_name else "max")
    if class_name == "Flatten":
        return None  # handled by automatic CnnToFeedForward preprocessor
    if class_name in ("Dropout", "SpatialDropout1D", "SpatialDropout2D",
                      "GaussianDropout", "AlphaDropout"):
        return DropoutLayer(name=name, dropout=cfg.get("rate", 0.5))
    if class_name == "GaussianNoise":
        return None  # identity at inference; regularization-only layer
    if class_name == "Activation":
        return ActivationLayer(name=name, activation=_act(cfg))
    if class_name == "LeakyReLU":
        a = cfg.get("alpha", cfg.get("negative_slope", 0.3))
        return ActivationLayer(name=name, activation=f"leakyrelu:{float(a)}")
    if class_name == "ELU":
        return ActivationLayer(
            name=name, activation=f"elu:{float(cfg.get('alpha', 1.0))}")
    if class_name == "ThresholdedReLU":
        return ActivationLayer(
            name=name,
            activation=f"thresholdedrelu:{float(cfg.get('theta', 1.0))}")
    if class_name == "ReLU":
        mv = cfg.get("max_value")
        ns = float(cfg.get("negative_slope") or 0.0)
        th = float(cfg.get("threshold") or 0.0)
        if th or (ns and mv is not None):
            raise _Unsupported(
                f"Keras ReLU with threshold={th}/negative_slope={ns}/"
                f"max_value={mv} combination not supported")
        if ns:
            return ActivationLayer(name=name, activation=f"leakyrelu:{ns}")
        if mv is None:
            return ActivationLayer(name=name, activation="relu")
        return ActivationLayer(
            name=name,
            activation="relu6" if mv == 6 else f"clippedrelu:{float(mv)}")
    if class_name == "Softmax":
        return ActivationLayer(name=name, activation="softmax")
    if class_name == "PReLU":
        return PReLULayer(name=name)  # alpha shape preserved at weight copy
    if class_name == "BatchNormalization":
        return BatchNormalization(name=name, eps=cfg.get("epsilon", 1e-3),
                                  decay=cfg.get("momentum", 0.99),
                                  scale=cfg.get("scale", True),
                                  center=cfg.get("center", True))
    if class_name == "ZeroPadding2D":
        return ZeroPaddingLayer(name=name, pad=_pair(cfg.get("padding", 1)))
    if class_name == "Cropping2D":
        return Cropping2DLayer(name=name, crop=_pair(cfg.get("cropping", 0)))
    if class_name == "UpSampling2D":
        return Upsampling2DLayer(name=name, size=_pair(cfg.get("size", 2)))
    if class_name == "LSTM":
        lstm = LSTM(name=name, n_out=cfg.get("units", cfg.get("output_dim")),
                    activation=_act(cfg),
                    gate_activation=_act(cfg, "recurrent_activation"),
                    **common)
        if not cfg.get("return_sequences", False):
            return LastTimeStep(name=name, layer=lstm)
        return lstm
    if class_name == "GRU":
        reset_after = bool(cfg.get("reset_after", False))
        gru = GRU(name=name, n_out=cfg.get("units", cfg.get("output_dim")),
                  activation=_act(cfg),
                  gate_activation=_act(cfg, "recurrent_activation"),
                  reset_after=reset_after, recurrent_bias=reset_after,
                  **common)
        if not cfg.get("return_sequences", False):
            return LastTimeStep(name=name, layer=gru)
        return gru
    if class_name == "SimpleRNN":
        rnn = SimpleRnn(name=name,
                        n_out=cfg.get("units", cfg.get("output_dim")),
                        activation=_act(cfg), **common)
        if not cfg.get("return_sequences", False):
            return LastTimeStep(name=name, layer=rnn)
        return rnn
    if class_name == "Bidirectional":
        inner_cfg = cfg["layer"]
        inner = _map_layer(inner_cfg["class_name"],
                           dict(inner_cfg.get("config", {})), is_last=False)
        pooled = isinstance(inner, LastTimeStep)
        core = inner.layer if pooled else inner
        # return_sequences=False is handled by Bidirectional itself (forward
        # last step + backward full-sequence state), NOT LastTimeStep — the
        # backward half's Keras semantics align with t=0, not t=T-1.
        return Bidirectional(name=name, layer=core,
                             merge=(cfg.get("merge_mode") or "concat"),
                             return_sequences=not pooled)
    if class_name == "Embedding":
        return EmbeddingSequenceLayer(name=name, n_in=cfg["input_dim"],
                                      n_out=cfg["output_dim"])
    if class_name == "InputLayer":
        return None
    raise _Unsupported(f"Keras layer type {class_name!r} not supported "
                       f"(reference parity list: KerasLayer.java)")


def _gru_perm(arr: np.ndarray, h: int) -> np.ndarray:
    """Keras GRU gate order z,r,h → native r,z,n (last-axis blocks)."""
    z, r, n = arr[..., :h], arr[..., h:2 * h], arr[..., 2 * h:]
    return np.concatenate([r, z, n], axis=-1)


def _rnn_param_block(layer, weights: List[np.ndarray]) -> Dict[str, Any]:
    """kernel/recurrent/bias triple → native param dict for one direction.
    When the file has no bias (Keras use_bias=False), the bias is ZEROED —
    the native init's forget-gate bias of 1 would otherwise shift every
    gate vs the Keras model, which has no bias term at all."""
    p: Dict[str, Any] = {}
    nb = weights[0].shape[-1]
    if isinstance(layer, GRU):
        h = layer.n_out
        p["W"] = np.asarray(_gru_perm(weights[0], h))
        p["RW"] = np.asarray(_gru_perm(weights[1], h))
        if len(weights) > 2:
            b = weights[2]
            if b.ndim == 2:  # reset_after: [input_bias, recurrent_bias]
                p["b"] = np.asarray(_gru_perm(b[0], h))
                p["rb"] = np.asarray(_gru_perm(b[1], h))
            else:
                p["b"] = np.asarray(_gru_perm(b, h))
        else:
            p["b"] = np.zeros((nb,), np.float32)
            if layer.recurrent_bias:
                p["rb"] = np.zeros((nb,), np.float32)
    else:
        p["W"] = np.asarray(weights[0])
        p["RW"] = np.asarray(weights[1])
        p["b"] = (np.asarray(weights[2]) if len(weights) > 2
                  else np.zeros((nb,), np.float32))
    return p


def _copy_weights(net, keras_name: str, our_name: str,
                  weights: List[np.ndarray], layer) -> None:
    """Order conventions per Keras save format (kernel, bias, ...)."""
    if not weights or our_name not in net.params_tree:
        return
    if isinstance(layer, LastTimeStep):
        layer = layer.layer
    p: Dict[str, Any] = {}
    if isinstance(layer, BatchNormalization):
        # keras order: gamma, beta, moving_mean, moving_var; the layer's
        # scale/center flags (carried from the Keras config by _map_layer)
        # say which of gamma/beta are present in the file.
        w = list(weights)
        expected = 2 + int(layer.scale) + int(layer.center)
        if len(w) != expected:
            raise ValueError(
                f"BatchNormalization '{keras_name}': {len(w)} weight arrays "
                f"but scale={layer.scale}/center={layer.center} imply "
                f"{expected}")
        if layer.scale:
            p["gamma"] = np.asarray(w.pop(0))
        if layer.center:
            p["beta"] = np.asarray(w.pop(0))
        state_from_numpy(net, {our_name: {"mean": np.asarray(w[0]),
                                          "var": np.asarray(w[1])}},
                         partial=True)
    elif isinstance(layer, Bidirectional):
        # merged into the init dicts (`partial`) so params absent from
        # the file (e.g. a zero bias when the inner RNN has use_bias=False)
        # survive
        half = len(weights) // 2
        p["fwd"] = _rnn_param_block(layer.layer, weights[:half])
        p["bwd"] = _rnn_param_block(layer.layer, weights[half:])
    elif isinstance(layer, (LSTM, GRU, SimpleRnn)):
        p.update(_rnn_param_block(layer, weights))
    elif isinstance(layer, SeparableConvolution2DLayer):
        dk = weights[0]  # [kh, kw, in, mult]
        p["dW"] = np.asarray(dk.reshape(dk.shape[0], dk.shape[1], 1, -1))
        p["pW"] = np.asarray(weights[1])
        if len(weights) > 2 and "b" in net.params_tree[our_name]:
            p["b"] = np.asarray(weights[2])
    elif isinstance(layer, DepthwiseConvolution2DLayer):
        dk = weights[0]
        p["W"] = np.asarray(dk.reshape(dk.shape[0], dk.shape[1], 1, -1))
        if len(weights) > 1 and "b" in net.params_tree[our_name]:
            p["b"] = np.asarray(weights[1])
    elif isinstance(layer, Deconvolution2DLayer):
        # K [kh, kw, out, in] → W [kh, kw, in, out], flipped (C15)
        p["W"] = np.ascontiguousarray(
            np.swapaxes(np.asarray(weights[0])[::-1, ::-1], 2, 3))
        if len(weights) > 1 and "b" in net.params_tree[our_name]:
            p["b"] = np.asarray(weights[1])
    elif isinstance(layer, PReLULayer):
        # Keras alpha shape = input shape minus batch, with 1s on
        # shared_axes (e.g. (1,1,C) for shared_axes=[1,2], (H,W,C) for the
        # default). Any of these broadcast correctly against [B, ..., C] in
        # PReLULayer.apply, so keep the shape; ravel only plain vectors.
        a = weights[0]
        p["alpha"] = np.asarray(a if a.ndim > 1 else np.ravel(a))
    else:
        p["W"] = np.asarray(weights[0])
        if len(weights) > 1 and "b" in net.params_tree[our_name]:
            p["b"] = np.asarray(weights[1])
    params_from_numpy(net, {our_name: p}, partial=True, resize=("alpha",))


def _rebuild_updater_state(net, updaters) -> None:
    """The updater state of the imported weights (zeros, as at init),
    in their shapes."""
    net.updater_state = {n: u.init(net.params_tree[n])
                         for n, u in updaters.items()}




class KerasModelImport:
    """Reference: `KerasModelImport.java` static entry points."""

    @staticmethod
    def import_keras_sequential_model_and_weights(path: str, device=None):
        return import_keras_model_and_weights(path, device=device)

    @staticmethod
    def import_keras_model_and_weights(path: str, device=None):
        return import_keras_model_and_weights(path, device=device)

    @staticmethod
    def import_keras_model_configuration(path_or_str: str, device=None):
        return import_keras_configuration(path_or_str, device=device)


def import_keras_model_and_weights(path: str, device=None):
    """Auto-detects Sequential vs functional Model; the network lives on
    `device` (CUDA by default). Reference:
    `KerasModelImport.importKerasModelAndWeights(...):101`."""
    with Hdf5Archive(path) as ar:
        config = ar.model_config()
        cls = config.get("class_name")
        if cls == "Sequential":
            net = _import_sequential(config, ar, device)
        elif cls in ("Model", "Functional"):
            net = _import_functional(config, ar, device)
        else:
            raise ValueError(f"Unknown Keras model class {cls!r}")
    return net


def import_keras_configuration(text: str, device=None,
                               weights: Optional[Dict[str, List]] = None):
    """Config import from a JSON or YAML string or a .json/.yaml file
    path, on `device` (CUDA by default). With `weights` (Keras layer name
    → that layer's arrays in Keras's order and layouts, as
    `layer.get_weights()` returns them) the weights are copied as from a
    `.h5` file, without h5py; else the weights are seeded. Reference:
    `KerasModelImport.importKerasModelConfiguration` /
    `importKerasSequentialConfiguration` (JSON + YAML entry points)."""
    import os

    if os.path.exists(text):
        with open(text) as f:
            text = f.read()
    config = None
    try:
        config = json.loads(text)
    except (json.JSONDecodeError, ValueError):
        import yaml

        config = yaml.safe_load(text)
    if not isinstance(config, dict) or "class_name" not in config:
        raise ValueError("Not a Keras model configuration (JSON or YAML)")
    cls = config["class_name"]
    ar = None if weights is None else _NumpyWeights(weights)
    if cls == "Sequential":
        return _import_sequential(config, ar, device)
    if cls in ("Model", "Functional"):
        return _import_functional(config, ar, device)
    raise ValueError(f"Unknown Keras model class {cls!r}")


class _NumpyWeights:
    """Per-layer weight arrays held in memory, read as `Hdf5Archive`'s
    are."""

    def __init__(self, weights: Dict[str, List]):
        self._w = {k: [np.asarray(a) for a in v] for k, v in weights.items()}

    def layer_names(self) -> List[str]:
        return list(self._w)

    def layer_weights(self, name: str) -> List[np.ndarray]:
        return self._w.get(name, [])


def _layer_list(config: dict) -> List[dict]:
    inner = config.get("config")
    if isinstance(inner, list):          # Keras 1
        return inner
    return inner.get("layers", [])       # Keras 2


def _import_sequential(config: dict, ar,
                       device=None) -> MultiLayerNetwork:
    """Reference: `KerasSequentialModel.java` → MultiLayerNetwork."""
    klayers = _layer_list(config)
    input_type = None
    layers = []
    keras_names: List[Tuple[str, Any]] = []
    n = len([k for k in klayers
             if k["class_name"] not in ("InputLayer", "Flatten")])
    seen = 0
    for k in klayers:
        cfg = k.get("config", {})
        if input_type is None:
            shape = cfg.get("batch_input_shape") or cfg.get("batch_shape")
            it = _input_type_from_shape(shape)
            if it is not None:
                input_type = it
        if k["class_name"] in ("InputLayer", "Flatten"):
            continue
        seen += 1
        layer = _map_layer(k["class_name"], cfg, is_last=(seen == n))
        if layer is None:
            continue
        layers.append(layer)
        keras_names.append((cfg.get("name", k["class_name"]), layer))

    builder = (NeuralNetConfiguration.builder()
               .seed(123)
               .list(*layers))
    if input_type is not None:
        builder = builder.set_input_type(input_type)
    net = MultiLayerNetwork(builder.build(), device=device).init()

    if ar is not None:
        h5_names = ar.layer_names()
        for (kname, layer), conf_layer in zip(keras_names, net.conf.layers):
            if kname not in h5_names:
                continue
            _copy_weights(net, kname, conf_layer.name,
                          ar.layer_weights(kname), layer)
        _rebuild_updater_state(net, net._layer_updaters)
    return net


def _import_functional(config: dict, ar,
                       device=None) -> ComputationGraph:
    """Reference: `KerasModel.getComputationGraph():105`."""
    inner = config["config"]
    klayers = inner["layers"]
    out_names = [o[0] for o in inner.get("output_layers", [])]
    in_names = [i[0] for i in inner.get("input_layers", [])]

    g = NeuralNetConfiguration.builder().seed(123).graph_builder()
    input_types = []
    mapped: Dict[str, Any] = {}
    for k in klayers:
        cname = k["class_name"]
        cfg = k.get("config", {})
        name = k.get("name") or cfg.get("name")
        inbound = k.get("inbound_nodes", [])
        ins: List[str] = []
        if inbound:
            node = inbound[0]
            if isinstance(node, dict):  # Keras 3 style
                args = node.get("args", [])
                def walk(a):
                    if isinstance(a, dict) and "config" in a and \
                            "keras_history" in a.get("config", {}):
                        ins.append(a["config"]["keras_history"][0])
                    elif isinstance(a, (list, tuple)):
                        for x in a:
                            walk(x)
                walk(args)
            else:
                for entry in node:
                    ins.append(entry[0])
        if cname == "InputLayer":
            g.add_inputs(name)
            it = _input_type_from_shape(
                cfg.get("batch_input_shape") or cfg.get("batch_shape"))
            input_types.append(it)
            continue
        if cname == "Add":
            g.add_vertex(name, ElementWiseVertex(op="add"), *ins)
            continue
        if cname == "Subtract":
            g.add_vertex(name, ElementWiseVertex(op="sub"), *ins)
            continue
        if cname == "Concatenate":
            g.add_vertex(name, MergeVertex(), *ins)
            continue
        if cname == "Merge":  # Keras 1 merge with a mode string
            mode = cfg.get("mode", "concat")
            if mode in ("concat", "concatenate"):
                g.add_vertex(name, MergeVertex(), *ins)
            elif mode == "sum":
                g.add_vertex(name, ElementWiseVertex(op="add"), *ins)
            elif mode == "mul":
                g.add_vertex(name, ElementWiseVertex(op="mul"), *ins)
            elif mode == "ave":
                g.add_vertex(name, ElementWiseVertex(op="avg"), *ins)
            else:
                raise _Unsupported(f"Keras Merge mode {mode!r}")
            continue
        if cname == "Average":
            g.add_vertex(name, ElementWiseVertex(op="avg"), *ins)
            continue
        if cname == "Multiply":
            g.add_vertex(name, ElementWiseVertex(op="mul"), *ins)
            continue
        if cname == "Maximum":
            g.add_vertex(name, ElementWiseVertex(op="max"), *ins)
            continue
        if cname == "Flatten":
            from deeplearning4j_tpu_torch.nn.graph import PreprocessorVertex
            from deeplearning4j_tpu_torch.nn.preprocessors import (
                CnnToFeedForward,
            )
            g.add_vertex(name, PreprocessorVertex(
                preprocessor=CnnToFeedForward()), *ins)
            continue
        layer = _map_layer(cname, cfg, is_last=(name in out_names))
        if layer is None:
            continue
        mapped[name] = layer
        g.add_layer(name, layer, *ins)
    g.set_outputs(*out_names)
    if input_types and all(t is not None for t in input_types):
        g.set_input_types(*input_types)
    net = ComputationGraph(g.build(), device=device).init()

    if ar is not None:
        h5_names = set(ar.layer_names())
        for name, layer in mapped.items():
            if name in h5_names:
                _copy_weights(net, name, name, ar.layer_weights(name), layer)
        _rebuild_updater_state(net, net._vertex_updaters)
    return net
