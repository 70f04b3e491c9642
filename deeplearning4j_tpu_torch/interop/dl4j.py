"""DL4J checkpoint-container interop: read/write the reference's zip format
(port of `deeplearning4j_tpu/interop/dl4j.py`: the ND4J array codec, the
name maps and the flat-parameter layouts are copied; the networks are
the port's).

The reference persists models as a zip of three entries
(`util/ModelSerializer.java:37-119`):

- ``configuration.json`` — the Jackson-serialized MultiLayerConfiguration
  (`nn/conf/MultiLayerConfiguration.java`), layers wrapped in one-key type
  objects per ``@JsonTypeInfo(WRAPPER_OBJECT)``
  (`nn/conf/layers/Layer.java:47-68`).
- ``coefficients.bin`` — the single flattened parameter row vector written
  with ``Nd4j.write`` (two ND4J DataBuffers: shape-info then data, each as
  ``writeUTF(allocationMode), writeInt(length), writeUTF(dtype), elements``
  big-endian).
- ``updaterState.bin`` — the flat updater state view, same array codec.

Per-layer flat layouts (the param-initializer ordering):
- Dense/Output/Embedding (`nn/params/DefaultParamInitializer.java:60-88`):
  [W ('f'-order, (nIn, nOut)), b (nOut)].
- Convolution (`nn/params/ConvolutionParamInitializer.java:76-100`):
  [b (nOut), W ('c'-order, (nOut, nIn, kH, kW))] — note bias FIRST and 'c'
  order, unlike everything else.
- BatchNormalization
  (`nn/params/BatchNormalizationParamInitializer.java:56-80`):
  [gamma, beta, mean, var] (gamma/beta absent when lockGammaBeta).
- GravesLSTM (`nn/params/GravesLSTMParamInitializer.java:57-120`):
  [W_in ('f', (nIn, 4H)), RW ('f', (H, 4H+3)), b (4H)]. Gate column blocks
  are [candidate, forget, output, input]
  (`nn/layers/recurrent/LSTMHelpers.java:180-250` — their
  "inputActivations" block 0 is the tanh candidate and their "input
  modulation gate" block 3 is the sigmoid input gate); the
  three extra RW columns are the peepholes wFF (forget, col 4H), wOO
  (output, col 4H+1), wGG (input, col 4H+2). This framework's gate order is
  [input, forget, candidate, output] with peepholes P=[input, forget,
  output] (nn/layers/recurrent.py), so columns are permuted on the way in.

This is an interop adapter: imported configs become the port's dataclass
configs and imported params are copied into the network's own tensors on
its device (CUDA by default, `device="cpu"` on request), after which
everything runs the port's path. An exported file is the JAX package's
byte for byte for the same configuration and parameters.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, state_from_numpy,
)
from deeplearning4j_tpu_torch.utils.pytrees import ravel_leaves

# --------------------------------------------------------------------------
# ND4J binary array codec (Nd4j.write / Nd4j.read wire format)
# --------------------------------------------------------------------------

_DTYPES = {
    "FLOAT": (">f4", 4),
    "DOUBLE": (">f8", 8),
    "INT": (">i4", 4),
    "LONG": (">i8", 8),
    "HALF": (">f2", 2),
}


def _read_java_utf(f) -> str:
    (n,) = struct.unpack(">H", f.read(2))
    return f.read(n).decode("utf-8")


def _write_java_utf(f, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack(">H", len(b)))
    f.write(b)


def _read_buffer(f) -> Tuple[str, np.ndarray]:
    """One ND4J DataBuffer: (allocation mode UTF, length int32, dtype UTF,
    big-endian elements)."""
    alloc = _read_java_utf(f)
    (length,) = struct.unpack(">i", f.read(4))
    dtype = _read_java_utf(f)
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported ND4J buffer dtype {dtype!r}")
    fmt, size = _DTYPES[dtype]
    raw = f.read(length * size)
    if len(raw) != length * size:
        raise ValueError(
            f"truncated ND4J buffer: header promises {length} {dtype} "
            f"elements ({length * size} bytes) but only {len(raw)} bytes "
            "remain — corrupt or cut-off coefficients/updater stream")
    data = np.frombuffer(raw, dtype=fmt, count=length)
    return alloc, data


def _write_buffer(f, data: np.ndarray, dtype: str, alloc: str = "DIRECT"):
    fmt, _ = _DTYPES[dtype]
    _write_java_utf(f, alloc)
    f.write(struct.pack(">i", data.size))
    _write_java_utf(f, dtype)
    f.write(np.ascontiguousarray(data, dtype=fmt).tobytes())


def read_nd4j_array(f) -> np.ndarray:
    """Parse one Nd4j.write'd array: shape-info buffer then data buffer.

    Shape info is an int buffer [rank, *shape, *stride, offset,
    elementWiseStride, order-char] of length 2*rank + 4.
    """
    if isinstance(f, (bytes, bytearray)):
        f = io.BytesIO(f)
    _, shape_info = _read_buffer(f)
    rank = int(shape_info[0])
    if len(shape_info) < 2 * rank + 4:
        raise ValueError(
            f"malformed ND4J shape info: rank {rank}, len {len(shape_info)}")
    shape = tuple(int(s) for s in shape_info[1:1 + rank])
    order = chr(int(shape_info[2 * rank + 3]))
    _, data = _read_buffer(f)
    arr = np.asarray(data)
    if int(np.prod(shape)) != arr.size:
        raise ValueError(f"shape {shape} does not match {arr.size} elements")
    return arr.reshape(shape, order="F" if order == "f" else "C").astype(
        arr.dtype.newbyteorder("="))


def write_nd4j_array(f, arr: np.ndarray, dtype: str = "FLOAT") -> None:
    """Write `arr` in Nd4j.write format ('c' order, contiguous)."""
    arr = np.asarray(arr)
    rank = arr.ndim
    strides = []
    acc = 1
    for s in reversed(arr.shape):   # 'c'-order element strides
        strides.insert(0, acc)
        acc *= s
    shape_info = np.asarray(
        [rank, *arr.shape, *strides, 0, 1, ord("c")], dtype=">i4")
    _write_buffer(f, shape_info, "INT")
    _write_buffer(f, arr.reshape(-1, order="C"), dtype)


# --------------------------------------------------------------------------
# Enum / name translation
# --------------------------------------------------------------------------

# IActivation impl class suffix (or legacy enum string) -> framework name.
_ACT_MAP = {
    "relu": "relu", "leakyrelu": "leakyrelu", "lrelu": "leakyrelu",
    "tanh": "tanh", "sigmoid": "sigmoid", "softmax": "softmax",
    "identity": "identity", "linear": "identity", "elu": "elu",
    "selu": "selu", "softplus": "softplus", "softsign": "softsign",
    "hardtanh": "hardtanh", "hardsigmoid": "hardsigmoid", "cube": "cube",
    "rationaltanh": "rationaltanh", "rectifiedtanh": "rectifiedtanh",
    "swish": "swish", "gelu": "gelu",
}

# LossFn impl class suffix / legacy LossFunctions enum -> framework name.
_LOSS_MAP = {
    "mcxent": "mcxent", "negativeloglikelihood": "negativeloglikelihood",
    "mse": "mse", "l2": "l2", "l1": "l1", "xent": "xent",
    "binaryxent": "xent", "kldivergence": "kl_divergence",
    "kld": "kl_divergence",
    "mae": "mae", "meanabsoluteerror": "mae",
    "meansquaredlogarithmicerror": "msle", "msle": "msle",
    "meanabsolutepercentageerror": "mape", "mape": "mape",
    "hinge": "hinge", "squaredhinge": "squared_hinge",
    "poisson": "poisson", "cosineproximity": "cosine_proximity",
    "reconstructioncrossentropy": "reconstruction_crossentropy",
    "squaredloss": "squared_loss", "wasserstein": "wasserstein",
}

_LOSS_TO_DL4J = {
    "mcxent": "MCXENT", "negativeloglikelihood": "NEGATIVELOGLIKELIHOOD",
    "mse": "MSE", "l2": "L2", "l1": "L1", "xent": "XENT",
    "kl_divergence": "KL_DIVERGENCE", "mae": "MEAN_ABSOLUTE_ERROR",
    "msle": "MEAN_SQUARED_LOGARITHMIC_ERROR",
    "mape": "MEAN_ABSOLUTE_PERCENTAGE_ERROR", "hinge": "HINGE",
    "squared_hinge": "SQUARED_HINGE", "poisson": "POISSON",
    "cosine_proximity": "COSINE_PROXIMITY",
    "reconstruction_crossentropy": "RECONSTRUCTION_CROSSENTROPY",
    "squared_loss": "SQUARED_LOSS", "wasserstein": "WASSERSTEIN",
}


def _act_from_dl4j(layer_json: Dict[str, Any]) -> Optional[str]:
    fn = layer_json.get("activationFn")
    if isinstance(fn, dict):
        cls = fn.get("@class", "")
        name = cls.rsplit(".", 1)[-1]        # e.g. ActivationReLU
        key = name.replace("Activation", "").replace("H", "h").lower()
        key = key.replace("-", "")
        hit = _ACT_MAP.get(key) or _ACT_MAP.get(
            name.replace("Activation", "").lower())
        if hit:
            return hit
        raise ValueError(f"unmapped DL4J activation {cls!r}")
    legacy = layer_json.get("activationFunction") or layer_json.get(
        "activation")
    if isinstance(legacy, str):
        key = legacy.replace("_", "").lower()
        if key in _ACT_MAP:
            return _ACT_MAP[key]
        raise ValueError(f"unmapped DL4J activation {legacy!r}")
    return None


def _act_to_dl4j(name: Optional[str]) -> Dict[str, Any]:
    cls = {
        "relu": "ActivationReLU", "leakyrelu": "ActivationLReLU",
        "tanh": "ActivationTanH", "sigmoid": "ActivationSigmoid",
        "softmax": "ActivationSoftmax", "identity": "ActivationIdentity",
        "elu": "ActivationELU", "selu": "ActivationSELU",
        "softplus": "ActivationSoftPlus", "softsign": "ActivationSoftSign",
        "hardtanh": "ActivationHardTanH",
        "hardsigmoid": "ActivationHardSigmoid", "cube": "ActivationCube",
        "rationaltanh": "ActivationRationalTanh",
        "rectifiedtanh": "ActivationRectifiedTanh",
    }.get(name or "identity", "ActivationIdentity")
    return {"@class": f"org.nd4j.linalg.activations.impl.{cls}"}


def _loss_from_dl4j(layer_json: Dict[str, Any]) -> str:
    fn = layer_json.get("lossFn")
    if isinstance(fn, dict):
        cls = fn.get("@class", "").rsplit(".", 1)[-1]   # e.g. LossMCXENT
        key = cls.replace("Loss", "", 1).replace("_", "").lower()
        if key in _LOSS_MAP:
            return _LOSS_MAP[key]
        raise ValueError(f"unmapped DL4J loss {cls!r}")
    legacy = layer_json.get("lossFunction")
    if isinstance(legacy, str):
        key = legacy.replace("_", "").lower()
        if key in _LOSS_MAP:
            return _LOSS_MAP[key]
        raise ValueError(f"unmapped DL4J loss {legacy!r}")
    return "mcxent"


def _weight_init_from_dl4j(name: Optional[str]) -> Optional[str]:
    return name.lower() if isinstance(name, str) else None


def _get(d: Dict[str, Any], *keys, default=None):
    for k in keys:
        if k in d and d[k] is not None:
            return d[k]
    return default


# --------------------------------------------------------------------------
# Layer config translation
# --------------------------------------------------------------------------

def _layer_from_dl4j(type_name: str, d: Dict[str, Any]):
    """One DL4J layer JSON (already unwrapped from its type object) ->
    framework layer dataclass."""
    from deeplearning4j_tpu_torch.nn.layers import (
        ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
        DropoutLayer, EmbeddingLayer, GlobalPoolingLayer, GravesLSTM,
        LocalResponseNormalization, LossLayer, LSTM, OutputLayer,
        RnnOutputLayer, SubsamplingLayer, ZeroPaddingLayer,
    )

    common = dict(
        name=d.get("layerName"),
        activation=_act_from_dl4j(d),
        weight_init=_weight_init_from_dl4j(d.get("weightInit")),
        l1=d.get("l1") or None,
        l2=d.get("l2") or None,
        dropout=d.get("dropOut") or None,
        bias_init=d.get("biasInit") or None,
    )
    nin = _get(d, "nin", "nIn", "NIn")
    nout = _get(d, "nout", "nOut", "NOut")

    if type_name == "dense":
        return DenseLayer(n_in=nin, n_out=nout, **common)
    if type_name == "output":
        return OutputLayer(n_in=nin, n_out=nout, loss=_loss_from_dl4j(d),
                           **common)
    if type_name == "rnnoutput":
        return RnnOutputLayer(n_in=nin, n_out=nout, loss=_loss_from_dl4j(d),
                              **common)
    if type_name == "loss":
        return LossLayer(loss=_loss_from_dl4j(d), **common)
    if type_name == "embedding":
        return EmbeddingLayer(n_in=nin, n_out=nout, **common)
    if type_name == "convolution":
        return ConvolutionLayer(
            n_in=nin, n_out=nout,
            kernel=tuple(d.get("kernelSize", (3, 3))),
            stride=tuple(d.get("stride", (1, 1))),
            padding=tuple(d.get("padding", (0, 0))),
            convolution_mode=(d.get("convolutionMode") or "truncate").lower(),
            **common)
    if type_name == "subsampling":
        return SubsamplingLayer(
            pooling=(d.get("poolingType") or "MAX").lower(),
            kernel=tuple(d.get("kernelSize", (2, 2))),
            stride=tuple(d.get("stride", (2, 2))),
            padding=tuple(d.get("padding", (0, 0))),
            convolution_mode=(d.get("convolutionMode") or "truncate").lower(),
            **common)
    if type_name == "batchNormalization":
        return BatchNormalization(
            n_out=nout or nin,
            decay=d.get("decay", 0.9), eps=d.get("eps", 1e-5),
            lock_gamma_beta=bool(d.get("lockGammaBeta", False)),
            **common)
    if type_name == "localResponseNormalization":
        return LocalResponseNormalization(
            n=d.get("n", 5), k=d.get("k", 2.0),
            alpha=d.get("alpha", 1e-4), beta=d.get("beta", 0.75), **common)
    if type_name in ("gravesLSTM", "LSTM"):
        cls = GravesLSTM if type_name == "gravesLSTM" else LSTM
        fb = d.get("forgetGateBiasInit", 1.0)
        return cls(n_in=nin, n_out=nout, forget_gate_bias_init=fb, **common)
    if type_name == "activation":
        return ActivationLayer(**common)
    if type_name == "dropout":
        return DropoutLayer(**common)
    if type_name == "GlobalPooling":
        return GlobalPoolingLayer(
            pooling=(d.get("poolingType") or "MAX").lower(), **common)
    if type_name == "zeroPadding":
        pad = d.get("padding", (0, 0))
        return ZeroPaddingLayer(pad=tuple(pad), **common)
    raise ValueError(f"unsupported DL4J layer type {type_name!r} "
                     f"(supported: dense/output/rnnoutput/loss/embedding/"
                     f"convolution/subsampling/batchNormalization/LRN/"
                     f"gravesLSTM/LSTM/activation/dropout/GlobalPooling/"
                     f"zeroPadding)")


def _layer_to_dl4j(layer) -> Tuple[str, Dict[str, Any]]:
    from deeplearning4j_tpu_torch.nn.layers import (
        ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
        DropoutLayer, EmbeddingLayer, GlobalPoolingLayer, GravesLSTM,
        LocalResponseNormalization, LossLayer, LSTM, OutputLayer,
        RnnOutputLayer, SubsamplingLayer, ZeroPaddingLayer,
    )

    d: Dict[str, Any] = {
        "layerName": layer.name,
        "activationFn": _act_to_dl4j(layer.activation),
        "weightInit": (layer.weight_init or "xavier").upper(),
        "biasInit": layer.bias_init or 0.0,
        "l1": layer.l1 or 0.0, "l2": layer.l2 or 0.0,
        "dropOut": layer.dropout or 0.0,
    }

    def ff(extra=None):
        d.update({"nin": layer.n_in, "nout": layer.n_out})
        d.update(extra or {})
        return d

    if isinstance(layer, RnnOutputLayer):
        return "rnnoutput", ff({"lossFn": _loss_ref(layer.loss)})
    if isinstance(layer, OutputLayer):
        return "output", ff({"lossFn": _loss_ref(layer.loss)})
    if isinstance(layer, LossLayer):
        d["lossFn"] = _loss_ref(layer.loss)
        return "loss", d
    if isinstance(layer, EmbeddingLayer):
        return "embedding", ff()
    if isinstance(layer, ConvolutionLayer) and \
            type(layer).__name__ == "ConvolutionLayer":
        return "convolution", ff({
            "kernelSize": list(_pair(layer.kernel)),
            "stride": list(_pair(layer.stride)),
            "padding": list(_pair(layer.padding)),
            "convolutionMode": (layer.convolution_mode or "truncate").title(),
        })
    if isinstance(layer, SubsamplingLayer):
        d.update({
            "poolingType": layer.pooling.upper(),
            "kernelSize": list(_pair(layer.kernel)),
            "stride": list(_pair(layer.stride)),
            "padding": list(_pair(layer.padding)),
        })
        return "subsampling", d
    if isinstance(layer, BatchNormalization):
        d.update({"nin": layer.n_out, "nout": layer.n_out,
                  "decay": layer.decay, "eps": layer.eps,
                  "lockGammaBeta": layer.lock_gamma_beta})
        return "batchNormalization", d
    if isinstance(layer, LocalResponseNormalization):
        d.update({"n": layer.n, "k": layer.k, "alpha": layer.alpha,
                  "beta": layer.beta})
        return "localResponseNormalization", d
    if isinstance(layer, GravesLSTM):
        return "gravesLSTM", ff(
            {"forgetGateBiasInit": layer.forget_gate_bias_init})
    if isinstance(layer, LSTM):
        return "LSTM", ff(
            {"forgetGateBiasInit": layer.forget_gate_bias_init})
    if isinstance(layer, ActivationLayer):
        return "activation", d
    if isinstance(layer, DropoutLayer):
        return "dropout", d
    if isinstance(layer, GlobalPoolingLayer):
        d["poolingType"] = layer.pooling.upper()
        return "GlobalPooling", d
    if isinstance(layer, ZeroPaddingLayer):
        d["padding"] = list(layer.pad) if isinstance(
            layer.pad, (tuple, list)) else [layer.pad, layer.pad]
        return "zeroPadding", d
    if isinstance(layer, DenseLayer):
        return "dense", ff()
    raise ValueError(
        f"layer type {type(layer).__name__} has no DL4J JSON mapping")


_LOSS_CLASS = {
    # exact DL4J impl class names (org.nd4j.linalg.lossfunctions.impl.*)
    "mcxent": "LossMCXENT",
    "negativeloglikelihood": "LossNegativeLogLikelihood",
    "mse": "LossMSE", "l1": "LossL1", "l2": "LossL2",
    "xent": "LossBinaryXENT", "kl_divergence": "LossKLD",
    "mae": "LossMAE", "msle": "LossMSLE", "mape": "LossMAPE",
    "hinge": "LossHinge", "squared_hinge": "LossSquaredHinge",
    "poisson": "LossPoisson", "cosine_proximity": "LossCosineProximity",
}


def _loss_ref(name) -> Dict[str, Any]:
    cls = _LOSS_CLASS.get(str(name), "LossMCXENT")
    return {"@class": f"org.nd4j.linalg.lossfunctions.impl.{cls}"}


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


# --------------------------------------------------------------------------
# Flat parameter codec (param-initializer ordering)
# --------------------------------------------------------------------------

def _lstm_col_perm(h: int, to_framework: bool) -> np.ndarray:
    """Column permutation between DL4J gate blocks [cand, f, o, i] and this
    framework's [i, f, cand, o] (see module docstring)."""
    blocks_dl4j_to_fw = [3, 1, 0, 2]   # fw block j comes from dl4j block[j]
    idx = np.arange(4 * h).reshape(4, h)
    if to_framework:
        return np.concatenate([idx[b] for b in blocks_dl4j_to_fw])
    # inverse: dl4j block j comes from fw block inv[j]
    inv = [blocks_dl4j_to_fw.index(j) for j in range(4)]
    return np.concatenate([idx[b] for b in inv])


def _params_from_flat(layer, flat: np.ndarray) -> Tuple[
        Dict[str, np.ndarray], Dict[str, np.ndarray], int]:
    """Consume `layer`'s DL4J flat segment; return (params, state, used)."""
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, ConvolutionLayer, LSTM,
    )
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        DenseLayer, EmbeddingLayer,
    )

    if isinstance(layer, ConvolutionLayer) and hasattr(layer, "kernel") \
            and type(layer).__name__ == "ConvolutionLayer":
        kh, kw = _pair(layer.kernel)
        nin, nout = layer.n_in, layer.n_out
        nb, nw = nout, nout * nin * kh * kw
        b = flat[:nb]
        w = flat[nb:nb + nw].reshape((nout, nin, kh, kw), order="C")
        return ({"W": np.transpose(w, (2, 3, 1, 0)).copy(), "b": b.copy()},
                {}, nb + nw)
    if isinstance(layer, BatchNormalization):
        n = layer.n_out
        used = 0
        params: Dict[str, np.ndarray] = {}
        if not layer.lock_gamma_beta:
            params = {"gamma": flat[:n].copy(), "beta": flat[n:2 * n].copy()}
            used = 2 * n
        state = {"mean": flat[used:used + n].copy(),
                 "var": flat[used + n:used + 2 * n].copy()}
        return params, state, used + 2 * n
    if isinstance(layer, LSTM):          # covers GravesLSTM
        h, nin = layer.n_out, layer.n_in
        peep = layer.peephole
        rw_cols = 4 * h + (3 if peep else 0)
        n_w, n_rw, n_b = nin * 4 * h, h * rw_cols, 4 * h
        perm = _lstm_col_perm(h, to_framework=True)
        w = flat[:n_w].reshape((nin, 4 * h), order="F")[:, perm]
        rw_full = flat[n_w:n_w + n_rw].reshape((h, rw_cols), order="F")
        rw = rw_full[:, :4 * h][:, perm]
        b = flat[n_w + n_rw:n_w + n_rw + n_b][perm]
        params = {"W": w.copy(), "RW": rw.copy(), "b": b.copy()}
        if peep:
            # cols: 4H=wFF(forget), 4H+1=wOO(output), 4H+2=wGG(input)
            params["P"] = np.stack([
                rw_full[:, 4 * h + 2],   # input peephole
                rw_full[:, 4 * h],       # forget peephole
                rw_full[:, 4 * h + 1],   # output peephole
            ]).copy()
        return params, {}, n_w + n_rw + n_b
    if isinstance(layer, (DenseLayer, EmbeddingLayer)):  # + Output subclasses
        nin, nout = layer.n_in, layer.n_out
        nw = nin * nout
        w = flat[:nw].reshape((nin, nout), order="F")
        params = {"W": w.copy()}
        used = nw
        if getattr(layer, "has_bias", True):
            params["b"] = flat[nw:nw + nout].copy()
            used += nout
        return params, {}, used
    return {}, {}, 0    # parameterless layer


def _params_to_flat(layer, params: Dict[str, Any],
                    state: Dict[str, Any]) -> np.ndarray:
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, ConvolutionLayer, LSTM,
    )
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        DenseLayer, EmbeddingLayer,
    )

    f32 = _host

    if isinstance(layer, ConvolutionLayer) \
            and type(layer).__name__ == "ConvolutionLayer":
        w = np.transpose(f32(params["W"]), (3, 2, 0, 1))  # HWIO -> OIHW
        # DL4J convs ALWAYS carry a bias (this 0.8-era reference predates
        # the hasBias option entirely — no such field exists in its conf
        # package); a has_bias=False conv (conv+BN stacks like ResNet)
        # exports a zero bias — numerically identical
        b = (f32(params["b"]) if "b" in params
             else np.zeros((layer.n_out,), np.float32))
        return np.concatenate([b.ravel(), w.reshape(-1, order="C")])
    if isinstance(layer, BatchNormalization):
        parts = []
        if not layer.lock_gamma_beta:
            parts += [f32(params["gamma"]).ravel(),
                      f32(params["beta"]).ravel()]
        parts += [f32(state["mean"]).ravel(), f32(state["var"]).ravel()]
        return np.concatenate(parts)
    if isinstance(layer, LSTM):
        h = layer.n_out
        perm = _lstm_col_perm(h, to_framework=False)
        w = f32(params["W"])[:, perm]
        rw = f32(params["RW"])[:, perm]
        b = f32(params["b"])[perm]
        if layer.peephole:
            p = f32(params["P"])
            extra = np.stack([p[1], p[2], p[0]], axis=1)  # wFF, wOO, wGG
            rw = np.concatenate([rw, extra], axis=1)
        return np.concatenate([w.reshape(-1, order="F"),
                               rw.reshape(-1, order="F"), b.ravel()])
    if isinstance(layer, (DenseLayer, EmbeddingLayer)):
        parts = [f32(params["W"]).reshape(-1, order="F")]
        # same asymmetry guard as the conv branch: the config JSON never
        # carries hasBias, so the importer always reads a bias — export a
        # zero one for has_bias=False layers to keep offsets aligned
        parts.append(f32(params["b"]).ravel() if "b" in params
                     else np.zeros((layer.n_out,), np.float32))
        return np.concatenate(parts)
    return np.zeros((0,), np.float32)


# --------------------------------------------------------------------------
# Zip container import / export
# --------------------------------------------------------------------------

def import_dl4j_model(path, *, input_type=None, updater=None, dtype=None,
                      device=None):
    """Load a DL4J MultiLayerNetwork zip (configuration.json +
    coefficients.bin [+ updaterState.bin]) into a MultiLayerNetwork (or a
    ComputationGraph zip into a ComputationGraph) on `device` (CUDA by
    default).

    input_type: optional InputType for shape-dependent nets (CNNs); when
    omitted the layer nIn/nOut fields from the config are used as-is.
    The raw updater-state vector (if present) is attached as
    ``net.dl4j_updater_state`` — DL4J updater blocks don't map 1:1 onto
    this framework's per-layer optimizer pytrees, so remapping is left to
    the caller.
    """
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.optim.updaters import Sgd

    with zipfile.ZipFile(path) as zf:
        conf_json = json.loads(zf.read("configuration.json"))
        coeffs = read_nd4j_array(zf.read("coefficients.bin"))
        upd_raw = None
        for entry in ("updaterState.bin", "updater.bin"):
            if entry in zf.namelist():
                try:
                    upd_raw = read_nd4j_array(zf.read(entry))
                except ValueError as e:
                    # old updater.bin is Java serialization — silent skip
                    # is correct; a corrupt/truncated updaterState.bin
                    # must be VISIBLE (params still import fine)
                    if entry == "updaterState.bin":
                        import warnings

                        warnings.warn(
                            f"ignoring unreadable {entry}: {e}")
                break

    if "vertices" in conf_json:
        return _import_dl4j_graph(conf_json, coeffs, upd_raw,
                                  updater=updater, dtype=dtype,
                                  input_type=input_type, device=device)

    layers = []
    for conf in conf_json.get("confs", []):
        wrapper = conf["layer"]
        (type_name, layer_json), = wrapper.items()
        layers.append(_layer_from_dl4j(type_name, layer_json))

    builder = NeuralNetConfiguration.builder()
    if updater is not None:
        builder = builder.updater(updater)
    else:
        builder = builder.updater(Sgd(0.1))
    lb = builder.list(*layers)
    if input_type is not None:
        lb = lb.set_input_type(input_type)
    tf = conf_json.get("tbpttFwdLength") or 0
    tb = conf_json.get("tbpttBackLength") or 0
    if tf:
        lb = lb.tbptt(tf, tb or tf)
    mlconf = lb.build()
    if dtype is not None:
        mlconf = dataclasses.replace(mlconf, dtype=dtype)
    net = MultiLayerNetwork(mlconf, device=device).init()

    flat = np.asarray(coeffs, np.float32).ravel(order="C")
    off = 0
    for layer in net.layers:
        off = _assign_flat_segment(net, layer.name, layer, flat, off)
    if off != flat.size:
        raise ValueError(
            f"coefficients.bin has {flat.size} params, config consumes {off}")
    net.dl4j_updater_state = upd_raw
    return net


def _assign_flat_segment(net, name, layer, flat, off):
    """Slice one layer's DL4J flat segment into net.params_tree/state_tree
    with error context (shared by the MLN and graph importers); each array
    is copied into the layer's tensor of that key (its device and dtype)."""
    try:
        p, s, used = _params_from_flat(layer, flat[off:])
    except ValueError as e:
        raise ValueError(
            f"coefficients.bin too short for layer {name!r} "
            f"({type(layer).__name__}) at offset {off}: {e}") from None
    if p:
        params_from_numpy(net, {name: p}, partial=True)
    if s:
        state_from_numpy(net, {name: s}, partial=True)
    return off + used


def _host(a) -> np.ndarray:
    """A tensor (any device or dtype) or array as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def _updater_vector(net) -> np.ndarray:
    """The updater state's leaves in the JAX package's order (dict keys
    sorted, depth first), raveled into one float32 vector."""
    leaves = ravel_leaves(net.updater_state)
    return (np.concatenate([_host(l).ravel() for l in leaves])
            if leaves else np.zeros((0,), np.float32))


def _dl4j_topo_order(network_inputs, vertex_names, vertex_inputs):
    """Reproduce DL4J's topological order (`ComputationGraph.
    topologicalSortOrder():1082` — Kahn's with a FIFO queue over integer
    vertex ids: network inputs first, then vertices in JSON insertion
    order; successor sets iterate in ascending id order, matching
    HashSet<Integer> behavior for small ints). Flat params are sliced in
    THIS order (`init():416-430`), so it defines coefficient layout."""
    names = list(network_inputs) + list(vertex_names)
    idx = {n: i for i, n in enumerate(names)}
    preds = {i: set() for i in range(len(names))}
    succs = {i: set() for i in range(len(names))}
    for name in vertex_names:
        for src in vertex_inputs.get(name, ()):
            preds[idx[name]].add(idx[src])
            succs[idx[src]].add(idx[name])
    queue = [i for i in range(len(names)) if not preds[i]]
    order = []
    while queue:
        nxt = queue.pop(0)
        order.append(nxt)
        for v in sorted(succs[nxt]):
            preds[v].discard(nxt)
            if not preds[v]:
                queue.append(v)
    if len(order) != len(names):
        raise ValueError("cycle in ComputationGraph configuration")
    return [names[i] for i in order]


def _vertex_from_dl4j(type_name: str, body: Dict[str, Any]):
    """DL4J graph-vertex JSON (wrapper-object unwrapped) → (our vertex,
    layer-or-None). Reference: `nn/conf/graph/*` @JsonSubTypes names."""
    from deeplearning4j_tpu_torch.nn import graph as G

    if type_name == "LayerVertex":
        layer_wrapper = body["layerConf"]["layer"]
        (ltype, ljson), = layer_wrapper.items()
        layer = _layer_from_dl4j(ltype, ljson)
        pre = None
        pp = body.get("preProcessor")
        if pp:
            pre = _preprocessor_from_dl4j(pp)
        return G.LayerVertex(layer=layer, preprocessor=pre), layer
    if type_name == "MergeVertex":
        return G.MergeVertex(), None
    if type_name == "ElementWiseVertex":
        return G.ElementWiseVertex(op=str(body.get("op", "Add")).lower()), None
    if type_name == "SubsetVertex":
        return G.SubsetVertex(from_=body.get("from", 0),
                              to=body.get("to", 0)), None
    if type_name == "ScaleVertex":
        return G.ScaleVertex(scale=body.get("scaleFactor", 1.0)), None
    if type_name == "StackVertex":
        return G.StackVertex(), None
    if type_name == "UnstackVertex":
        return G.UnstackVertex(from_=body.get("from", 0),
                               stack_size=body.get("stackSize", 1)), None
    if type_name == "L2NormalizeVertex":
        return G.L2NormalizeVertex(), None
    if type_name == "L2Vertex":
        return G.L2Vertex(), None
    if type_name == "PoolHelperVertex":
        return G.PoolHelperVertex(), None
    if type_name == "LastTimeStepVertex":
        return G.LastTimeStepVertex(
            mask_input=body.get("maskArrayInputName")), None
    if type_name == "DuplicateToTimeSeriesVertex":
        # our vertex carries STATIC timesteps (XLA needs static shapes);
        # DL4J reads T at runtime from the named input. Our exports write
        # a "timesteps" key; genuine DL4J zips don't have one, and
        # guessing would silently broadcast to the wrong length.
        t = body.get("timesteps")
        if t is None:
            raise ValueError(
                "DuplicateToTimeSeriesVertex in a DL4J zip carries no "
                "static timestep count (DL4J resolves it at runtime from "
                f"input {body.get('inputName')!r}); rebuild this vertex "
                "with an explicit length after import")
        return G.DuplicateToTimeSeriesVertex(timesteps=int(t)), None
    raise ValueError(f"unsupported DL4J graph vertex type {type_name!r}")


_PP_CLASS_BASE = "org.deeplearning4j.nn.conf.preprocessor."


def _preprocessor_to_dl4j(pre) -> Dict[str, Any]:
    from deeplearning4j_tpu_torch.nn import preprocessors as P

    if isinstance(pre, P.CnnToFeedForward):
        return {"@class": _PP_CLASS_BASE + "CnnToFeedForwardPreProcessor",
                "inputHeight": pre.height, "inputWidth": pre.width,
                "numChannels": pre.channels}
    if isinstance(pre, P.FeedForwardToCnn):
        return {"@class": _PP_CLASS_BASE + "FeedForwardToCnnPreProcessor",
                "inputHeight": pre.height, "inputWidth": pre.width,
                "numChannels": pre.channels}
    if isinstance(pre, P.FeedForwardToRnn):
        return {"@class": _PP_CLASS_BASE + "FeedForwardToRnnPreProcessor"}
    if isinstance(pre, P.RnnToFeedForward):
        return {"@class": _PP_CLASS_BASE + "RnnToFeedForwardPreProcessor"}
    if isinstance(pre, P.RnnToCnn):
        return {"@class": _PP_CLASS_BASE + "RnnToCnnPreProcessor",
                "inputHeight": pre.height, "inputWidth": pre.width,
                "numChannels": pre.channels}
    if isinstance(pre, P.CnnToRnn):
        return {"@class": _PP_CLASS_BASE + "CnnToRnnPreProcessor"}
    raise ValueError(
        f"preprocessor {type(pre).__name__} has no DL4J JSON mapping")


def _preprocessor_from_dl4j(pp: Dict[str, Any]):
    from deeplearning4j_tpu_torch.nn import preprocessors as P

    cls = pp.get("@class", "")
    if "CnnToFeedForward" in cls:
        return P.CnnToFeedForward()
    if "FeedForwardToCnn" in cls:
        return P.FeedForwardToCnn(
            height=pp.get("inputHeight"), width=pp.get("inputWidth"),
            channels=pp.get("numChannels"))
    if "FeedForwardToRnn" in cls:
        return P.FeedForwardToRnn()
    if "RnnToFeedForward" in cls:
        return P.RnnToFeedForward()
    if "RnnToCnn" in cls:
        return P.RnnToCnn(height=pp.get("inputHeight"),
                          width=pp.get("inputWidth"),
                          channels=pp.get("numChannels"))
    if "CnnToRnn" in cls:
        return P.CnnToRnn()
    raise ValueError(f"unsupported DL4J preprocessor {cls!r}")


def _import_dl4j_graph(conf_json, coeffs, upd_raw, *, updater=None,
                       dtype=None, input_type=None, device=None):
    """DL4J ComputationGraph zip → ComputationGraph. Reference:
    `nn/conf/ComputationGraphConfiguration.java` (vertices/vertexInputs/
    networkInputs/networkOutputs JSON) + the topological flat-param
    layout of `ComputationGraph.init():382-443`."""
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.optim.updaters import Sgd

    vertices_json = conf_json["vertices"]
    vertex_inputs = {k: list(v)
                     for k, v in conf_json.get("vertexInputs", {}).items()}
    net_inputs = list(conf_json.get("networkInputs", []))
    net_outputs = list(conf_json.get("networkOutputs", []))

    g = (NeuralNetConfiguration.builder()
         .updater(updater if updater is not None else Sgd(0.1))
         .graph_builder())
    g.add_inputs(*net_inputs)
    if input_type is not None:
        # single InputType (applied to the sole/first input) or a dict
        # name → InputType for multi-input graphs
        if isinstance(input_type, dict):
            g.set_input_types(*[input_type[n] for n in net_inputs])
        else:
            g.set_input_types(input_type)
    layer_for_vertex: Dict[str, Any] = {}
    for name, wrapper in vertices_json.items():
        (type_name, body), = wrapper.items()
        vertex, layer = _vertex_from_dl4j(type_name, body)
        if layer is not None:
            layer_for_vertex[name] = layer
            g.add_layer(name, layer, *vertex_inputs.get(name, ()),
                        preprocessor=vertex.preprocessor)
        else:
            g.add_vertex(name, vertex, *vertex_inputs.get(name, ()))
    g.set_outputs(*net_outputs)
    conf = g.build()
    if dtype is not None:
        conf = dataclasses.replace(conf, dtype=dtype)
    net = ComputationGraph(conf, device=device).init()

    flat = np.asarray(coeffs, np.float32).ravel(order="C")
    off = 0
    for name in _dl4j_topo_order(net_inputs, vertices_json.keys(),
                                 vertex_inputs):
        if name not in layer_for_vertex:
            continue
        # our LayerVertex stores the (possibly n_in-inferred) layer copy
        built = conf.vertices[name].layer
        off = _assign_flat_segment(net, name, built, flat, off)
    if off != flat.size:
        raise ValueError(
            f"coefficients.bin has {flat.size} params, graph config "
            f"consumes {off}")
    net.dl4j_updater_state = upd_raw
    return net


def _vertex_to_dl4j(vertex) -> Tuple[str, Dict[str, Any]]:
    from deeplearning4j_tpu_torch.nn import graph as G

    if isinstance(vertex, G.LayerVertex):
        ltype, ljson = _layer_to_dl4j(vertex.layer)
        body: Dict[str, Any] = {"layerConf": {"layer": {ltype: ljson}}}
        if vertex.preprocessor is not None:
            body["preProcessor"] = _preprocessor_to_dl4j(vertex.preprocessor)
        return "LayerVertex", body
    if isinstance(vertex, G.MergeVertex):
        return "MergeVertex", {}
    if isinstance(vertex, G.ElementWiseVertex):
        # canonical DL4J Op enum names (ElementWiseVertex.Op), not .title()
        ops = {"add": "Add", "sub": "Subtract", "subtract": "Subtract",
               "mul": "Product", "product": "Product",
               "avg": "Average", "average": "Average", "max": "Max"}
        return "ElementWiseVertex", {"op": ops.get(vertex.op.lower(),
                                                   vertex.op.title())}
    if isinstance(vertex, G.SubsetVertex):
        return "SubsetVertex", {"from": vertex.from_, "to": vertex.to}
    if isinstance(vertex, G.ScaleVertex):
        return "ScaleVertex", {"scaleFactor": vertex.scale}
    if isinstance(vertex, G.StackVertex):
        return "StackVertex", {}
    if isinstance(vertex, G.UnstackVertex):
        return "UnstackVertex", {"from": vertex.from_,
                                 "stackSize": vertex.stack_size}
    if isinstance(vertex, G.L2NormalizeVertex):
        return "L2NormalizeVertex", {}
    if isinstance(vertex, G.L2Vertex):
        return "L2Vertex", {}
    if isinstance(vertex, G.PoolHelperVertex):
        return "PoolHelperVertex", {}
    if isinstance(vertex, G.LastTimeStepVertex):
        return "LastTimeStepVertex", {"maskArrayInputName": vertex.mask_input}
    if isinstance(vertex, G.DuplicateToTimeSeriesVertex):
        # "timesteps" is our static-shape extension (see import side)
        return "DuplicateToTimeSeriesVertex", {"timesteps": vertex.timesteps}
    raise ValueError(
        f"vertex type {type(vertex).__name__} has no DL4J JSON mapping")


def _export_dl4j_graph(net, path, *, save_updater: bool = False) -> None:
    """ComputationGraph → DL4J-layout zip (vertices/vertexInputs JSON +
    topologically-ordered flat coefficients, matching
    `ComputationGraph.init():416-430`)."""
    conf = net.conf
    net_inputs = list(conf.network_inputs)
    vertices_json: Dict[str, Any] = {}
    vertex_inputs: Dict[str, List[str]] = {}
    for name, v in conf.vertices.items():
        if name in net_inputs:
            continue
        type_name, body = _vertex_to_dl4j(v)
        vertices_json[name] = {type_name: body}
        vertex_inputs[name] = list(conf.vertex_inputs.get(name, ()))

    conf_json = {
        "vertices": vertices_json,
        "vertexInputs": vertex_inputs,
        "networkInputs": net_inputs,
        "networkOutputs": list(conf.network_outputs),
        "backprop": True, "pretrain": False,
    }

    segs: List[np.ndarray] = []
    from deeplearning4j_tpu_torch.nn.graph import LayerVertex

    for name in _dl4j_topo_order(net_inputs, vertices_json.keys(),
                                 vertex_inputs):
        v = conf.vertices.get(name)
        if not isinstance(v, LayerVertex):
            continue
        segs.append(_params_to_flat(
            v.layer, net.params_tree.get(name, {}),
            net.state_tree.get(name, {})))
    flat = (np.concatenate([s for s in segs if s.size])
            if any(s.size for s in segs) else np.zeros((0,), np.float32))

    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf_json, indent=2))
        buf = io.BytesIO()
        write_nd4j_array(buf, flat.reshape(1, -1))
        zf.writestr("coefficients.bin", buf.getvalue())
        if save_updater:
            state = _updater_vector(net)
            buf = io.BytesIO()
            write_nd4j_array(buf, state.reshape(1, -1))
            zf.writestr("updaterState.bin", buf.getvalue())


def export_dl4j_model(net, path, *, save_updater: bool = False) -> None:
    """Write `net` as a DL4J-layout zip: the reference's ModelSerializer
    container (configuration.json + coefficients.bin). MultiLayerNetwork
    and ComputationGraph both supported.

    save_updater flattens the optimizer state in the JAX package's leaf
    order (dict keys sorted) — layout differs from DL4J's updater blocks
    (documented; primarily for round-trips between the two packages).
    """
    if hasattr(net.conf, "vertices"):
        return _export_dl4j_graph(net, path, save_updater=save_updater)
    confs = []
    for layer in net.layers:
        type_name, layer_json = _layer_to_dl4j(layer)
        confs.append({"layer": {type_name: layer_json}})

    conf_json = {
        "backprop": True,
        "backpropType": "Standard",
        "pretrain": False,
        "confs": confs,
        "tbpttFwdLength": getattr(net.conf, "tbptt_fwd_length", 0) or 0,
        "tbpttBackLength": getattr(net.conf, "tbptt_back_length", 0) or 0,
    }

    segs: List[np.ndarray] = []
    for layer in net.layers:
        segs.append(_params_to_flat(
            layer, net.params_tree.get(layer.name, {}),
            net.state_tree.get(layer.name, {})))
    flat = (np.concatenate([s for s in segs if s.size])
            if any(s.size for s in segs) else np.zeros((0,), np.float32))

    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf_json, indent=2))
        buf = io.BytesIO()
        write_nd4j_array(buf, flat.reshape(1, -1))
        zf.writestr("coefficients.bin", buf.getvalue())
        if save_updater:
            state = _updater_vector(net)
            buf = io.BytesIO()
            write_nd4j_array(buf, state.reshape(1, -1))
            zf.writestr("updaterState.bin", buf.getvalue())
