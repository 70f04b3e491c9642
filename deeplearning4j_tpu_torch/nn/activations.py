"""Activation functions over torch tensors (port of
`deeplearning4j_tpu/nn/activations.py`): the same 25 names, the same
formulas, and the same `"name:value"` form for a parametrised one
(`"leakyrelu:0.2"`, `"elu:0.5"`, `"thresholdedrelu:1.5"`), which stays a
plain string in a configuration's JSON.

`gelu` is the tanh approximation and `softplus` is `log(e^x + 1)` by
`logaddexp`, as `jax.nn.gelu` and `jax.nn.softplus` compute them, so a
JAX configuration gives the same forward here."""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch
import torch.nn.functional as F


def identity(x):
    return x


def relu(x):
    return F.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def leakyrelu(x, alpha: float = 0.01):
    return torch.where(x >= 0, x, alpha * x)


def elu(x, alpha: float = 1.0):
    # expm1 of the clamped input: no inf in the branch not taken
    return torch.where(x > 0, x, alpha * torch.expm1(torch.clamp(x, max=0.0)))


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def selu(x):
    return _SELU_SCALE * elu(x, _SELU_ALPHA)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def tanh(x):
    return torch.tanh(x)


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def rationaltanh(x):
    """ND4J's ActivationRationalTanh: 1.7159 * tanh_approx(2x/3), the
    tanh approximated by a rational polynomial."""
    a = 0.6666667 * x
    approx = torch.sign(a) * (1.0 - 1.0 / (1.0 + a.abs() + a * a
                                           + 1.41645 * a ** 4))
    return 1.7159 * approx


def rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def softsign(x):
    return F.softsign(x)


def cube(x):
    return x * x * x


def mish(x):
    return x * torch.tanh(softplus(x))


def softmax(x):
    """Softmax over the trailing feature axis (class axis)."""
    return torch.softmax(x, dim=-1)


def log_softmax(x):
    return torch.log_softmax(x, dim=-1)


def exp(x):
    return torch.exp(x)


def clippedrelu(x, max_value: float = 6.0):
    return torch.clamp(x, 0.0, max_value)


def thresholdedrelu(x, theta: float = 1.0):
    return torch.where(x > theta, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


_REGISTRY: Dict[str, Callable] = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "silu": silu,
    "swish": silu,
    "mish": mish,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softplus": softplus,
    "softsign": softsign,
    "cube": cube,
    "softmax": softmax,
    "logsoftmax": log_softmax,
    "thresholdedrelu": thresholdedrelu,
    "exp": exp,
    "clippedrelu": clippedrelu,
}


class Activation:
    """Name lookup and constants mirroring the JAX package's
    `Activation` (DL4J's `Activation` enum)."""

    IDENTITY = "identity"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SWISH = "swish"
    MISH = "mish"
    SIGMOID = "sigmoid"
    HARDSIGMOID = "hardsigmoid"
    TANH = "tanh"
    HARDTANH = "hardtanh"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    CUBE = "cube"
    SOFTMAX = "softmax"
    LOGSOFTMAX = "logsoftmax"

    @staticmethod
    def get(name_or_fn: Union[str, Callable, None]) -> Callable:
        if name_or_fn is None:
            return identity
        if callable(name_or_fn):
            return name_or_fn
        key = str(name_or_fn).lower()
        if ":" in key:
            base, _, arg = key.partition(":")
            if base in _REGISTRY and arg:
                fn, val = _REGISTRY[base], float(arg)
                return lambda x: fn(x, val)
        if key not in _REGISTRY:
            raise ValueError(
                f"Unknown activation {name_or_fn!r}; known: "
                f"{sorted(_REGISTRY)}")
        return _REGISTRY[key]

    @staticmethod
    def register(name: str, fn: Callable) -> None:
        """Add a custom activation under `name` (lower-cased)."""
        _REGISTRY[name.lower()] = fn

    @staticmethod
    def names():
        return sorted(_REGISTRY)


def resolve(name_or_fn) -> Callable:
    return Activation.get(name_or_fn)
