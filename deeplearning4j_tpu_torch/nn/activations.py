"""Activation functions — the subset of `deeplearning4j_tpu/nn/activations.py`
that the ported layers use, over torch tensors.

`gelu` is the tanh approximation, matching `jax.nn.gelu`'s default."""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch
import torch.nn.functional as F


def identity(x):
    return x


def relu(x):
    return F.relu(x)


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


def softplus(x):
    return F.softplus(x)


def softsign(x):
    return F.softsign(x)


def softmax(x):
    """Softmax over the trailing feature axis (class axis)."""
    return torch.softmax(x, dim=-1)


def log_softmax(x):
    return torch.log_softmax(x, dim=-1)


_REGISTRY: Dict[str, Callable] = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "gelu": gelu,
    "silu": silu,
    "swish": silu,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "softplus": softplus,
    "softsign": softsign,
    "softmax": softmax,
    "logsoftmax": log_softmax,
}


class Activation:
    """Name lookup mirroring the JAX package's `Activation.get`."""

    @staticmethod
    def get(name_or_fn: Union[str, Callable, None]) -> Callable:
        if name_or_fn is None:
            return identity
        if callable(name_or_fn):
            return name_or_fn
        key = str(name_or_fn).lower()
        if key not in _REGISTRY:
            raise ValueError(
                f"Unknown activation {name_or_fn!r}; the port has "
                f"{sorted(_REGISTRY)}")
        return _REGISTRY[key]
