"""Normalization layers (port of
`deeplearning4j_tpu/nn/layers/normalization.py`): `BatchNormalization`,
`LocalResponseNormalization` and `LayerNormalization`.

Batch normalization normalizes over every axis but the trailing
channel/feature axis (NHWC, [B, T, F] or [B, F]). In training the batch mean and the BIASED
variance (`jnp.var`: `correction=0` here; `torch.var` defaults to the
unbiased one) normalize, and the running statistics, non-trainable
state in the layer's dtype, move by the `decay` EMA; in eval the
running statistics normalize. Layer normalization also takes the biased
variance, with eps inside the square root."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


def _batch_moments(x, axes, group=None):
    """The batch mean and biased variance over `axes`: of this rank's
    rows, or, with a data-parallel step's `group` (a `parallel.
    distributed.BatchStatsGroup`), of the GLOBAL batch across its ranks,
    as the JAX package's sharded step computes them."""
    if group is None:
        return x.mean(axes), x.var(axes, correction=0)
    count = (x.numel() // x.shape[-1]) * group.size
    mean = group.sum(x.sum(axes)) / count
    var = group.sum(((x - mean) ** 2).sum(axes)) / count
    return mean, var


@register_layer
@dataclasses.dataclass(frozen=True)
class BatchNormalization(Layer):
    """Batch norm over the trailing axis; gamma/beta trainable, running
    mean/var state."""

    BATCH_STATS = True

    n_out: Optional[int] = None   # feature count, inferred
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    scale: bool = True            # learnable gamma
    center: bool = True           # learnable beta

    def infer_n_in(self, input_type: InputType) -> "BatchNormalization":
        if self.n_out is None:
            feat = (input_type.channels if input_type.kind in ("cnn", "cnn3d")
                    else input_type.size if input_type.kind == "rnn"
                    else input_type.flat_size())
            return dataclasses.replace(self, n_out=feat)
        return self

    def init_params(self, gen, input_type, dtype=torch.float32):
        f = self.n_out
        params = {}
        if not self.lock_gamma_beta:
            if self.scale:
                params["gamma"] = torch.ones((f,), dtype=dtype)
            if self.center:
                params["beta"] = torch.zeros((f,), dtype=dtype)
        state = {"mean": torch.zeros((f,), dtype=dtype),
                 "var": torch.ones((f,), dtype=dtype)}
        return params, state

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None, stats_group=None):
        axes = tuple(range(x.ndim - 1))
        if train:
            mean, var = _batch_moments(x, axes, stats_group)
            d = self.decay
            new_state = {"mean": d * state["mean"] + (1 - d) * mean.detach(),
                         "var": d * state["var"] + (1 - d) * var.detach()}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if not self.lock_gamma_beta:
            if self.scale:
                y = y * params["gamma"]
            if self.center:
                y = y + params["beta"]
        return self._act(y), new_state


@register_layer
@dataclasses.dataclass(frozen=True)
class LocalResponseNormalization(Layer):
    """Cross-channel LRN (AlexNet) over NHWC input: x / (k + α/n · Σ
    x²)^β, the sum over a window of n adjacent channels, zero-padded by
    n // 2 at both edges (so the first and last channels see fewer
    terms). Plain torch ops, summed window slice by slice in JAX's
    order."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        half = self.n // 2
        padded = F.pad(x * x, (half, half))
        c = x.shape[-1]
        acc = 0
        for i in range(self.n):
            acc = acc + padded[..., i:i + c]
        denom = (self.k + (self.alpha / self.n) * acc) ** self.beta
        return x / denom, state


@register_layer
@dataclasses.dataclass(frozen=True)
class LayerNormalization(Layer):
    """Layer norm over the trailing feature axis: biased variance, eps
    inside the square root, then gamma, beta and the activation."""

    n_out: Optional[int] = None
    eps: float = 1e-6

    def infer_n_in(self, input_type: InputType) -> "LayerNormalization":
        if self.n_out is None:
            feat = (input_type.size if input_type.kind == "rnn"
                    else input_type.flat_size())
            return dataclasses.replace(self, n_out=feat)
        return self

    def init_params(self, gen, input_type, dtype=torch.float32):
        f = self.n_out
        return {"gamma": torch.ones((f,), dtype=dtype),
                "beta": torch.zeros((f,), dtype=dtype)}, {}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return self._act(y * params["gamma"] + params["beta"]), state
