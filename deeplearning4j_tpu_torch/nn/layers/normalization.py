"""Batch normalization (port of `BatchNormalization` in
`deeplearning4j_tpu/nn/layers/normalization.py`).

Normalizes over every axis but the trailing channel/feature axis (NHWC,
[B, T, F] or [B, F]). In training the batch mean and the BIASED
variance (`jnp.var`: `correction=0` here; `torch.var` defaults to the
unbiased one) normalize, and the running statistics, non-trainable
state in the layer's dtype, move by the `decay` EMA; in eval the
running statistics normalize."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer
@dataclasses.dataclass(frozen=True)
class BatchNormalization(Layer):
    """Batch norm over the trailing axis; gamma/beta trainable, running
    mean/var state."""

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
              mask=None):
        axes = tuple(range(x.ndim - 1))
        if train:
            mean = x.mean(axes)
            var = x.var(axes, correction=0)
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
