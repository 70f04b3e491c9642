"""Feed-forward layers: Dense, Output, Embedding, EmbeddingSequence
(port of `deeplearning4j_tpu/nn/layers/feedforward.py`).

Kernels are stored [n_in, n_out] and applied as `x @ W`, the JAX
package's orientation, so its params tree loads without transposes."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.losses import LossFunction


@register_layer
@dataclasses.dataclass(frozen=True)
class DenseLayer(Layer):
    """Fully connected layer."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True

    def infer_n_in(self, input_type: InputType) -> "DenseLayer":
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.flat_size())
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        if not (self.n_in and self.n_out):
            raise ValueError(f"{self.name}: n_in/n_out unset")
        params = {"W": self._winit()(gen, (self.n_in, self.n_out), dtype)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init or 0.0,
                                     dtype=dtype)
        return params, {}

    def pre_output(self, params, x):
        y = x @ params["W"]
        if self.has_bias:
            y = y + params["b"]
        return y

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        x = self._maybe_dropout(x, train, rng)
        return self._act(self.pre_output(params, x)), state


@register_layer
@dataclasses.dataclass(frozen=True)
class OutputLayer(DenseLayer):
    """Dense + loss head; the network scores it through `score`."""

    loss: Any = "mcxent"

    @property
    def is_output_layer(self) -> bool:
        return True

    def score(self, params, x, labels, mask=None):
        """Mean per-example loss from the layer INPUT activations; the
        loss receives the pre-activation output so its fused stable form
        applies."""
        return LossFunction.get(self.loss)(labels, self.pre_output(params, x),
                                           self.activation, mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class EmbeddingLayer(Layer):
    """Index -> vector lookup, one index per example."""

    n_in: Optional[int] = None    # vocab size
    n_out: Optional[int] = None
    has_bias: bool = True

    def infer_n_in(self, input_type: InputType) -> "EmbeddingLayer":
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.flat_size())
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        params = {"W": self._winit()(gen, (self.n_in, self.n_out), dtype)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init or 0.0,
                                     dtype=dtype)
        return params, {}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        idx = x[..., 0] if x.ndim == 2 and x.shape[-1] == 1 else x
        emb = torch.index_select(params["W"], 0, idx.long().reshape(-1))
        emb = emb.reshape(*idx.shape, params["W"].shape[1])
        if self.has_bias:
            emb = emb + params["b"]
        return self._act(emb), state


@register_layer
@dataclasses.dataclass(frozen=True)
class EmbeddingSequenceLayer(Layer):
    """[batch, time] indices -> [batch, time, n_out] vectors."""

    CONSUMES = "rnn"

    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"W": self._winit()(gen, (self.n_in, self.n_out), dtype)}, {}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        if x.ndim == 3 and x.shape[-1] == 1:
            x = x[..., 0]          # [B, T, 1] token-id tensors
        # index_select: its backward is an index_add_, with no host sync
        idx = x.long().reshape(-1)
        emb = torch.index_select(params["W"], 0, idx).reshape(
            *x.shape, params["W"].shape[1])
        return self._act(emb), state
