"""Feed-forward layers: Dense, Output, Loss, Activation, PReLU, Dropout,
Embedding, EmbeddingSequence and the pretrainable AutoEncoder (port of
`deeplearning4j_tpu/nn/layers/feedforward.py`).

Kernels are stored [n_in, n_out] and applied as `x @ W`, the JAX
package's orientation, so its params tree loads without transposes.

The AutoEncoder's corruption mask is drawn by `_keep_mask` alone, so a
test can put JAX's draws in its place."""

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
class LossLayer(Layer):
    """A loss head without parameters: the activation and the loss of
    its input (DL4J's `LossLayer`)."""

    loss: Any = "mcxent"

    @property
    def is_output_layer(self) -> bool:
        return True

    def pre_output(self, params, x):
        return x

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        return self._act(x), state

    def score(self, params, x, labels, mask=None):
        return LossFunction.get(self.loss)(labels, x, self.activation, mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class ActivationLayer(Layer):
    """Parameterless activation."""

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        return self._act(x), state


@register_layer
@dataclasses.dataclass(frozen=True)
class PReLULayer(Layer):
    """Parametric ReLU: a learnable slope `alpha` per feature (the
    trailing axis: channels of a convolution's output), initialised to
    `alpha_init`."""

    n_out: Optional[int] = None
    alpha_init: float = 0.0

    def _width(self, input_type: InputType) -> int:
        return (input_type.channels if input_type.kind in ("cnn", "cnn3d")
                else input_type.size)

    def infer_n_in(self, input_type: InputType) -> "PReLULayer":
        if self.n_out is None:
            return dataclasses.replace(self, n_out=self._width(input_type))
        return self

    def init_params(self, gen, input_type, dtype=torch.float32):
        n = self.n_out if self.n_out is not None else \
            self._width(input_type)
        return {"alpha": torch.full((n,), self.alpha_init, dtype=dtype)}, {}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        return torch.where(x >= 0, x, params["alpha"] * x), state


@register_layer
@dataclasses.dataclass(frozen=True)
class DropoutLayer(Layer):
    """Standalone inverted dropout of its input (drop probability
    `dropout`), drawn from `rng` only when training."""

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        return self._maybe_dropout(x, train, rng), state


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


def _keep_mask(gen, keep: float, shape, device) -> torch.Tensor:
    """AutoEncoder's corruption: True where an input is kept, each with
    probability `keep`, from the generator `gen`."""
    return torch.rand(shape, generator=gen, device=device) < keep


@register_layer
@dataclasses.dataclass(frozen=True)
class AutoEncoder(Layer):
    """Denoising autoencoder with tied weights, layerwise-pretrainable
    (DL4J's `AutoEncoder`). The supervised forward is the encoder;
    `reconstruction_score` (the pretraining objective) decodes through
    W transposed and the visible bias `vb`, with the input corrupted
    (each entry zeroed with probability `corruption_level`) only when a
    generator is given and the level is above 0."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    corruption_level: float = 0.3
    loss: Any = "mse"

    @property
    def is_pretrainable(self) -> bool:
        return True

    def infer_n_in(self, input_type: InputType) -> "AutoEncoder":
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.flat_size())
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"W": self._winit()(gen, (self.n_in, self.n_out), dtype),
                "b": torch.zeros((self.n_out,), dtype=dtype),
                "vb": torch.zeros((self.n_in,), dtype=dtype)}, {}

    def encode(self, params, x):
        return self._act(x @ params["W"] + params["b"])

    def decode(self, params, h):
        return self._act(h @ params["W"].T + params["vb"])

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        return self.encode(params, x), state

    def reconstruction_score(self, params, x, *, rng=None):
        corrupted = x
        if rng is not None and self.corruption_level > 0:
            keep = _keep_mask(rng, 1.0 - self.corruption_level, x.shape,
                              x.device)
            corrupted = torch.where(keep, x, torch.zeros_like(x))
        recon = self.decode(params, self.encode(params, corrupted))
        return LossFunction.get(self.loss)(x, recon, "identity")
