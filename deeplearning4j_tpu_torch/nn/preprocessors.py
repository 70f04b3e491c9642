"""Input preprocessors — shape adapters between layer families (port of
`deeplearning4j_tpu/nn/preprocessors.py`, same serde names and fields).

A `LayerVertex` of a computation graph may carry one (`nn/graph.py`),
and the sequential builder inserts one at each change of layer family
(`auto_preprocessor`, called from `nn/config.py`) or keeps one given by
`input_preprocessor`; each is a pure reshape or slice of the NHWC /
[batch, time, features] activations the JAX package uses."""

from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.utils.serde import register_serde


@dataclasses.dataclass(frozen=True)
class Preprocessor:
    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def apply(self, x, mask=None):
        raise NotImplementedError


@register_serde
@dataclasses.dataclass(frozen=True)
class CnnToFeedForward(Preprocessor):
    """NHWC -> flat."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.flat_size())

    def apply(self, x, mask=None):
        return x.reshape(x.shape[0], -1)


@register_serde
@dataclasses.dataclass(frozen=True)
class FeedForwardToCnn(Preprocessor):
    """Flat -> NHWC."""
    height: int = 0
    width: int = 0
    channels: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)

    def apply(self, x, mask=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)


@register_serde
@dataclasses.dataclass(frozen=True)
class FeedForwardToRnn(Preprocessor):
    """[B, F] -> [B, 1, F]."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.flat_size(), 1)

    def apply(self, x, mask=None):
        return x[:, None, :]


@register_serde
@dataclasses.dataclass(frozen=True)
class RnnToFeedForward(Preprocessor):
    """[B, T, F] -> [B, F], the last timestep."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.size)

    def apply(self, x, mask=None):
        return x[:, -1, :]


@register_serde
@dataclasses.dataclass(frozen=True)
class RnnToCnn(Preprocessor):
    """[B, T, h·w·c] -> [B·T, h, w, c]: time folded into the batch."""
    height: int = 0
    width: int = 0
    channels: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)

    def apply(self, x, mask=None):
        b, t, _ = x.shape
        return x.reshape(b * t, self.height, self.width, self.channels)


@register_serde
@dataclasses.dataclass(frozen=True)
class CnnToRnn(Preprocessor):
    """NHWC -> [B, 1, h·w·c]."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.flat_size(), 1)

    def apply(self, x, mask=None):
        return x.reshape(x.shape[0], 1, -1)



def auto_preprocessor(from_type: InputType,
                      to_kind: str) -> Optional[Preprocessor]:
    """The adapter for an InputType transition into a layer that consumes
    `to_kind` ("ff", "cnn" or "rnn"), or None, as the JAX builder picks
    it (the reference's `getPreProcessorForInputType`)."""
    f = from_type.kind
    if f == to_kind or (f == "cnn_flat" and to_kind == "ff"):
        return None
    if f == "cnn" and to_kind == "ff":
        return CnnToFeedForward(from_type.height, from_type.width,
                                from_type.channels)
    if f in ("ff", "cnn_flat") and to_kind == "cnn":
        if f == "cnn_flat":
            return FeedForwardToCnn(from_type.height, from_type.width,
                                    from_type.channels)
        raise ValueError(
            "Cannot infer CNN shape from a plain feed-forward input; use "
            "InputType.convolutional_flat(h, w, c)")
    if f == "ff" and to_kind == "rnn":
        return FeedForwardToRnn()
    if f == "rnn" and to_kind == "ff":
        return RnnToFeedForward()
    if f == "cnn" and to_kind == "rnn":
        return CnnToRnn()
    return None
