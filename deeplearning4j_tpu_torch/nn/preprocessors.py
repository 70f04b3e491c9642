"""Input preprocessors — shape adapters between layer families (port of
`deeplearning4j_tpu/nn/preprocessors.py`, same serde names and fields).

A `LayerVertex` of a computation graph may carry one (`nn/graph.py`);
each is a pure reshape or slice of the NHWC / [batch, time, features]
activations the JAX package uses. Auto-insertion in the sequential
builder is not ported (`nn/config.py` refuses such configs)."""

from __future__ import annotations

import dataclasses

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

