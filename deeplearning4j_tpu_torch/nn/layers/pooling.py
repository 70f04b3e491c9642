"""Global pooling (port of `deeplearning4j_tpu/nn/layers/pooling.py`):
max | avg | sum | pnorm over time ([B, T, F]) or space (NHWC), with the
per-timestep mask honoured on 3-D input."""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


class PoolingType:
    """Reference: `PoolingType` (the pooling names the layers take)."""

    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


@register_layer
@dataclasses.dataclass(frozen=True)
class GlobalPoolingLayer(Layer):
    pooling: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "cnn":
            return InputType.feed_forward(input_type.channels)
        return input_type

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        if x.ndim == 3:      # [B, T, F]: pool over time
            axes = (1,)
        elif x.ndim == 4:    # NHWC: pool over H, W
            axes = (1, 2)
        else:
            raise ValueError(f"GlobalPooling expects 3-D or 4-D input, got "
                             f"{tuple(x.shape)}")
        p = self.pooling.lower()
        if p not in ("max", "sum", "avg", "pnorm"):
            raise ValueError(f"Unknown pooling {self.pooling!r}")
        if mask is not None and x.ndim == 3:
            m = mask.to(x.dtype)[..., None]          # [B, T, 1]
            if p == "max":
                return torch.where(m > 0, x, float("-inf")).amax(axes), state
            if p == "sum":
                return (x * m).sum(axes), state
            if p == "avg":
                return (x * m).sum(axes) / torch.clamp(m.sum(axes),
                                                       min=1.0), state
            return ((x * m).abs() ** self.pnorm).sum(axes) ** (
                1.0 / self.pnorm), state
        if p == "max":
            return x.amax(axes), state
        if p == "sum":
            return x.sum(axes), state
        if p == "avg":
            return x.mean(axes), state
        return (x.abs() ** self.pnorm).sum(axes) ** (1.0 / self.pnorm), state
