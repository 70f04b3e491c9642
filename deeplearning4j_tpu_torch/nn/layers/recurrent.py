"""Recurrent-family layers ported so far: only `RnnOutputLayer`, the
per-timestep head of the transformer zoo models (port of
`deeplearning4j_tpu/nn/layers/recurrent.py`; the LSTM family comes in a
later slice). Its `pre_output` and `score` are OutputLayer's: `x @ W`
batches over the leading [B, T] axes, and the loss masks per timestep."""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import register_layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(OutputLayer):
    """Per-timestep dense + activation over [B, T, n_in]."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def infer_n_in(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.size)
        return self
