"""Recurrent zoo models (port of `deeplearning4j_tpu/zoo/models.py`; so
far `TextGenerationLSTM` only), with the same configuration for the same
arguments, the default updater included."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.optim.updaters import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel, register_zoo


@register_zoo
class TextGenerationLSTM(ZooModel):
    """Reference: `zoo/model/TextGenerationLSTM.java` — 2×LSTM(256) +
    per-timestep softmax for character-level generation, trained by
    truncated BPTT over chunks of 50."""

    num_classes = 77          # totalUniqueCharacters in the reference
    input_shape = (40, 77)    # (timesteps, vocab)

    def conf(self):
        t, vocab = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.kw.get("updater", Adam(1e-3)))
                .activation("tanh")
                .list(
                    LSTM(n_out=256),
                    LSTM(n_out=256),
                    RnnOutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.recurrent(vocab, t))
                .tbptt(50)
                .build())
