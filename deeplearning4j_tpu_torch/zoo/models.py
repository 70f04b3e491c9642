"""Sequential zoo models (port of `deeplearning4j_tpu/zoo/models.py`):
LeNet, AlexNet, SimpleCNN, VGG16/19 and TextGenerationLSTM, with the
same configuration for the same arguments, the default updater
included."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM, BatchNormalization, ConvolutionLayer, DenseLayer,
    LocalResponseNormalization, OutputLayer, RnnOutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel, register_zoo


@register_zoo
class LeNet(ZooModel):
    """Reference: `zoo/model/LeNet.java` (conv5x5x20 → pool → conv5x5x50 →
    pool → dense500 → softmax) — BASELINE config #1."""

    num_classes = 10
    input_shape = (28, 28, 1)

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.kw.get("updater", Adam(1e-3)))
                .weight_init("xavier")
                .activation("identity")
                .list(
                    ConvolutionLayer(n_out=20, kernel=(5, 5), stride=(1, 1),
                                     activation="identity"),
                    SubsamplingLayer(pooling="max", kernel=(2, 2),
                                     stride=(2, 2)),
                    ConvolutionLayer(n_out=50, kernel=(5, 5), stride=(1, 1),
                                     activation="identity"),
                    SubsamplingLayer(pooling="max", kernel=(2, 2),
                                     stride=(2, 2)),
                    DenseLayer(n_out=500, activation="relu"),
                    OutputLayer(n_out=self.num_classes, activation="softmax",
                                loss="mcxent"))
                .set_input_type(InputType.convolutional_flat(h, w, c))
                .build())


@register_zoo
class AlexNet(ZooModel):
    """Reference: `zoo/model/AlexNet.java` (5 conv + LRN + 3 dense)."""

    num_classes = 1000
    input_shape = (224, 224, 3)

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.kw.get("updater", Nesterovs(1e-2, 0.9)))
                .weight_init("normal")
                .activation("relu")
                .list(
                    ConvolutionLayer(n_out=96, kernel=(11, 11), stride=(4, 4)),
                    LocalResponseNormalization(),
                    SubsamplingLayer(pooling="max", kernel=(3, 3),
                                     stride=(2, 2)),
                    ConvolutionLayer(n_out=256, kernel=(5, 5), stride=(1, 1),
                                     padding=(2, 2)),
                    LocalResponseNormalization(),
                    SubsamplingLayer(pooling="max", kernel=(3, 3),
                                     stride=(2, 2)),
                    ConvolutionLayer(n_out=384, kernel=(3, 3), padding=(1, 1)),
                    ConvolutionLayer(n_out=384, kernel=(3, 3), padding=(1, 1)),
                    ConvolutionLayer(n_out=256, kernel=(3, 3), padding=(1, 1)),
                    SubsamplingLayer(pooling="max", kernel=(3, 3),
                                     stride=(2, 2)),
                    DenseLayer(n_out=4096, dropout=0.5),
                    DenseLayer(n_out=4096, dropout=0.5),
                    OutputLayer(n_out=self.num_classes, activation="softmax",
                                loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


@register_zoo
class SimpleCNN(ZooModel):
    """Reference: `zoo/model/SimpleCNN.java`."""

    num_classes = 10
    input_shape = (48, 48, 3)

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.kw.get("updater", Adam(1e-3)))
                .activation("relu")
                .list(
                    ConvolutionLayer(n_out=16, kernel=(3, 3), padding=(1, 1)),
                    BatchNormalization(),
                    ConvolutionLayer(n_out=16, kernel=(3, 3), padding=(1, 1)),
                    BatchNormalization(),
                    SubsamplingLayer(pooling="max", kernel=(2, 2),
                                     stride=(2, 2)),
                    ConvolutionLayer(n_out=32, kernel=(3, 3), padding=(1, 1)),
                    BatchNormalization(),
                    ConvolutionLayer(n_out=32, kernel=(3, 3), padding=(1, 1)),
                    BatchNormalization(),
                    SubsamplingLayer(pooling="max", kernel=(2, 2),
                                     stride=(2, 2)),
                    DenseLayer(n_out=256, dropout=0.5),
                    OutputLayer(n_out=self.num_classes, activation="softmax"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class _VGG(ZooModel):
    blocks = ()

    def conf(self):
        h, w, c = self.input_shape
        layers = []
        for widths in self.blocks:
            for n in widths:
                layers.append(ConvolutionLayer(
                    n_out=n, kernel=(3, 3), padding=(1, 1), activation="relu"))
            layers.append(SubsamplingLayer(
                pooling="max", kernel=(2, 2), stride=(2, 2)))
        layers += [
            DenseLayer(n_out=4096, activation="relu", dropout=0.5),
            DenseLayer(n_out=4096, activation="relu", dropout=0.5),
            OutputLayer(n_out=self.num_classes, activation="softmax"),
        ]
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.kw.get("updater", Nesterovs(1e-2, 0.9)))
                .weight_init("xavier")
                .list(*layers)
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


@register_zoo
class VGG16(_VGG):
    """Reference: `zoo/model/VGG16.java` — BASELINE config #2."""

    num_classes = 1000
    input_shape = (224, 224, 3)
    blocks = ((64, 64), (128, 128), (256, 256, 256),
              (512, 512, 512), (512, 512, 512))


@register_zoo
class VGG19(_VGG):
    """Reference: `zoo/model/VGG19.java`."""

    num_classes = 1000
    input_shape = (224, 224, 3)
    blocks = ((64, 64), (128, 128), (256, 256, 256, 256),
              (512, 512, 512, 512), (512, 512, 512, 512))


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
