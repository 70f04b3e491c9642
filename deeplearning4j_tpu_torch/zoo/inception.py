"""Inception-family zoo models (port of `deeplearning4j_tpu/zoo/inception.py`):
GoogLeNet, InceptionResNetV1, FaceNetNN4Small2, with the same
configuration for the same arguments, the default updater included.

Reference parity: `zoo/model/{GoogLeNet,InceptionResNetV1,
FaceNetNN4Small2}.java`. GoogLeNet mirrors the 9-module Szegedy topology;
InceptionResNetV1 keeps the reference's stem/A/B/C residual-block structure
(block counts 5/10/5); FaceNetNN4Small2 is the inception-based embedding
net with an L2-normalized bottleneck and center-loss training head
(reference uses CenterLossOutputLayer the same way).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ElementWiseVertex, L2NormalizeVertex, MergeVertex, ScaleVertex,
)
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    DropoutLayer, GlobalPoolingLayer, OutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.special import CenterLossOutputLayer
from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel, register_zoo


def _conv(g, name, inp, n_out, kernel=(1, 1), stride=(1, 1), mode="same",
          act="relu", bn=True):
    g.add_layer(f"{name}_c",
                ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                 convolution_mode=mode, activation="identity",
                                 has_bias=not bn),
                inp)
    if bn:
        g.add_layer(f"{name}_bn", BatchNormalization(activation=act),
                    f"{name}_c")
        return f"{name}_bn"
    g.add_layer(f"{name}_a", ActivationLayer(activation=act), f"{name}_c")
    return f"{name}_a"


@register_zoo
class GoogLeNet(ZooModel):
    num_classes = 1000
    input_shape = (224, 224, 3)

    def _inception(self, g, name, inp, b1, b3r, b3, b5r, b5, pp):
        a = _conv(g, f"{name}_1x1", inp, b1)
        b = _conv(g, f"{name}_3x3r", inp, b3r)
        b = _conv(g, f"{name}_3x3", b, b3, (3, 3))
        c = _conv(g, f"{name}_5x5r", inp, b5r)
        c = _conv(g, f"{name}_5x5", c, b5, (5, 5))
        g.add_layer(f"{name}_pool",
                    SubsamplingLayer(pooling="max", kernel=(3, 3),
                                     stride=(1, 1), convolution_mode="same"),
                    inp)
        d = _conv(g, f"{name}_poolproj", f"{name}_pool", pp)
        g.add_vertex(f"{name}", MergeVertex(), a, b, c, d)
        return name

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.kw.get("updater", Nesterovs(1e-2, 0.9)))
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = _conv(g, "stem1", "input", 64, (7, 7), (2, 2))
        g.add_layer("pool1", SubsamplingLayer(pooling="max", kernel=(3, 3),
                                              stride=(2, 2),
                                              convolution_mode="same"), x)
        x = _conv(g, "stem2", "pool1", 64)
        x = _conv(g, "stem3", x, 192, (3, 3))
        g.add_layer("pool2", SubsamplingLayer(pooling="max", kernel=(3, 3),
                                              stride=(2, 2),
                                              convolution_mode="same"), x)
        x = self._inception(g, "i3a", "pool2", 64, 96, 128, 16, 32, 32)
        x = self._inception(g, "i3b", x, 128, 128, 192, 32, 96, 64)
        g.add_layer("pool3", SubsamplingLayer(pooling="max", kernel=(3, 3),
                                              stride=(2, 2),
                                              convolution_mode="same"), x)
        x = self._inception(g, "i4a", "pool3", 192, 96, 208, 16, 48, 64)
        x = self._inception(g, "i4b", x, 160, 112, 224, 24, 64, 64)
        x = self._inception(g, "i4c", x, 128, 128, 256, 24, 64, 64)
        x = self._inception(g, "i4d", x, 112, 144, 288, 32, 64, 64)
        x = self._inception(g, "i4e", x, 256, 160, 320, 32, 128, 128)
        g.add_layer("pool4", SubsamplingLayer(pooling="max", kernel=(3, 3),
                                              stride=(2, 2),
                                              convolution_mode="same"), x)
        x = self._inception(g, "i5a", "pool4", 256, 160, 320, 32, 128, 128)
        x = self._inception(g, "i5b", x, 384, 192, 384, 48, 128, 128)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling="avg"), x)
        g.add_layer("dropout", DropoutLayer(dropout=0.4), "avgpool")
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation="softmax"), "dropout")
        g.set_outputs("output")
        return g.build()


class _InceptionResNetBase(ZooModel):
    """Shared stem + residual A/B/C block machinery."""

    def _stem(self, g):
        x = _conv(g, "stem1", "input", 32, (3, 3), (2, 2), mode="truncate")
        x = _conv(g, "stem2", x, 32, (3, 3), mode="truncate")
        x = _conv(g, "stem3", x, 64, (3, 3))
        g.add_layer("stem_pool",
                    SubsamplingLayer(pooling="max", kernel=(3, 3),
                                     stride=(2, 2), convolution_mode="same"),
                    x)
        x = _conv(g, "stem4", "stem_pool", 80)
        x = _conv(g, "stem5", x, 192, (3, 3), mode="truncate")
        x = _conv(g, "stem6", x, 256, (3, 3), (2, 2))
        return x

    def _block_a(self, g, name, inp, scale=0.17):
        """Inception-ResNet-A (35×35) — residual scaling as in the
        reference (`ScaleVertex`)."""
        a = _conv(g, f"{name}_b1", inp, 32)
        b = _conv(g, f"{name}_b2a", inp, 32)
        b = _conv(g, f"{name}_b2b", b, 32, (3, 3))
        c = _conv(g, f"{name}_b3a", inp, 32)
        c = _conv(g, f"{name}_b3b", c, 32, (3, 3))
        c = _conv(g, f"{name}_b3c", c, 32, (3, 3))
        g.add_vertex(f"{name}_cat", MergeVertex(), a, b, c)
        lin = _conv(g, f"{name}_lin", f"{name}_cat", 256, act="identity",
                    bn=False)
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), lin)
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                     f"{name}_scale")
        g.add_layer(f"{name}", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return name

    def _reduction_a(self, g, name, inp):
        a = _conv(g, f"{name}_b1", inp, 384, (3, 3), (2, 2))
        b = _conv(g, f"{name}_b2a", inp, 192)
        b = _conv(g, f"{name}_b2b", b, 192, (3, 3))
        b = _conv(g, f"{name}_b2c", b, 256, (3, 3), (2, 2))
        g.add_layer(f"{name}_pool",
                    SubsamplingLayer(pooling="max", kernel=(3, 3),
                                     stride=(2, 2), convolution_mode="same"),
                    inp)
        g.add_vertex(name, MergeVertex(), a, b, f"{name}_pool")
        return name

    def _block_b(self, g, name, inp, channels, scale=0.10):
        a = _conv(g, f"{name}_b1", inp, 128)
        b = _conv(g, f"{name}_b2a", inp, 128)
        b = _conv(g, f"{name}_b2b", b, 128, (1, 7))
        b = _conv(g, f"{name}_b2c", b, 128, (7, 1))
        g.add_vertex(f"{name}_cat", MergeVertex(), a, b)
        lin = _conv(g, f"{name}_lin", f"{name}_cat", channels, act="identity",
                    bn=False)
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), lin)
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                     f"{name}_scale")
        g.add_layer(f"{name}", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return name


@register_zoo
class InceptionResNetV1(ZooModel):
    num_classes = 1000
    input_shape = (160, 160, 3)
    blocks_a = 5
    blocks_b = 10

    def conf(self):
        h, w, c = self.input_shape
        base = _InceptionResNetBase(num_classes=self.num_classes,
                                    input_shape=self.input_shape,
                                    seed=self.seed)
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.kw.get("updater", Adam(1e-3)))
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = base._stem(g)
        for i in range(self.blocks_a):
            x = base._block_a(g, f"a{i}", x)
        x = base._reduction_a(g, "reda", x)
        for i in range(self.blocks_b):
            x = base._block_b(g, f"b{i}", x, channels=896)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling="avg"), x)
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation="softmax"), "avgpool")
        g.set_outputs("output")
        return g.build()


@register_zoo
class FaceNetNN4Small2(ZooModel):
    """Embedding net: inception trunk → 128-d L2-normalized embedding →
    center-loss softmax head (reference: FaceNetNN4Small2.java +
    CenterLossOutputLayer)."""

    num_classes = 5749  # LFW identities, reference default ballpark
    input_shape = (96, 96, 3)
    embedding_size = 128

    def conf(self):
        h, w, c = self.input_shape
        base = _InceptionResNetBase(seed=self.seed)
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.kw.get("updater", Adam(1e-3)))
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = base._stem(g)
        for i in range(3):
            x = base._block_a(g, f"a{i}", x)
        x = base._reduction_a(g, "reda", x)
        for i in range(2):
            x = base._block_b(g, f"b{i}", x, channels=896)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling="avg"), x)
        g.add_layer("bottleneck",
                    DenseLayer(n_out=self.embedding_size,
                               activation="identity"),
                    "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("lossLayer",
                    CenterLossOutputLayer(n_out=self.num_classes,
                                          activation="softmax",
                                          alpha=0.9, lambda_=1e-4),
                    "embeddings")
        g.set_outputs("lossLayer")
        return g.build()
