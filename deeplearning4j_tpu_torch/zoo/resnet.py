"""ResNet-50 as a ComputationGraph (port of `deeplearning4j_tpu/zoo/resnet.py`),
with the same configuration for the same arguments, the default updater
included.

Stem 7×7/2 + 3×3/2 max pool (or `stem="s2d"`: space-to-depth and a 4×4
stride-1 conv, the same function through `fold_stem_kernel`), four
stages [3, 4, 6, 3] of bottleneck blocks, global average pool, softmax
head, NHWC. With `fused=True` every fusable conv + BN pair becomes one
`FusedConvBNLayer`: per block two 1×1s and the 3×3 middle, plus the
four projection shortcuts — 36 launches of kernel B7a and 16 of B7b a
train step; the stem stays a plain convolution and batch norm.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.models.fusion import fusable_conv_shape
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, FusedConvBNLayer,
    GlobalPoolingLayer, OutputLayer, SpaceToDepthLayer, SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel, register_zoo


def fold_stem_kernel(w, block: int = 2, pad: int = 3):
    """Fold a stride-`block` stem kernel [K, K, C, O] (HWIO) into the
    kernel of the identical stride-1 conv over the space-to-depth input:
    conv(x, w, stride=2, pad=3) == conv(s2d(x), fold(w), stride=1,
    explicit pad (2, 1)). Index i - pad = block·a + d splits every tap
    into a folded tap `a` and an input-channel slot `d`. Returns (kernel,
    (pad_before, pad_after)); numpy in and out."""
    w = np.asarray(w)
    K, _, C, O = w.shape
    s = block
    taps = []
    for i in range(K):
        d = (i - pad) % s
        taps.append(((i - pad - d) // s, d))
    amin = min(a for a, _ in taps)
    amax = max(a for a, _ in taps)
    Ka = amax - amin + 1
    out = np.zeros((Ka, Ka, s * s * C, O), w.dtype)
    for i, (ai, dy) in enumerate(taps):
        for j, (aj, dx) in enumerate(taps):
            out[ai - amin, aj - amin,
                (dy * s + dx) * C:(dy * s + dx) * C + C] = w[i, j]
    return out, (-amin, Ka - 1 + amin)


@register_zoo
class ResNet50(ZooModel):
    num_classes = 1000
    input_shape = (224, 224, 3)

    def _conv_bn(self, g, name, inp, n_out, kernel, stride=(1, 1),
                 pad=(0, 0), act="relu", mode="truncate"):
        if self.kw.get("fused") and fusable_conv_shape(kernel, stride, pad,
                                                       mode):
            g.add_layer(f"{name}_convbn",
                        FusedConvBNLayer(n_out=n_out, kernel=kernel,
                                         stride=stride, activation=act),
                        inp)
            return f"{name}_convbn"
        g.add_layer(f"{name}_conv",
                    ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                     padding=pad, convolution_mode=mode,
                                     activation="identity", has_bias=False),
                    inp)
        g.add_layer(f"{name}_bn", BatchNormalization(activation=act),
                    f"{name}_conv")
        return f"{name}_bn"

    def _conv_block(self, g, name, inp, filters, stride):
        """Bottleneck block with a projection shortcut."""
        f1, f2, f3 = filters
        x = self._conv_bn(g, f"{name}_a", inp, f1, (1, 1), stride)
        x = self._conv_bn(g, f"{name}_b", x, f2, (3, 3), (1, 1), mode="same")
        x = self._conv_bn(g, f"{name}_c", x, f3, (1, 1), act="identity")
        sc = self._conv_bn(g, f"{name}_sc", inp, f3, (1, 1), stride,
                           act="identity")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
        g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"

    def _identity_block(self, g, name, inp, filters):
        """Bottleneck block with an identity shortcut."""
        f1, f2, f3 = filters
        x = self._conv_bn(g, f"{name}_a", inp, f1, (1, 1))
        x = self._conv_bn(g, f"{name}_b", x, f2, (3, 3), (1, 1), mode="same")
        x = self._conv_bn(g, f"{name}_c", x, f3, (1, 1), act="identity")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, inp)
        g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.kw.get("updater", Nesterovs(1e-1, 0.9)))
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        if self.kw.get("stem") == "s2d":
            g.add_layer("s2d", SpaceToDepthLayer(block=2), "input")
            g.add_layer("pad0", ZeroPaddingLayer(pad=((2, 1), (2, 1))), "s2d")
            x = self._conv_bn(g, "stem", "pad0", 64, (4, 4), (1, 1))
        else:
            g.add_layer("pad0", ZeroPaddingLayer(pad=(3, 3)), "input")
            x = self._conv_bn(g, "stem", "pad0", 64, (7, 7), (2, 2))
        g.add_layer("pool0",
                    SubsamplingLayer(pooling="max", kernel=(3, 3),
                                     stride=(2, 2), convolution_mode="same"),
                    x)
        x = "pool0"
        stages = [
            ("res2", (64, 64, 256), 3, (1, 1)),
            ("res3", (128, 128, 512), 4, (2, 2)),
            ("res4", (256, 256, 1024), 6, (2, 2)),
            ("res5", (512, 512, 2048), 3, (2, 2)),
        ]
        for sname, filters, blocks, stride in stages:
            x = self._conv_block(g, f"{sname}a", x, filters, stride)
            for b in range(1, blocks):
                x = self._identity_block(g, f"{sname}{chr(97 + b)}", x,
                                         filters)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling="avg"), x)
        g.add_layer("output",
                    OutputLayer(n_out=self.num_classes, activation="softmax",
                                loss="mcxent"),
                    "avgpool")
        g.set_outputs("output")
        return g.build()
