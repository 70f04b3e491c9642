"""Convolution, pooling and padding layers (port of
`deeplearning4j_tpu/nn/layers/convolution.py`): `ConvolutionLayer`,
`Deconvolution2DLayer`, `DepthwiseConvolution2DLayer`,
`SeparableConvolution2DLayer`, `SubsamplingLayer`, `ZeroPaddingLayer`,
`Cropping2DLayer`, `Upsampling2DLayer`, `SpaceToDepthLayer`,
`Convolution1DLayer`, `Subsampling1DLayer` and the fused
`FusedConvBNLayer`.

Layouts are the JAX package's: activations NHWC, kernels HWIO, so its
params load unchanged. `F.conv2d` and the pooling functions take NCHW
and OIHW, so the layers hand them permuted views (channels-last
strides, which cuDNN reads as they are) and permute the result back.

Padding follows XLA, not PyTorch: "same" mode pads `total = max((out-1)
·s + (k-1)·d + 1 - in, 0)` with `total // 2` BEFORE and the rest after,
so an even total is symmetric and an odd one puts the extra row and
column at the end (3×3 stride-2 pooling over 112×112: 0 before, 1
after). PyTorch's `padding=1` would pad both sides and shift every
window. The layers compute XLA's pads and apply them with `F.pad`
(-inf for max pooling, 0 otherwise); average pooling divides by the
count of real elements, as `lax.reduce_window` over a ones map does.
The 1-D layers work on [batch, time, features] (NWC, kernels WIO) with
the same rules along time.

`Deconvolution2DLayer` keeps the JAX parametrisation (W [kh, kw, n_in,
n_out], the zero-dilated input correlated with W unflipped) but pads
truncate mode by k−1−p a side, so that its output has the size its
`output_type` states, s·(h−1)+k−2p, as DL4J's and Keras's do. The JAX
layer pads (p, p) and agrees with its own `output_type` only at p =
(k−1)/2 and in "same" mode (C15, reference-side).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _out_size(size: int, k: int, s: int, p: int, mode: str) -> int:
    if mode == "same":
        return -(-size // s)  # ceil
    if mode == "strict":
        if (size + 2 * p - k) % s != 0:
            raise ValueError(
                f"ConvolutionMode=strict: (size {size} + 2*pad {p} - kernel "
                f"{k}) not divisible by stride {s} (reference: "
                f"ConvolutionMode.Strict)")
        return (size + 2 * p - k) // s + 1
    # truncate (the reference's default tolerates a remainder)
    return (size + 2 * p - k) // s + 1


def _same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _padding_2d(mode: str, kernel, stride, pad, x_hw,
                dilation=(1, 1)) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) of a 2-D window op: XLA's SAME pads
    for the input size `x_hw` in "same" mode, else the explicit `pad`
    on both sides."""
    if mode == "same":
        (kh, kw), (sh, sw), (dh, dw) = (_pair(kernel), _pair(stride),
                                        _pair(dilation))
        return (_same_pads(x_hw[0], kh, sh, dh), _same_pads(x_hw[1], kw, sw,
                                                            dw))
    ph, pw = _pair(pad)
    return (ph, ph), (pw, pw)


def _pad_nhwc(x, pads, value: float = 0.0):
    (pt, pb), (pl, pr) = pads
    if not (pt or pb or pl or pr):
        return x
    return F.pad(x, (0, 0, pl, pr, pt, pb), value=value)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv_out_type(layer, input_type: InputType, channels: int) -> InputType:
    kh, kw = _pair(layer.kernel)
    sh, sw = _pair(layer.stride)
    ph, pw = _pair(layer.padding)
    m = layer.convolution_mode
    return InputType.convolutional(_out_size(input_type.height, kh, sh, ph, m),
                                   _out_size(input_type.width, kw, sw, pw, m),
                                   channels)


def _conv2d(x, w_hwio, layer, groups: int = 1):
    """NHWC `x` through an HWIO kernel with XLA's padding for `layer`'s
    kernel, stride, padding, mode (and dilation, where it has one);
    `groups` is `lax`'s `feature_group_count`: output channel j reads
    input group j // (n_out / groups) in both."""
    dilation = getattr(layer, "dilation", (1, 1))
    pads = _padding_2d(layer.convolution_mode, layer.kernel, layer.stride,
                       layer.padding, x.shape[1:3], dilation)
    return _nhwc(F.conv2d(_nchw(_pad_nhwc(x, pads)),
                          w_hwio.permute(3, 2, 0, 1),
                          stride=_pair(layer.stride),
                          dilation=_pair(dilation), groups=groups))


@register_layer
@dataclasses.dataclass(frozen=True)
class ConvolutionLayer(Layer):
    """2-D convolution, `F.conv2d` (cuDNN on the card) over NHWC input
    with an HWIO kernel."""

    n_in: Optional[int] = None       # input channels
    n_out: Optional[int] = None      # output channels
    kernel: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = (0, 0)
    dilation: Any = (1, 1)
    convolution_mode: str = "truncate"   # strict | truncate | same
    has_bias: bool = True

    def infer_n_in(self, input_type: InputType) -> "ConvolutionLayer":
        if self.n_in is None and input_type.kind in ("cnn", "cnn_flat"):
            return dataclasses.replace(self, n_in=input_type.channels)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return _conv_out_type(self, input_type, self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel)
        params = {"W": self._winit()(gen, (kh, kw, self.n_in, self.n_out),
                                     dtype)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init or 0.0,
                                     dtype=dtype)
        return params, {}

    def pre_output(self, params, x):
        y = _conv2d(x, params["W"], self)
        if self.has_bias:
            y = y + params["b"]
        return y

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        x = self._maybe_dropout(x, train, rng)
        return self._act(self.pre_output(params, x)), state


def _transpose_pads(mode: str, k: int, s: int, p: int) -> Tuple[int, int]:
    """Pads of the zero-dilated input along one axis of a transposed
    convolution: `lax.conv_transpose`'s SAME pads in "same" mode (output
    s·h), else k−1−p a side (output s·(h−1)+k−2p, `output_type`'s)."""
    if mode == "same":
        pad_len = k + s - 2
        before = k - 1 if s > k - 1 else -(-pad_len // 2)
        return before, pad_len - before
    return k - 1 - p, k - 1 - p


@register_layer
@dataclasses.dataclass(frozen=True)
class Deconvolution2DLayer(ConvolutionLayer):
    """Transposed 2-D convolution over NHWC input, W [kh, kw, n_in,
    n_out]: the input dilated by the stride, padded (`_transpose_pads`)
    and correlated with W unflipped. `F.conv_transpose2d` (cuDNN on the
    card) computes that with W flipped and its channel axes swapped; its
    full output is then cut (or zero-extended) to the pads, by `F.pad`."""

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        if self.convolution_mode == "same":
            h, w = input_type.height * sh, input_type.width * sw
        else:
            h = sh * (input_type.height - 1) + kh - 2 * ph
            w = sw * (input_type.width - 1) + kw - 2 * pw
        return InputType.convolutional(h, w, self.n_out)

    def pre_output(self, params, x):
        (kh, kw), (sh, sw), (ph, pw) = (_pair(self.kernel),
                                        _pair(self.stride),
                                        _pair(self.padding))
        wt = params["W"].flip(0, 1).permute(2, 3, 0, 1)   # [in, out, kh, kw]
        full = F.conv_transpose2d(_nchw(x), wt, stride=(sh, sw))
        (ta, tb) = _transpose_pads(self.convolution_mode, kh, sh, ph)
        (la, lb) = _transpose_pads(self.convolution_mode, kw, sw, pw)
        y = _nhwc(F.pad(full, (la - (kw - 1), lb - (kw - 1),
                               ta - (kh - 1), tb - (kh - 1))))
        if self.has_bias:
            y = y + params["b"]
        return y


@register_layer
@dataclasses.dataclass(frozen=True)
class DepthwiseConvolution2DLayer(Layer):
    """Depthwise convolution: W [kh, kw, 1, n_in·depth_multiplier], one
    group a input channel (`groups=n_in`); output channel j reads input
    channel j // depth_multiplier."""

    n_in: Optional[int] = None
    depth_multiplier: int = 1
    kernel: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = (0, 0)
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def infer_n_in(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.channels)
        return self

    @property
    def n_out(self):
        return self.n_in * self.depth_multiplier

    def output_type(self, input_type: InputType) -> InputType:
        return _conv_out_type(self, input_type, self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel)
        params = {"W": self._winit()(gen, (kh, kw, 1, self.n_out), dtype)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype)
        return params, {}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        y = _conv2d(x, params["W"], self, groups=self.n_in)
        if self.has_bias:
            y = y + params["b"]
        return self._act(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class SeparableConvolution2DLayer(Layer):
    """Depthwise-separable convolution: the depthwise `dW` [kh, kw, 1,
    n_in·depth_multiplier], then the pointwise `pW` [1, 1, mid, n_out],
    then one bias."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    depth_multiplier: int = 1
    kernel: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = (0, 0)
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def infer_n_in(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.channels)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return _conv_out_type(self, input_type, self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel)
        mid = self.n_in * self.depth_multiplier
        params = {"dW": self._winit()(gen, (kh, kw, 1, mid), dtype),
                  "pW": self._winit()(gen, (1, 1, mid, self.n_out), dtype)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype)
        return params, {}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        y = _conv2d(x, params["dW"], self, groups=self.n_in)
        y = _nhwc(F.conv2d(_nchw(y), params["pW"].permute(3, 2, 0, 1)))
        if self.has_bias:
            y = y + params["b"]
        return self._act(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class SubsamplingLayer(Layer):
    """Spatial pooling (max | avg | sum | pnorm) over NHWC input, with
    XLA's padding (module docstring)."""

    pooling: str = "max"
    kernel: Any = (2, 2)
    stride: Any = (2, 2)
    padding: Any = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        return _conv_out_type(self, input_type, input_type.channels)

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        k, s = _pair(self.kernel), _pair(self.stride)
        pads = _padding_2d(self.convolution_mode, k, s, self.padding,
                           x.shape[1:3])

        def window_sum(v):
            return F.avg_pool2d(_nchw(_pad_nhwc(v, pads)), k, s,
                                divisor_override=1)

        p = self.pooling.lower()
        if p == "max":
            y = F.max_pool2d(_nchw(_pad_nhwc(x, pads, float("-inf"))), k, s)
        elif p == "sum":
            y = window_sum(x)
        elif p == "avg":
            cnt = window_sum(torch.ones_like(x[:1, :, :, :1]))
            y = window_sum(x) / cnt
        elif p == "pnorm":
            y = window_sum(x.abs() ** self.pnorm) ** (1.0 / self.pnorm)
        else:
            raise ValueError(f"Unknown pooling {self.pooling!r}")
        return _nhwc(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class ZeroPaddingLayer(Layer):
    """Zero padding of the spatial axes: `pad` (ph, pw) or ((top,
    bottom), (left, right))."""

    pad: Any = (1, 1)

    def _pads(self):
        p = self.pad
        if isinstance(p, (tuple, list)) and len(p) == 2 and \
                isinstance(p[0], (tuple, list)):
            return tuple(p[0]), tuple(p[1])
        ph, pw = _pair(p)
        return (ph, ph), (pw, pw)

    def output_type(self, input_type: InputType) -> InputType:
        (pt, pb), (pl, pr) = self._pads()
        return InputType.convolutional(input_type.height + pt + pb,
                                       input_type.width + pl + pr,
                                       input_type.channels)

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        return _pad_nhwc(x, self._pads()), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Cropping2DLayer(Layer):
    """Cropping of the spatial axes: `crop` (ch, cw) or ((top, bottom),
    (left, right))."""

    crop: Any = (0, 0)

    def _crops(self):
        c = self.crop
        if isinstance(c, (tuple, list)) and len(c) == 2 and \
                isinstance(c[0], (tuple, list)):
            return tuple(c[0]), tuple(c[1])
        ch, cw = _pair(c)
        return (ch, ch), (cw, cw)

    def output_type(self, input_type: InputType) -> InputType:
        (ct, cb), (cl, cr) = self._crops()
        return InputType.convolutional(input_type.height - ct - cb,
                                       input_type.width - cl - cr,
                                       input_type.channels)

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        (ct, cb), (cl, cr) = self._crops()
        h, w = x.shape[1], x.shape[2]
        return x[:, ct:h - cb, cl:w - cr, :], state


@register_layer
@dataclasses.dataclass(frozen=True)
class Upsampling2DLayer(Layer):
    """Nearest-neighbour upsampling: every pixel repeated `size` (sh, sw)
    times along height and width."""

    size: Any = (2, 2)

    def output_type(self, input_type: InputType) -> InputType:
        sh, sw = _pair(self.size)
        return InputType.convolutional(input_type.height * sh,
                                       input_type.width * sw,
                                       input_type.channels)

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        sh, sw = _pair(self.size)
        B, H, W, C = x.shape
        y = x[:, :, None, :, None, :].expand(B, H, sh, W, sw, C)
        return y.reshape(B, H * sh, W * sw, C), state


@register_layer
@dataclasses.dataclass(frozen=True)
class SpaceToDepthLayer(Layer):
    """Fold `block`×`block` spatial tiles into channels: [B, H, W, C] ->
    [B, H/b, W/b, b·b·C], channel order (dy, dx, c) — the stem transform
    of `zoo/resnet.py` (`fold_stem_kernel`)."""

    block: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        b = self.block
        if input_type.height % b or input_type.width % b:
            raise ValueError(
                f"SpaceToDepth block {b} must divide spatial dims "
                f"({input_type.height}x{input_type.width})")
        return InputType.convolutional(input_type.height // b,
                                       input_type.width // b,
                                       input_type.channels * b * b)

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        b = self.block
        B, H, W, C = x.shape
        y = x.reshape(B, H // b, b, W // b, b, C).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(B, H // b, W // b, b * b * C), state


def _time_pads(mode: str, t: int, k: int, s: int, p: int
               ) -> Tuple[int, int]:
    """Pads of a 1-D window op along time: XLA's SAME (the odd pad at the
    end) in "same" mode, else p a side."""
    return _same_pads(t, k, s) if mode == "same" else (p, p)


@register_layer
@dataclasses.dataclass(frozen=True)
class Convolution1DLayer(Layer):
    """1-D (temporal) convolution over [batch, time, features], W [k,
    n_in, n_out] (WIO), `F.conv1d` over the permuted view."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    kernel: int = 3
    stride: int = 1
    padding: int = 0
    convolution_mode: str = "same"
    has_bias: bool = True

    def infer_n_in(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.size)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        if t is not None:
            t = _out_size(t, self.kernel, self.stride, self.padding,
                          self.convolution_mode)
        return InputType.recurrent(self.n_out, t)

    def init_params(self, gen, input_type, dtype=torch.float32):
        params = {"W": self._winit()(gen, (self.kernel, self.n_in,
                                           self.n_out), dtype)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype)
        return params, {}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        pa, pb = _time_pads(self.convolution_mode, x.shape[1], self.kernel,
                            self.stride, self.padding)
        y = F.conv1d(F.pad(x, (0, 0, pa, pb)).permute(0, 2, 1),
                     params["W"].permute(2, 1, 0), stride=self.stride)
        y = y.permute(0, 2, 1)
        if self.has_bias:
            y = y + params["b"]
        return self._act(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Subsampling1DLayer(Layer):
    """1-D pooling over [batch, time, features]: "max" pads with −inf,
    any other pooling averages over the real elements of each window."""

    pooling: str = "max"
    kernel: int = 2
    stride: int = 2
    padding: int = 0
    convolution_mode: str = "truncate"

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        if t is not None:
            t = _out_size(t, self.kernel, self.stride, self.padding,
                          self.convolution_mode)
        return InputType.recurrent(input_type.size, t)

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        pa, pb = _time_pads(self.convolution_mode, x.shape[1], self.kernel,
                            self.stride, self.padding)
        k, s = self.kernel, self.stride
        if self.pooling == "max":
            xp = F.pad(x, (0, 0, pa, pb), value=float("-inf"))
            y = F.max_pool1d(xp.permute(0, 2, 1), k, s)
        else:
            def window_sum(v):
                v = F.pad(v, (0, 0, pa, pb)).permute(0, 2, 1).unsqueeze(2)
                return F.avg_pool2d(v, (1, k), (1, s),
                                    divisor_override=1).squeeze(2)

            y = window_sum(x) / window_sum(torch.ones_like(x[:1, :, :1]))
        return y.permute(0, 2, 1), state


@register_layer
@dataclasses.dataclass(frozen=True)
class FusedConvBNLayer(Layer):
    """Conv + batch norm + activation as one fused op: the batch
    statistics come out of the convolution kernel itself (kernels B7a for
    a 1×1 of any stride, B7b for a 3×3 stride-1 SAME;
    `ops/conv_fused.py`). Parameters W [kh, kw, n_in, n_out] (HWIO),
    gamma and beta; state: the float32 running mean and var. Equivalent
    to ConvolutionLayer(kernel, has_bias=False, activation=identity)
    followed by BatchNormalization(activation=...)."""

    CONSUMES = "cnn"

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    kernel: Any = (1, 1)
    stride: Any = (1, 1)
    decay: float = 0.9
    eps: float = 1e-5

    def __post_init__(self):
        k = _pair(self.kernel)
        if k not in ((1, 1), (3, 3)):
            raise ValueError(f"FusedConvBNLayer supports kernels (1,1) "
                             f"and (3,3), got {k}")
        if k == (3, 3) and _pair(self.stride) != (1, 1):
            raise ValueError("the fused 3x3 path is stride-1 SAME only")

    def infer_n_in(self, input_type: InputType) -> "FusedConvBNLayer":
        if self.n_in is None and input_type.kind in ("cnn", "cnn_flat"):
            return dataclasses.replace(self, n_in=input_type.channels)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        # (1,1): the stride subsamples the input, out = ceil(in / s);
        # (3,3): stride-1 SAME, spatial dims unchanged
        sh, sw = _pair(self.stride)
        return InputType.convolutional(-(-input_type.height // sh),
                                       -(-input_type.width // sw),
                                       self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel)
        params = {
            "W": self._winit()(gen, (kh, kw, self.n_in, self.n_out), dtype),
            "gamma": torch.ones((self.n_out,), dtype=dtype),
            "beta": torch.zeros((self.n_out,), dtype=dtype),
        }
        state = {"mean": torch.zeros((self.n_out,), dtype=torch.float32),
                 "var": torch.ones((self.n_out,), dtype=torch.float32)}
        return params, state

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        from deeplearning4j_tpu_torch.ops.conv_fused import (
            conv1x1_bn_act, conv3x3_bn_act,
        )
        from deeplearning4j_tpu_torch.ops.kernel_defaults import (
            conv_fused_policy,
        )

        conv_fused_policy(x.dtype, train=train, device=x.device)
        x = self._maybe_dropout(x, train, rng)
        act = self.activation or "identity"
        relu = act == "relu"
        is3x3 = _pair(self.kernel) == (3, 3)
        bn = dict(eps=self.eps, relu=relu, train=train)
        if not train:
            bn.update(mean=state["mean"], var=state["var"])
        if is3x3:
            res = conv3x3_bn_act(x, params["W"], params["gamma"],
                                 params["beta"], **bn)
        else:
            res = conv1x1_bn_act(x, params["W"][0, 0], params["gamma"],
                                 params["beta"], stride=_pair(self.stride),
                                 **bn)
        if train:
            out, m, v = res
            d = self.decay
            new_state = {"mean": d * state["mean"] + (1 - d) * m,
                         "var": d * state["var"] + (1 - d) * v}
        else:
            out, new_state = res, state
        if not relu and act != "identity":
            out = self._act(out)
        return out, new_state
