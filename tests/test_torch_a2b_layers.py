"""The nine CNN-family layers of slice 21 against the JAX package's, on
the CPU in float64: `Deconvolution2DLayer`, `DepthwiseConvolution2DLayer`,
`SeparableConvolution2DLayer`, `Cropping2DLayer`, `Upsampling2DLayer`,
`Convolution1DLayer`, `Subsampling1DLayer`, `LocalResponseNormalization`
and `LayerNormalization`.

Each case reads the JAX layer's JSON in the port (and the port's JSON
back in JAX: both ways, byte-identical), initializes the parameters in
JAX, and holds the port's forward and its gradients (input and every
parameter, through one random cotangent) to JAX's within 1e-10.

C15 (reference-side): JAX's `Deconvolution2DLayer` pads truncate mode by
(p, p) and so returns 5×5 where its own `output_type` states 9×9 (h 4,
k 3, s 2, p 0). The port pads by k−1−p: it agrees with `output_type`,
with an independent reference (`lax.conv_transpose(x, K, padding=
k−1−p, transpose_kernel=True)` on K = W flipped and swapped) and with
JAX's layer where JAX's is right ("same" mode, p = (k−1)/2)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.inputs import InputType as JaxIT
from deeplearning4j_tpu.utils import serde as jserde
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.utils import serde as pserde

TOL = dict(rtol=1e-10, atol=1e-10)

CNN = JaxIT.convolutional(7, 6, 3)
RNN = JaxIT.recurrent(5, 9)
CASES = {
    "deconv_same_s2": (jl.Deconvolution2DLayer(
        n_out=4, kernel=(3, 3), stride=(2, 2), convolution_mode="same",
        activation="tanh"), CNN),
    "deconv_truncate_half_pad": (jl.Deconvolution2DLayer(
        n_out=4, kernel=(3, 3), stride=(2, 2), padding=(1, 1)), CNN),
    "deconv_same_k2_s3": (jl.Deconvolution2DLayer(
        n_out=2, kernel=(2, 4), stride=(3, 1), convolution_mode="same"),
        CNN),
    "depthwise_mult2_same": (jl.DepthwiseConvolution2DLayer(
        depth_multiplier=2, kernel=(3, 3), convolution_mode="same",
        activation="relu"), CNN),
    "depthwise_mult3_s2": (jl.DepthwiseConvolution2DLayer(
        depth_multiplier=3, kernel=(2, 3), stride=(2, 2), padding=(1, 0)),
        CNN),
    "separable_mult2_same_s2": (jl.SeparableConvolution2DLayer(
        n_out=5, depth_multiplier=2, kernel=(3, 3), stride=(2, 2),
        convolution_mode="same", activation="sigmoid"), CNN),
    "separable_truncate": (jl.SeparableConvolution2DLayer(
        n_out=4, kernel=(3, 2), padding=(1, 1), has_bias=False), CNN),
    "cropping_pair": (jl.Cropping2DLayer(crop=(1, 2)), CNN),
    "cropping_sides": (jl.Cropping2DLayer(crop=((2, 0), (1, 3))), CNN),
    "upsampling": (jl.Upsampling2DLayer(size=(2, 3)), CNN),
    "conv1d_same_even_k_s2": (jl.Convolution1DLayer(
        n_out=4, kernel=4, stride=2, activation="tanh"), RNN),
    "conv1d_truncate_p1": (jl.Convolution1DLayer(
        n_out=3, kernel=3, padding=1, convolution_mode="truncate"), RNN),
    "subsampling1d_max_same": (jl.Subsampling1DLayer(
        pooling="max", kernel=3, stride=2, convolution_mode="same"), RNN),
    "subsampling1d_avg_same": (jl.Subsampling1DLayer(
        pooling="avg", kernel=4, stride=2, convolution_mode="same"), RNN),
    "subsampling1d_avg_truncate_p1": (jl.Subsampling1DLayer(
        pooling="avg", kernel=3, stride=2, padding=1), RNN),
    "subsampling1d_max_truncate_p1": (jl.Subsampling1DLayer(
        pooling="max", kernel=2, stride=2, padding=1), RNN),
    "lrn_7_channels": (jl.LocalResponseNormalization(), JaxIT.convolutional(
        4, 3, 7)),
    "lrn_n4_alpha": (jl.LocalResponseNormalization(
        n=4, k=1.0, alpha=0.3, beta=0.5), JaxIT.convolutional(3, 3, 6)),
    "layernorm_ff": (jl.LayerNormalization(activation="tanh"),
                     JaxIT.feed_forward(6)),
    "layernorm_rnn": (jl.LayerNormalization(eps=1e-3), RNN),
}


def _t(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def _jax_and_port(layer, it):
    layer = dataclasses.replace(layer.infer_n_in(it), name="l0")
    text = jserde.to_json(layer)
    return layer, pserde.from_json(text), text


def _input(it, rng, batch=2):
    return rng.standard_normal(it.shape(batch))


def _run(jlayer, player, it, seed=0):
    """JAX's and the port's (y, dx, dparams) on the same float64 inputs
    and parameters."""
    rng = np.random.default_rng(seed)
    params, _ = jlayer.init_params(jax.random.PRNGKey(seed), it,
                                   jnp.float64)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape)), params)
    x = _input(it, rng)
    yj = jlayer.apply(params, jnp.asarray(x))[0]
    cot = rng.standard_normal(yj.shape)

    def f(p, xx):
        return jnp.sum(jlayer.apply(p, xx)[0] * cot)

    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    tp = {k: _t(v) for k, v in params.items()}
    tx = _t(x)
    yp = player.apply(tp, tx)[0]
    (yp * torch.tensor(cot)).sum().backward()
    return (yj, gx, gp), (yp, tx.grad, {k: v.grad for k, v in tp.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_forward_gradient_and_json_match_jax(case):
    jlayer, it = CASES[case]
    jlayer, player, text = _jax_and_port(jlayer, it)
    assert type(player).__name__ == type(jlayer).__name__
    assert pserde.to_json(player) == text
    assert jserde.to_json(jserde.from_json(pserde.to_json(player))) == text
    out_t = jlayer.output_type(it)
    assert player.output_type(InputType.from_dict(it.to_dict())).to_dict() \
        == out_t.to_dict()
    (yj, gx, gp), (yp, px, pp) = _run(jlayer, player, it)
    assert tuple(yp.shape) == tuple(yj.shape)
    np.testing.assert_allclose(yp.detach().numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(px.numpy(), np.asarray(gx), **TOL)
    assert set(pp) == set(gp)
    for k in gp:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(gp[k]), **TOL,
                                   err_msg=k)


def test_depthwise_output_channel_reads_input_channel_j_div_mult():
    """At multiplier 2, output channels 2c and 2c+1 read input channel c
    alone (JAX's `feature_group_count` grouping, torch's `groups`)."""
    layer = pl.DepthwiseConvolution2DLayer(n_in=3, depth_multiplier=2,
                                           kernel=(1, 1), has_bias=False)
    w = torch.arange(1.0, 7.0, dtype=torch.float64).reshape(1, 1, 1, 6)
    x = torch.zeros(1, 2, 2, 3, dtype=torch.float64)
    x[..., 1] = 1.0
    y = layer.apply({"W": w}, x)[0]
    np.testing.assert_array_equal(y[0, 0, 0].numpy(), [0, 0, 3, 4, 0, 0])


def test_lrn_edge_channels_see_the_zero_padding():
    layer = pl.LocalResponseNormalization(k=1.0, n=5, alpha=5.0, beta=1.0)
    x = torch.ones(1, 1, 1, 7, dtype=torch.float64)
    y = layer.apply({}, x)[0][0, 0, 0].numpy()
    # window sums: 3, 4, 5, 5, 5, 4, 3 ones (alpha / n = 1)
    np.testing.assert_allclose(y, 1.0 / (1.0 + np.array(
        [3, 4, 5, 5, 5, 4, 3])), rtol=0, atol=1e-15)


# ------------------------------------------------------------------ C15


def _deconv_pair(padding, mode="truncate", k=3, s=2):
    jlayer = jl.Deconvolution2DLayer(name="d", n_in=3, n_out=2,
                                     kernel=(k, k), stride=(s, s),
                                     padding=(padding, padding),
                                     convolution_mode=mode, has_bias=False)
    return jlayer, pserde.from_json(jserde.to_json(jlayer))


def _weights(k=3, n_in=3, n_out=2, seed=1):
    return np.random.default_rng(seed).standard_normal((k, k, n_in, n_out))


def test_c15_jax_truncate_deconvolution_disagrees_with_its_output_type():
    jlayer, _ = _deconv_pair(0)
    it = JaxIT.convolutional(4, 4, 3)
    assert (jlayer.output_type(it).height, jlayer.output_type(it).width) \
        == (9, 9)
    x = np.random.default_rng(0).standard_normal((1, 4, 4, 3))
    y = jlayer.apply({"W": jnp.asarray(_weights())}, jnp.asarray(x))[0]
    assert y.shape == (1, 5, 5, 2)


@pytest.mark.parametrize("k,s,p", [(3, 2, 0), (3, 1, 0), (4, 2, 1),
                                   (5, 3, 1)])
def test_c15_port_truncate_deconvolution_equals_the_transposed_reference(
        k, s, p):
    """The port's truncate mode: `output_type`'s size, and the values of
    `lax.conv_transpose(x, K, padding=(k−1−p,)·2, transpose_kernel=True)`
    with K = swap(flip(W)), forward and input gradient."""
    jlayer, player = _deconv_pair(p, k=k, s=s)
    it = JaxIT.convolutional(4, 5, 3)
    w = _weights(k)
    x = np.random.default_rng(2).standard_normal((2, 4, 5, 3))
    kk = jnp.asarray(np.swapaxes(w[::-1, ::-1], 2, 3))

    def ref(xx):
        return lax.conv_transpose(
            xx, kk, strides=(s, s), padding=[(k - 1 - p, k - 1 - p)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            transpose_kernel=True)

    yr = ref(jnp.asarray(x))
    ot = jlayer.output_type(it)
    assert yr.shape == (2, ot.height, ot.width, 2)
    tx = _t(x)
    yp = player.apply({"W": torch.tensor(w)}, tx)[0]
    assert tuple(yp.shape) == yr.shape
    np.testing.assert_allclose(yp.detach().numpy(), np.asarray(yr), **TOL)
    cot = np.random.default_rng(3).standard_normal(yr.shape)
    gx = jax.grad(lambda xx: jnp.sum(ref(xx) * cot))(jnp.asarray(x))
    (yp * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)


@pytest.mark.parametrize("mode,p", [("same", 0), ("truncate", 1)])
def test_c15_port_deconvolution_equals_jax_where_jax_is_right(mode, p):
    jlayer, player = _deconv_pair(p, mode)
    w = _weights()
    x = np.random.default_rng(4).standard_normal((2, 4, 5, 3))
    yj = jlayer.apply({"W": jnp.asarray(w)}, jnp.asarray(x))[0]
    yp = player.apply({"W": torch.tensor(w)}, torch.tensor(x))[0]
    it = JaxIT.convolutional(4, 5, 3)
    assert yj.shape[1:3] == (jlayer.output_type(it).height,
                             jlayer.output_type(it).width)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
