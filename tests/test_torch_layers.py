"""Layers, configs and the full stack of the PyTorch port against the JAX
package, on the CPU, from the same seeded numpy inputs and the JAX
weights carried across with `params_from_numpy`. Tolerance 1e-5 in
float32 (both sides float32; they differ only in summation order)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers.attention import (
    MultiHeadAttention as JaxMHA,
    TransformerEncoderBlock as JaxBlock,
    rope_rotate as jax_rope,
)
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    MultiHeadAttention, TransformerEncoderBlock,
)
from deeplearning4j_tpu_torch.nn.layers.attention import rope_rotate
from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

TOL = dict(atol=1e-5, rtol=1e-5)

VARIANTS = {
    "gpt": dict(),
    "llama": dict(pos_encoding="rope", norm="rms", ffn_activation="swiglu",
                  num_kv_heads=2, window=6, rolling_cache=True),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _carry_to_torch(carry):
    """A JAX per-slot decode carry (numpy) as the port's carry, caches
    built with their drop row (`new_kv_cache`)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import new_kv_cache

    out = {}
    for k, v in carry.items():
        v = np.asarray(v)
        if k in ("cache_k", "cache_v"):
            t = new_kv_cache(v.shape, torch.float32, "cpu")
            t.copy_(_t(v))
            out[k] = t
        else:
            out[k] = _t(v.astype(np.int32))
    return out


# ------------------------------------------------------------------ RoPE
@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(per_row):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 8)).astype(np.float32)
    pos = (rng.integers(0, 900, (3, 5)) if per_row
           else np.arange(5)).astype(np.int32)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = rope_rotate(_t(x), _t(pos)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ----------------------------------------------------------------- block
@pytest.mark.parametrize("ffn", ["gelu", "swiglu"])
@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_encoder_block_matches_jax(norm, ffn):
    """Full-context apply with a padding mask, GQA and RoPE."""
    kw = dict(n_in=16, num_heads=4, num_kv_heads=2, causal=True, rope=True,
              norm=norm, ffn_activation=ffn, weight_init="xavier",
              activation="identity", max_cache=16)
    jb = JaxBlock(**kw)
    params, _ = jb.init_params(jax.random.PRNGKey(3),
                               JaxInputType.recurrent(16, 7))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    mask = np.ones((2, 7), np.float32)
    mask[1, 5:] = 0.0
    want, _ = jb.apply(params, jnp.asarray(x), mask=jnp.asarray(mask))
    pb = TransformerEncoderBlock(**kw)
    got, _ = pb.apply({k: _t(v) for k, v in _np_params(params).items()},
                      _t(x), mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------- per-slot decode chunks
LAYOUTS = [("linear", dict(window=None, rolling_cache=False), None),
           ("rolling", dict(window=5, rolling_cache=True), None),
           ("paged", dict(window=None, rolling_cache=False), 4)]


@pytest.mark.parametrize("layout,lkw,page_len", LAYOUTS,
                         ids=[l[0] for l in LAYOUTS])
def test_per_slot_decode_matches_jax(layout, lkw, page_len):
    """Padded prefill chunks with an inactive lane (its mask row all
    zero), then single-token steps: outputs of valid tokens, the caches
    (in place on the port's side) and the positions all match JAX."""
    B, d, H, Hkv, L = 3, 16, 4, 2, 16
    kw = dict(n_in=d, n_out=d, num_heads=H, num_kv_heads=Hkv, causal=True,
              rope=True, max_cache=L, weight_init="xavier",
              activation="identity", **lkw)
    jl = JaxMHA(**kw)
    params, _ = jl.init_params(jax.random.PRNGKey(5),
                               JaxInputType.recurrent(d, 4))
    pl_ = MultiHeadAttention(**kw)
    pp = {k: _t(v) for k, v in _np_params(params).items()}
    ckw = {} if page_len is None else dict(page_len=page_len, pages=14)
    jst = jl.decode_carry(B, jnp.float32, per_slot=True, **ckw)
    if page_len is not None:
        # scattered physical pages; slot 2 owns fewer pages (its tail
        # entries point at page 0, which slot 0 owns)
        pt = np.array([[0, 5, 9, 2], [7, 1, 11, 4], [3, 13, 0, 0]],
                      np.int32)
        jst = dict(jst, page_table=jnp.asarray(pt))
    pst = _carry_to_torch(jax.tree_util.tree_map(np.asarray, jst))
    rng = np.random.default_rng(7)
    chunks = [(4, np.array([[1, 1, 1, 1], [1, 1, 0, 0], [0, 0, 0, 0]])),
              (4, np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 0]])),
              (1, np.array([[1], [0], [1]])),
              (1, np.array([[1], [1], [1]])),
              (4, np.array([[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 0]]))]
    for T, m in chunks:
        x = rng.standard_normal((B, T, d)).astype(np.float32)
        m = m.astype(np.float32)
        yj, jst = jl.apply(params, jnp.asarray(x), state=jst,
                           mask=jnp.asarray(m))
        yp, pst = pl_.apply(pp, _t(x), state=pst, mask=_t(m))
        valid = m > 0
        np.testing.assert_allclose(yp.numpy()[valid],
                                   np.asarray(yj)[valid], **TOL)
        np.testing.assert_array_equal(pst["pos"].numpy(),
                                      np.asarray(jst["pos"]))
        for key in ("cache_k", "cache_v"):
            np.testing.assert_allclose(pst[key].numpy(),
                                       np.asarray(jst[key]), **TOL)


def test_padding_never_writes_through_an_unmapped_page():
    """A padded token of a paged slot whose logical page is unmapped
    would land in physical page 0 — another slot's live page — if its
    write were clamped instead of dropped. The drop row keeps page 0
    intact."""
    d, H, L, Lp = 8, 2, 16, 4
    layer = MultiHeadAttention(n_in=d, n_out=d, num_heads=H, causal=True,
                               max_cache=L, weight_init="xavier",
                               activation="identity")
    params, _ = layer.init_params(torch.Generator().manual_seed(0), None)
    st = layer.decode_carry(2, per_slot=True, page_len=Lp, pages=8,
                            device="cpu")
    st["page_table"].copy_(torch.tensor([[0, 1, 2, 3], [4, 0, 0, 0]],
                                        dtype=torch.int32))
    st["cache_k"][0].fill_(7.0)
    st["cache_v"][0].fill_(7.0)
    st["pos"][1] = 3            # slot 1: its next chunk crosses into page 1
    x = torch.randn(2, 4, d)
    mask = torch.tensor([[0.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]])
    _, st = layer.apply(params, x, state=st, mask=mask)
    assert torch.all(st["cache_k"][0] == 7.0)
    assert torch.all(st["cache_v"][0] == 7.0)
    assert st["pos"].tolist() == [0, 4]
    # the one valid token landed at logical 3 = physical page 4, offset 3
    assert torch.any(st["cache_k"][4, 3] != 0)


def test_linear_overflow_poisons_the_lane_not_the_cache():
    layer = MultiHeadAttention(n_in=8, n_out=8, num_heads=2, causal=True,
                               max_cache=4, weight_init="xavier",
                               activation="identity")
    params, _ = layer.init_params(torch.Generator().manual_seed(0), None)
    st = layer.decode_carry(2, per_slot=True, device="cpu")
    st["pos"].copy_(torch.tensor([1, 3], dtype=torch.int32))
    before = st["cache_k"].clone()
    y, st = layer.apply(params, torch.randn(2, 2, 8), state=st)
    assert torch.isfinite(y[0]).all() and torch.isnan(y[1]).all()
    # slot 1 wrote position 3 and dropped position 4 (past the cache)
    assert torch.equal(st["cache_k"][1, :3], before[1, :3])


# ------------------------------------------------------------ full stack
def _pair(variant, T=16, d=32, blocks=2):
    jconf = JaxTGT(input_shape=(T, 1), d_model=d, num_heads=4,
                   num_blocks=blocks, **VARIANTS[variant]).conf()
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return jconf, jnet, pnet


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_output_logits_match_jax(variant):
    _, jnet, pnet = _pair(variant)
    x = np.random.default_rng(2).integers(0, 256, (3, 16, 1)).astype(
        np.float32)
    want = np.asarray(jnet.output(x))
    got = pnet.output(x).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_config_from_jax_json_is_the_ports_own(variant):
    """The JAX config's JSON builds the same layers as the port's own zoo
    model, each layer's cascaded updater (the zoo's `Adam(3e-4)`)
    included, and writes back out as the same JSON."""
    jconf = JaxTGT(input_shape=(16, 1), d_model=32, num_heads=4,
                   num_blocks=2, **VARIANTS[variant]).conf()
    from_jax = MultiLayerConfiguration.from_json(jconf.to_json())
    own = TextGenerationTransformer(input_shape=(16, 1), d_model=32,
                                    num_heads=4, num_blocks=2,
                                    **VARIANTS[variant]).conf()
    assert list(from_jax.layers) == list(own.layers)
    assert from_jax.updater == own.updater
    assert from_jax.input_type == own.input_type
    assert json.loads(from_jax.to_json()) == json.loads(jconf.to_json())
    assert json.loads(own.to_json()) == json.loads(jconf.to_json())


def test_params_from_numpy_checks_names_and_shapes():
    _, jnet, pnet = _pair("gpt")
    tree = jax.tree_util.tree_map(np.asarray, jnet.params_tree)
    name = next(iter(tree))
    with pytest.raises(KeyError):
        params_from_numpy(pnet, {k: v for k, v in tree.items()
                                 if k != name})
    bad = {k: dict(v) for k, v in tree.items()}
    key = next(iter(bad[name]))
    bad[name][key] = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError):
        params_from_numpy(pnet, bad)


def test_entry_points_refuse_to_guess_the_cpu():
    conf = TextGenerationTransformer(input_shape=(8, 1), d_model=16,
                                     num_heads=2, num_blocks=1).conf()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(conf)
