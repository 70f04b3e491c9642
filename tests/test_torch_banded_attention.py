"""Sliding-window attention in the PyTorch port against the JAX package,
on the CPU: the plain version of the banded kernel B4 against JAX's
Pallas kernel in interpret mode, the autograd Function's gradients
against `jax.grad`, the band's key tiles (the CUDA kernel's loop
bounds), the layer's routing, `MultiHeadAttention.apply` with a window,
three Adam train steps of the windowed Llama-shaped transformer and of
the local/global pattern, and their configs both ways.

Tolerances: 1e-5 on attention outputs, layer outputs, losses (relative)
and parameters in float32 (the same math, sums in another order); 1e-4
on gradients (sums of up to T products through a softmax)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JaxConf
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers.attention import (
    MultiHeadAttention as JaxMHA,
)
from deeplearning4j_tpu.ops.banded_attention import (
    banded_attention as jax_banded,
)
from deeplearning4j_tpu.optim.updaters import Adam as JaxAdam
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import MultiHeadAttention
from deeplearning4j_tpu_torch.observe import get_registry
from deeplearning4j_tpu_torch.ops import banded_attention as ba

TOL = dict(rtol=1e-5, atol=1e-5)
ADAM = dict(learning_rate=1e-2, epsilon=1e-3)


def _qkv(rng, b, t, h, hkv, dh):
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, t, h, dh), (b, t, hkv, dh), (b, t, hkv, dh)))


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ plain B4
SHAPES = [(24, 5), (37, 1), (20, 30)]       # odd T and w, w >= T


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("hkv", [4, 2, 1], ids=["G1", "G2", "G4"])
@pytest.mark.parametrize("t,w", SHAPES, ids=[f"T{t}w{w}" for t, w in SHAPES])
def test_plain_b4_matches_jax_kernel(t, w, hkv, causal):
    rng = np.random.default_rng(t * 100 + w + hkv)
    q, k, v = _qkv(rng, 2, t, 4, hkv, 8)
    want = np.asarray(jax_banded(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), w, causal, None, 8, 8,
                                 interpret=True))
    ba.reset_counts()
    got = ba.banded_attention(_t(q), _t(k), _t(v), w, causal)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert not any(ba.LAUNCHES.values())          # CPU: the plain version


# bfloat16 (C6): the Pallas kernel rounds p to bfloat16 where it meets v,
# against the running max of its key blocks (8 here); so does the plain
# version, against blocks of `block_k` keys or the row max (the default)
BF16_BANDS = [(24, 5, 2, True), (64, 16, 4, True), (128, 40, 2, True),
              (64, 20, 2, False)]


@pytest.mark.parametrize("t,w,hkv,causal", BF16_BANDS)
def test_plain_b4_bf16_rounds_p_like_jax_kernel(t, w, hkv, causal):
    """o within 1e-3 of the largest |JAX| value with the kernel's blocks
    (repaired: 0 on these shapes; unrounded p before C6: 3.9e-3 to
    1.6e-2, 2.4-7.2x the tolerance), and within one bf16 step of |o|
    (2^-7, plus that 1e-3) against the row max (3.9e-3 at most)."""
    rng = np.random.default_rng(t + w + hkv)
    arrs = [jnp.asarray(a, jnp.bfloat16) for a in _qkv(rng, 2, t, 4, hkv, 8)]
    want = np.asarray(jax_banded(*arrs, w, causal, None, 8, 8,
                                 interpret=True).astype(jnp.float32))
    q, k, v = (torch.tensor(np.asarray(a.astype(jnp.float32)))
               .to(torch.bfloat16) for a in arrs)
    tol = 1e-3 * np.abs(want).max()
    got = ba.banded_reference(q, k, v, w, causal, block_k=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    row = ba.banded_attention(q, k, v, w, causal)      # the CPU wrapper
    np.testing.assert_allclose(row.float().numpy(), want, rtol=2.0 ** -7,
                               atol=tol)


def test_autograd_gradients_match_jax_grad():
    """The loss of the JAX package's own gradient test: sum(o^2)."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 32, 4, 2, 8)

    def loss(q_, k_, v_):
        return (jax_banded(q_, k_, v_, 8, True, None, 8, 8,
                           interpret=True) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    (ba.banded_attention(*leaves, 8, True) ** 2).sum().backward()
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,w", [(24, 5), (1000, 100), (300, 33), (37, 1),
                                 (100, 200), (2048, 256), (64, 64)])
def test_band_key_tiles_cover_exactly_the_band(t, w, causal):
    """The kernel's loop bounds: every visible (query, key) pair of a
    64-row query tile lies in a visited key tile, and the first and last
    visited tiles hold visible keys, so no tile is wasted at either end
    (the TPU kernel's `relevant` rule)."""
    vis = ba.band_visibility(t, w, causal)
    for q0 in range(0, t, ba.BAND_TILE):
        first, last = ba.band_key_tiles(q0, t, w, causal)
        cols = vis[q0:q0 + ba.BAND_TILE].any(dim=0).nonzero().flatten()
        assert int(cols.min()) // ba.BAND_TILE == first
        assert int(cols.max()) // ba.BAND_TILE == last
    assert ba.band_pairs(t, w, causal) == int(vis.sum())


# ------------------------------------------- B4 design 2: choice and tiles
@pytest.mark.parametrize("dtype,h,hkv,dh,want", [
    (torch.float32, 8, 2, 64, "folded"),     # path_w's shape
    (torch.float32, 8, 8, 64, "folded"),     # G 1
    (torch.float32, 8, 4, 32, "folded"),     # G 2, Dh 32
    (torch.float32, 8, 1, 128, "folded"),    # G 8, Dh 128
    (torch.bfloat16, 8, 2, 64, "ffma"),      # C6: design 1's key tiles
    (torch.float32, 4, 1, 48, "ffma"),       # Dh not 32/64/128
    (torch.float32, 6, 2, 64, "ffma"),       # G 3
    (torch.float32, 16, 1, 64, "ffma"),      # G 16
])
def test_b4_design_by_dtype_and_shape(dtype, h, hkv, dh, want):
    assert ba.b4_design(dtype, h, hkv, dh) == want
    buf = torch.zeros(4 + 2 * 8 * h * dh)         # 8 bytes in: unaligned
    assert ba.b4_design(dtype, h, hkv, dh,
                        (buf[2:-2].view(2, 8, h, dh),)) == "ffma"


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("t,w", [(2048, 256), (300, 33), (37, 1),
                                 (100, 200), (1000, 100)])
def test_design_2_tiles_cover_the_band_and_mask_only_cut_tiles(t, w, g,
                                                               causal):
    """Design 2's loop bounds (FOLD_ROWS / G positions a block, tiles of
    FOLD_KEYS keys) hold every visible pair of a block and no dead tile
    at either end; `band_tile_whole` calls a tile whole exactly when all
    its pairs are visible (rows past T aside), so the unmasked path never
    sees a hidden key; at path_w's shape 2 of a full block's 9 tiles are
    cut, the first and the diagonal."""
    bq, bk = ba.FOLD_ROWS // g, ba.FOLD_KEYS
    vis = ba.band_visibility(t, w, causal)
    for q0 in range(0, t, bq):
        first, last = ba.band_key_tiles(q0, t, w, causal, tile=bk,
                                        block_q=bq)
        cols = vis[q0:q0 + bq].any(dim=0).nonzero().flatten()
        assert int(cols.min()) // bk == first
        assert int(cols.max()) // bk == last
        cut = 0
        for kt in range(first, last + 1):
            k0 = kt * bk
            whole = ba.band_tile_whole(q0, k0, t, w, causal, bq, bk)
            all_vis = k0 + bk <= t and bool(vis[q0:q0 + bq,
                                                k0:k0 + bk].all())
            if whole:
                assert all_vis
            elif q0 + bq <= t:
                assert not all_vis
            cut += not whole
        if (t, w, g, causal) == (2048, 256, 4, True) and q0 >= w:
            assert (last - first + 1, cut) == (9, 2)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("hkv", [1, 2], ids=["G4", "G2"])
def test_plain_b4_at_design_2_tiles_matches_jax_kernel(hkv, causal):
    """The plain version at design 2's key tiles (`block_k` FOLD_KEYS)
    against JAX's Pallas kernel in interpret mode with 32-key blocks and
    128 / G query positions (its folded [G x Bq, Dh] tile is design 2's
    128 rows), float32, at 1e-5; `block_k` rounds only bfloat16, so this
    is the function design 2 computes."""
    t, w, h = 192, 40, 4
    rng = np.random.default_rng(hkv + 10 * causal)
    q, k, v = _qkv(rng, 2, t, h, hkv, 8)
    want = np.asarray(jax_banded(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), w, causal, None,
                                 ba.FOLD_ROWS // (h // hkv), ba.FOLD_KEYS,
                                 interpret=True))
    got = ba.banded_reference(_t(q), _t(k), _t(v), w, causal,
                              block_k=ba.FOLD_KEYS)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_b4_launch_counts_by_design_reset_and_stay_zero_on_cpu():
    ba.LAUNCHES_BY_DESIGN[("banded_attention", "folded")] = 4
    ba.reset_counts()
    assert ba.LAUNCHES_BY_DESIGN[("banded_attention", "folded")] == 0
    rng = np.random.default_rng(1)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 40, 4, 1, 32))
    for design in (None, "folded", "ffma"):
        ba.banded_attention_fwd(q, k, v, 8, True, design=design)
    assert set(ba.LAUNCHES_BY_DESIGN.values()) == {0}
    assert ba.LAUNCHES["banded_attention"] == 0


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 8, 4, 8)
    with pytest.raises(ValueError, match="divisible"):
        ba.banded_attention(q, torch.zeros(1, 8, 3, 8),
                            torch.zeros(1, 8, 3, 8), 4)
    with pytest.raises(ValueError, match="window"):
        ba.banded_attention(q, q, q, 0)
    with pytest.raises(ValueError, match="differ"):
        ba.banded_attention(q, q[:, :4], q[:, :4], 4)


# --------------------------------------------------------------- layer
def _mha_pair(window, causal, hkv=2, d=32, h=4):
    kw = dict(n_in=d, n_out=d, num_heads=h, num_kv_heads=hkv, causal=causal,
              rope=True, window=window, weight_init="xavier",
              activation="identity")
    jl = JaxMHA(**kw)
    params, _ = jl.init_params(jax.random.PRNGKey(3),
                               JaxInputType.recurrent(d, 16))
    pp = {k: _t(np.asarray(v)) for k, v in params.items()}
    return jl, params, MultiHeadAttention(**kw), pp


def _dispatch(impl):
    return get_registry().counter("kernel_dispatch_total", op="attention",
                                  impl=impl).value


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_windowed_apply_matches_jax_layer(hkv, causal):
    jl, params, pl_, pp = _mha_pair(6, causal, hkv)
    x = np.random.default_rng(9).standard_normal((2, 19, 32)) \
        .astype(np.float32)
    want, _ = jl.apply(params, jnp.asarray(x))
    got, _ = pl_.apply(pp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_windowed_apply_routes_to_the_plain_b4_on_native_kv(monkeypatch):
    """A window with no mask and no dropout goes to B4 (on CPU tensors its
    plain version, counted impl="plain"), handed the native Hkv-wide
    K/V: nothing is broadcast to H heads first."""
    _, _, pl_, pp = _mha_pair(6, True, hkv=2)
    seen = []
    real = ba.banded_attention

    def spy(q, k, v, window, causal=True, scale=None):
        seen.append((q.shape[2], k.shape[2], v.shape[2], window, causal))
        return real(q, k, v, window, causal, scale)

    monkeypatch.setattr(ba, "banded_attention", spy)
    plain, dense = _dispatch("plain"), _dispatch("dense")
    pl_.apply(pp, torch.randn(2, 12, 32))
    assert seen == [(4, 2, 2, 6, True)]
    assert _dispatch("plain") == plain + 1 and _dispatch("dense") == dense


def test_banded_policy_refuses_head_dims_past_the_kernel_on_the_card():
    """A CUDA tensor never falls back to a plain version: a head dim past
    B4's largest tile is refused on the card; the CPU's plain version
    takes any head dim."""
    from deeplearning4j_tpu_torch.ops.kernel_defaults import (
        attention_policy,
    )

    with pytest.raises(ValueError, match="banded kernel for head dim 160"):
        attention_policy(device="cuda", window=4, head_dim=160)
    assert attention_policy(device="cpu", window=4,
                            head_dim=160).kind == "banded"
    banded = get_registry().counter("kernel_dispatch_total",
                                    op="attention", impl="banded").value
    assert attention_policy(device="cuda", window=4).kind == "banded"
    assert get_registry().counter("kernel_dispatch_total", op="attention",
                                  impl="banded").value == banded + 1


def test_windowed_apply_with_a_mask_or_dropout_stays_dense(monkeypatch):
    jl, params, pl_, pp = _mha_pair(6, True, hkv=2)
    monkeypatch.setattr(ba, "banded_attention", None)   # must not be called
    x = np.random.default_rng(2).standard_normal((2, 9, 32)) \
        .astype(np.float32)
    mask = np.ones((2, 9), np.float32)
    mask[1, 6:] = 0.0
    dense = _dispatch("dense")
    got, _ = pl_.apply(pp, _t(x), mask=_t(mask))
    want, _ = jl.apply(params, jnp.asarray(x), mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    drop = MultiHeadAttention(n_in=32, n_out=32, num_heads=4,
                              num_kv_heads=2, causal=True, window=6,
                              attn_dropout=0.5, weight_init="xavier",
                              activation="identity")
    drop.apply(pp, _t(x), train=True, rng=torch.Generator().manual_seed(1))
    assert _dispatch("dense") == dense + 2


# ------------------------------------------------------------ the slice
MODELS = {
    # the sliding-window Llama shape of `path_w`, narrow
    "window": dict(pos_encoding="rope", norm="rms", ffn_activation="swiglu",
                   num_kv_heads=2, window=8),
    # the Gemma-style local/global pattern: B4 and B3 in one model
    "local_global": dict(pos_encoding="rope", norm="rms",
                         ffn_activation="swiglu", num_kv_heads=2,
                         window=[8, None]),
}


def _pair(name, T=24):
    jconf = JaxTGT(input_shape=(T, 1), d_model=32, num_heads=4,
                   num_blocks=2, updater=JaxAdam(**ADAM),
                   **MODELS[name]).conf()
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return jconf, jnet, pnet


@pytest.mark.parametrize("name", sorted(MODELS))
def test_three_train_steps_match_jax(name):
    _, jnet, pnet = _pair(name)
    blocks = [l for l in pnet.layers if hasattr(l, "window")]
    assert [b.window for b in blocks] == \
        ([8, None] if name == "local_global" else [8, 8])
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (3, 25))
    x = toks[:, :24, None].astype(np.float32)
    y = np.eye(256, dtype=np.float32)[toks[:, 1:]]
    jstep, pstep = jnet.make_step_fn(), pnet.make_step_fn()
    jp, jo, js = jnet.params_tree, jnet.updater_state, jnet.state_tree
    pp, po, ps = pnet.params_tree, pnet.updater_state, pnet.state_tree
    for i in range(3):
        jp, jo, js, jl, _ = jstep(jp, jo, js, jnp.asarray(i, jnp.int32),
                                  jnp.asarray(x), jnp.asarray(y), None, None,
                                  jax.random.PRNGKey(0), None)
        pp, po, ps, pl, _ = pstep(pp, po, ps, torch.tensor(i),
                                  torch.from_numpy(x), torch.from_numpy(y),
                                  None, None, None, None)
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    for layer, sub in pp.items():
        for key, val in sub.items():
            np.testing.assert_allclose(val.detach().numpy(),
                                       np.asarray(jp[layer][key]), rtol=0,
                                       atol=1e-5, err_msg=f"{layer}/{key}")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_config_json_both_ways(name):
    jconf, _, pnet = _pair(name)
    assert json.loads(pnet.conf.to_json()) == json.loads(jconf.to_json())
    assert JaxConf.from_json(pnet.conf.to_json()) == jconf
