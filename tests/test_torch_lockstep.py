"""Lockstep (0-d position) decode carries of the PyTorch port against the
JAX package's scalar branch, on the CPU, in float64: `MultiHeadAttention.
_decode` over linear and ring caches, learned (no RoPE) and RoPE
positions, MHA and GQA, in chunks and single-token steps (the port's
single-token step goes through B5's plain version); the lockstep
`PositionEmbeddingLayer`; the defaults of `decode_carry` (F1);
`rnn_time_step` on both runtimes against JAX's and against the full
forward, its host-side budget, its causal validation and
`rnn_reorder_state`; the graphed stepping call against the eager one.
Tolerance 1e-9 (float64 sums in another order); with RoPE 1e-7 absolute
and 1e-6 relative: its angles are float32 in both packages, and their
float32 cos and sin may differ in the last bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers.attention import (
    MultiHeadAttention as JaxMHA,
    PositionEmbeddingLayer as JaxPosEmb,
    TransformerEncoderBlock as JaxBlock,
)
from deeplearning4j_tpu_torch.nn.layers import (
    MultiHeadAttention, PositionEmbeddingLayer, TransformerEncoderBlock,
)

from torch_stepping_pairs import RUNTIMES, pair, tgl_conf, tgt_conf

TOL = dict(rtol=1e-9, atol=1e-9)
ROPE_TOL = dict(rtol=1e-6, atol=1e-7)


def _tol(rope: bool):
    return ROPE_TOL if rope else TOL


def _t(a):
    return torch.from_numpy(np.array(a))


CACHES = {"linear": dict(max_cache=16),
          "linear_window": dict(max_cache=16, window=5),
          "ring": dict(max_cache=8, window=4, rolling_cache=True)}


@pytest.mark.parametrize("heads", ["mha", "gqa"])
@pytest.mark.parametrize("rope", [False, True], ids=["learned", "rope"])
@pytest.mark.parametrize("cache", sorted(CACHES))
def test_lockstep_decode_matches_jax_scalar_branch(cache, rope, heads):
    """Chunks of 3, 1, 1, 4, 1, 1 tokens (the ring wraps): outputs, the
    caches and the 0-d position against JAX's scalar branch."""
    B, d, H = 2, 16, 4
    kw = dict(n_in=d, n_out=d, num_heads=H, causal=True, rope=rope,
              num_kv_heads=2 if heads == "gqa" else None,
              weight_init="xavier", activation="identity", **CACHES[cache])
    jl = JaxMHA(**kw)
    params, _ = jl.init_params(jax.random.PRNGKey(3),
                               JaxInputType.recurrent(d, 4), jnp.float64)
    pl_ = MultiHeadAttention(**kw)
    pp = {k: _t(v) for k, v in params.items()}
    jst = jl.decode_carry(B, jnp.float64)
    pst = pl_.decode_carry(B, torch.float64, device="cpu")
    assert pst["pos"].ndim == 0 and pst["pos"].dtype == torch.int32
    rng = np.random.default_rng(4)
    for t in (3, 1, 1, 4, 1, 1):
        x = rng.standard_normal((B, t, d))
        yj, jst = jl.apply(params, jnp.asarray(x), state=jst)
        # a mask is ignored by the lockstep branch, as in JAX
        yp, pst = pl_.apply(pp, _t(x), state=pst,
                            mask=torch.zeros(B, t, dtype=torch.float64))
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **_tol(rope))
        assert pst["pos"].ndim == 0 and int(pst["pos"]) == int(jst["pos"])
        for key in ("cache_k", "cache_v"):
            np.testing.assert_allclose(pst[key].numpy(),
                                       np.asarray(jst[key]), **_tol(rope))


def test_lockstep_bidirectional_chunks_match_jax():
    """A non-causal layer's lockstep chunk sees the written prefix and
    |i - j| < window, as JAX's scalar branch."""
    B, d = 2, 8
    kw = dict(n_in=d, n_out=d, num_heads=2, causal=False, max_cache=12,
              window=3, weight_init="xavier", activation="identity")
    jl = JaxMHA(**kw)
    params, _ = jl.init_params(jax.random.PRNGKey(5),
                               JaxInputType.recurrent(d, 4), jnp.float64)
    pl_ = MultiHeadAttention(**kw)
    pp = {k: _t(v) for k, v in params.items()}
    jst = jl.decode_carry(B, jnp.float64)
    pst = pl_.decode_carry(B, torch.float64, device="cpu")
    rng = np.random.default_rng(6)
    for t in (4, 1, 3):
        x = rng.standard_normal((B, t, d))
        yj, jst = jl.apply(params, jnp.asarray(x), state=jst)
        yp, pst = pl_.apply(pp, _t(x), state=pst)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


def test_lockstep_linear_overflow_is_nan_not_a_clamped_write():
    layer = MultiHeadAttention(n_in=8, n_out=8, num_heads=2, causal=True,
                               max_cache=4, weight_init="xavier",
                               activation="identity")
    params, _ = layer.init_params(torch.Generator().manual_seed(0), None)
    st = layer.decode_carry(2, device="cpu")
    y, st = layer.apply(params, torch.randn(2, 3, 8), state=st)
    before = st["cache_k"].clone()
    y, st = layer.apply(params, torch.randn(2, 2, 8), state=st)
    assert torch.isnan(y).all() and int(st["pos"]) == 5
    # position 3 landed; position 4 (past the cache) was dropped
    assert torch.equal(st["cache_k"][:, :3], before[:, :3])
    assert not torch.equal(st["cache_k"][:, 3], before[:, 3])


def test_position_embedding_lockstep_matches_jax():
    jl, pl_ = JaxPosEmb(max_length=6, n_out=4), PositionEmbeddingLayer(
        max_length=6, n_out=4)
    params, _ = jl.init_params(jax.random.PRNGKey(1),
                               JaxInputType.recurrent(4, 6), jnp.float64)
    pp = {"P": _t(params["P"])}
    jst, pst = jl.decode_carry(3), pl_.decode_carry(3, device="cpu")
    rng = np.random.default_rng(2)
    for t in (2, 1, 3):
        x = rng.standard_normal((3, t, 4))
        yj, jst = jl.apply(params, jnp.asarray(x), state=jst)
        yp, pst = pl_.apply(pp, _t(x), state=pst)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
        assert pst["pos"].ndim == 0 and int(pst["pos"]) == int(jst["pos"])
    # past max_length: NaN in the graph (JAX raises eagerly instead)
    y, pst = pl_.apply(pp, _t(rng.standard_normal((3, 1, 4))), state=pst)
    assert torch.isnan(y).all() and int(pst["pos"]) == 7


LAYERS = {
    "mha": (JaxMHA, MultiHeadAttention,
            dict(n_in=8, n_out=8, num_heads=2, causal=True)),
    "position": (JaxPosEmb, PositionEmbeddingLayer,
                 dict(max_length=8, n_out=8)),
    "block": (JaxBlock, TransformerEncoderBlock,
              dict(n_in=8, num_heads=2)),
}


@pytest.mark.parametrize("per_slot", [None, False, True],
                         ids=["default", "lockstep", "per_slot"])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_decode_carry_defaults_agree_with_jax(layer, per_slot):
    """F1: `decode_carry(B)` is a lockstep carry in both packages, and
    `per_slot=` picks the same layout in both."""
    jcls, pcls, kw = LAYERS[layer]
    ckw = {} if per_slot is None else dict(per_slot=per_slot)
    jc = jax.tree_util.tree_map(np.asarray, jcls(**kw).decode_carry(3,
                                                                    **ckw))
    pc = pcls(**kw).decode_carry(3, device="cpu", **ckw)
    want = jax.tree_util.tree_leaves_with_path(jc)
    got = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), pc))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("kw,match", [
    (dict(kv_dtype="int8"), "session-pool feature"),
    (dict(page_len=4), "session-pool feature")],
    ids=["quantized", "paged"])
def test_lockstep_carries_refuse_quantized_and_paged(kw, match):
    layer = MultiHeadAttention(n_in=8, n_out=8, num_heads=2, causal=True,
                               max_cache=16)
    with pytest.raises(ValueError, match=match):
        layer.decode_carry(2, **kw)
    with pytest.raises(ValueError, match=match):
        JaxMHA(n_in=8, n_out=8, num_heads=2, causal=True,
               max_cache=16).decode_carry(2, **kw)


# --------------------------------------------------- rnn_time_step
STEP_CASES = [("text_generation", (5, 1, 1, 3, 1)),
              ("modern_llm", (4, 4, 1, 1, 1)),
              ("ring", (3, 2, 1, 1, 1, 1, 1))]


@pytest.mark.parametrize("runtime", RUNTIMES)
@pytest.mark.parametrize("config,chunks", STEP_CASES,
                         ids=[c for c, _ in STEP_CASES])
def test_rnn_time_step_rollout_matches_jax_and_the_full_forward(
        config, chunks, runtime):
    T = sum(chunks)
    tol = _tol(config != "text_generation")
    jnet, pnet = pair(tgt_conf(config, T=T), runtime)
    x = np.random.default_rng(7).integers(0, 11, (3, T, 1)).astype(
        np.float64)
    full = pnet.output(x).numpy()
    s = 0
    for c in chunks:
        want = np.asarray(jnet.rnn_time_step(x[:, s:s + c]))
        got = pnet.rnn_time_step(x[:, s:s + c]).numpy()
        np.testing.assert_allclose(got, want, **tol)
        np.testing.assert_allclose(got, full[:, s:s + c], **tol)
        s += c
    assert pnet._decode_state.pos == T


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_lstm_stepping_matches_jax_on_both_runtimes(runtime):
    jnet, pnet = pair(tgl_conf(), runtime)
    rng = np.random.default_rng(8)
    x = np.eye(11)[rng.integers(0, 11, (2, 7))]
    for lo, hi in ((0, 3), (3, 4), (4, 7)):
        np.testing.assert_allclose(
            pnet.rnn_time_step(x[:, lo:hi]).numpy(),
            np.asarray(jnet.rnn_time_step(x[:, lo:hi])), **TOL)


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_budget_refuses_a_step_past_the_cache_and_keeps_the_position(
        runtime):
    jnet, pnet = pair(tgt_conf("text_generation", T=6), runtime)
    x = np.zeros((2, 4, 1))
    pnet.rnn_time_step(x)
    with pytest.raises(ValueError, match="exceeds the smallest") as perr:
        pnet.rnn_time_step(x[:, :3])
    jnet.rnn_time_step(x)
    with pytest.raises(ValueError, match="exceeds the smallest") as jerr:
        jnet.rnn_time_step(x[:, :3])
    assert str(perr.value) == str(jerr.value)
    # the refused step burned no budget: two more tokens still fit
    assert pnet._decode_state.pos == 4
    assert tuple(pnet.rnn_time_step(x[:, :2]).shape) == (2, 2, 11)
    pnet.rnn_clear_previous_state()
    assert pnet._decode_state.pos == 0 and not pnet._decode_state.carries


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_a_ring_steps_past_its_length(runtime):
    """Rolling caches bound no length: 40 single steps through a ring of
    L 15 match JAX's."""
    jnet, pnet = pair(tgt_conf("ring", T=12), runtime)
    x = np.random.default_rng(9).integers(0, 11, (2, 40, 1)).astype(
        np.float64)
    for i in range(40):
        want = np.asarray(jnet.rnn_time_step(x[:, i:i + 1]))
        got = pnet.rnn_time_step(x[:, i:i + 1]).numpy()
        np.testing.assert_allclose(got, want, **ROPE_TOL)


def test_stepping_refuses_non_causal_attention_before_seeding():
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import RnnOutputLayer

    conf = (NeuralNetConfiguration.builder().list(
        MultiHeadAttention(n_out=8, num_heads=2, causal=True),
        MultiHeadAttention(n_out=8, num_heads=2, causal=False),
        RnnOutputLayer(n_out=3, activation="softmax"))
        .set_input_type(InputType.recurrent(8, 4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="non-causal"):
        net.rnn_time_step(np.zeros((1, 1, 8)))
    assert not net._decode_state.carries and net._decode_state.pos == 0


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_reorder_expands_with_drop_rows_and_gathers_in_place(runtime):
    """Tiling to beams builds caches with their drop row (the next step
    writes through it); a same-batch reorder gathers in place and equals
    JAX's gather."""
    jnet, pnet = pair(tgt_conf("text_generation", T=8), runtime)
    x = np.random.default_rng(10).integers(0, 11, (2, 3, 1)).astype(
        np.float64)
    jnet.rnn_time_step(x)
    pnet.rnn_time_step(x)
    for net in (jnet, pnet):
        net.rnn_reorder_state(np.array([0, 0, 1, 1]))
    caches = [c for c in jax.tree_util.tree_leaves(pnet._decode_state.carries)
              if c.ndim == 4]
    ptrs = [c.data_ptr() for c in caches]
    assert all(c.untyped_storage().nbytes() > c.nbytes for c in caches)
    for net in (jnet, pnet):
        net.rnn_reorder_state(np.array([3, 0, 2, 1]))
    after = [c for c in jax.tree_util.tree_leaves(pnet._decode_state.carries)
             if c.ndim == 4]
    assert [c.data_ptr() for c in after] == ptrs
    step = np.arange(4, dtype=np.float64).reshape(4, 1, 1)
    np.testing.assert_allclose(pnet.rnn_time_step(step).numpy(),
                               np.asarray(jnet.rnn_time_step(step)), **TOL)


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_graphed_stepping_equals_the_eager_calls(runtime):
    """The static-buffer path (`NetGraphs` on the CPU) and `cuda_graphs
    = False` give the same bits; the carries the graphed path keeps are
    its static buffers (no copy on the next call)."""
    _, a = pair(tgt_conf("modern_llm", T=8), runtime)
    _, b = pair(tgt_conf("modern_llm", T=8), runtime)
    b.cuda_graphs = False
    x = np.random.default_rng(11).integers(0, 11, (2, 8, 1)).astype(
        np.float64)
    for lo, hi in ((0, 4), (4, 5), (5, 6), (6, 7)):
        assert torch.equal(a.rnn_time_step(x[:, lo:hi]),
                           b.rnn_time_step(x[:, lo:hi]))
    pos = [v for k, v in jax.tree_util.tree_leaves_with_path(
        a._decode_state.carries) if "pos" in jax.tree_util.keystr(k)]
    static = a._graphs.inputs(a._graphs.last_key)[1]
    assert all(any(p is s for s in static) for p in pos)
    assert a._graphs.stats["rnn_time_step"]["eager"] == 4
