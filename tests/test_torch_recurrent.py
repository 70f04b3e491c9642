"""The recurrent slice of the PyTorch port against the JAX package, on
the CPU: every layer of `nn/layers/recurrent.py`, config JSON both ways,
training of the LSTM language model with Nesterovs and of
`TextGenerationLSTM` by truncated BPTT with Adam, `rnn_time_step` and
`generate`. Same seeded numpy inputs and the JAX weights carried across
with `params_from_numpy`. Where the JAX layer reaches its Pallas LSTM
kernels (`fused=True`), they run in interpret mode, as off a TPU they do;
the port runs its kernels' plain versions.

Tolerances: activations and carries within 1e-5; per-step losses within
1e-5 relative and parameters within 1e-5 absolute after the steps
(float32 sums in another order). Adam runs with ε 1e-3, as in
`test_torch_training.py`."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.config import (
    MultiLayerConfiguration as JaxConf, NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.optim.listeners import (
    CollectScoresIterationListener as JaxScores,
)
from deeplearning4j_tpu.optim.updaters import (
    Adam as JaxAdam, Nesterovs as JaxNesterovs,
)
from deeplearning4j_tpu.utils.textgen import generate as jax_generate
from deeplearning4j_tpu.zoo.models import TextGenerationLSTM as JaxTGL
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, updater_state_from_numpy,
)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import recurrent as prec
from deeplearning4j_tpu_torch.observe import get_registry
from deeplearning4j_tpu_torch.optim.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.utils.textgen import generate
from deeplearning4j_tpu_torch.zoo import ZOO_REGISTRY, TextGenerationLSTM

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=0, atol=1e-5)
B, T, F, H = 3, 6, 5, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree(port_tree, jax_tree, **tol):
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a: a.detach().numpy(), port_tree))
    want = jax.tree_util.tree_leaves(_np(jax_tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


# ----------------------------------------------------------------- layers
def _lstm(cls, **kw):
    return (cls, dict(n_in=F, n_out=H, activation="tanh", **kw))


LAYERS = {
    "lstm_kernel": _lstm("LSTM", fused=True),
    "lstm_scan": _lstm("LSTM"),
    "lstm_loop_asked": _lstm("LSTM", fused=False),
    "graves_kernel": _lstm("GravesLSTM", fused=True),
    "graves_scan": _lstm("GravesLSTM"),
    "lstm_hard_gates": _lstm("LSTM", gate_activation="hardsigmoid"),
    "graves_softsign": ("GravesLSTM", dict(n_in=F, n_out=H,
                                           activation="softsign")),
    "lstm_identity_cell": ("LSTM", dict(n_in=F, n_out=H)),
    "simple_rnn": _lstm("SimpleRnn"),
    "gru": _lstm("GRU"),
    "gru_reset_before": _lstm("GRU", reset_after=False),
    "gru_recurrent_bias": _lstm("GRU", recurrent_bias=True),
}
WRAPPERS = {
    "bidi_concat": dict(merge="concat"), "bidi_add": dict(merge="add"),
    "bidi_mul": dict(merge="mul"), "bidi_ave": dict(merge="ave"),
    "bidi_last": dict(merge="concat", return_sequences=False),
}


def _build(name):
    """(JAX layer, port layer) of one case."""
    if name in LAYERS:
        cls, kw = LAYERS[name]
        return getattr(jrec, cls)(**kw), getattr(prec, cls)(**kw)
    if name in WRAPPERS:
        kw = dict(n_in=F, n_out=H, activation="tanh", fused=True)
        return (jrec.Bidirectional(layer=jrec.GravesLSTM(**kw),
                                   **WRAPPERS[name]),
                prec.Bidirectional(layer=prec.GravesLSTM(**kw),
                                   **WRAPPERS[name]))
    if name == "graves_bidirectional":
        kw = dict(n_in=F, n_out=H, activation="tanh")
        return (jrec.GravesBidirectionalLSTM(**kw),
                prec.GravesBidirectionalLSTM(**kw))
    assert name == "last_time_step"
    kw = dict(n_in=F, n_out=H, activation="tanh")
    return (jrec.LastTimeStep(layer=jrec.GRU(**kw)),
            prec.LastTimeStep(layer=prec.GRU(**kw)))


def _random_params(jlayer, seed):
    """The JAX layer's own parameter tree with every leaf (zero biases
    and peepholes too) redrawn from a numpy seed."""
    tree, _ = jlayer.init_params(jax.random.PRNGKey(0),
                                 JaxInputType.recurrent(F), jnp.float32)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.4 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


ALL_LAYERS = list(LAYERS) + list(WRAPPERS) + ["graves_bidirectional",
                                              "last_time_step"]


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("name", ALL_LAYERS)
def test_layer_matches_jax(name, masked):
    jlayer, player = _build(name)
    params = _random_params(jlayer, len(name))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(T)[None, :] < np.array([T, 2, 4])[:, None]
                ).astype(np.float32)
    jy, jst = jlayer.apply(params, jnp.asarray(x),
                           mask=None if mask is None else jnp.asarray(mask))
    py, pst = player.apply(_to_torch(params), torch.from_numpy(x),
                           mask=None if mask is None
                           else torch.from_numpy(mask))
    assert tuple(py.shape) == tuple(jy.shape)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    if jst:
        _assert_tree(pst, jst, **TOL)
    jt = jlayer.output_type(JaxInputType.recurrent(F, T))
    pt = player.output_type(InputType.recurrent(F, T))
    assert (pt.kind, pt.size, pt.timesteps) == (jt.kind, jt.size,
                                                jt.timesteps)


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_with_a_passed_in_state_matches_jax(name):
    jlayer, player = _build(name)
    params = _random_params(jlayer, 3 + len(name))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    state = {k: (0.5 * rng.standard_normal((B, H))).astype(np.float32)
             for k in jlayer.initial_carry(B)}
    jy, jst = jlayer.apply(params, jnp.asarray(x),
                           state={k: jnp.asarray(v) for k, v in state.items()})
    py, pst = player.apply(_to_torch(params), torch.from_numpy(x),
                           state=_to_torch(state))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    _assert_tree(pst, jst, **TOL)
    # two half-length calls handing the state on equal the full call
    half, st = [], _to_torch(state)
    for lo in (0, T // 2):
        y, st = player.apply(_to_torch(params),
                             torch.from_numpy(x[:, lo:lo + T // 2]), state=st)
        half.append(y)
    np.testing.assert_allclose(torch.cat(half, dim=1).numpy(), py.numpy(),
                               **TOL)


@pytest.mark.parametrize("name,impl", [
    ("lstm_kernel", "plain"), ("graves_scan", "plain"),
    ("lstm_loop_asked", "loop"), ("lstm_hard_gates", "loop"),
    ("lstm_identity_cell", "loop")])
def test_lstm_layer_dispatch_is_counted(name, impl):
    _, player = _build(name)
    params, _ = player.init_params(torch.Generator().manual_seed(0),
                                   InputType.recurrent(F))
    counter = get_registry().counter("kernel_dispatch_total", op="lstm",
                                     impl=impl)
    before = counter.value
    player.apply(params, torch.zeros(B, T, F))
    assert counter.value == before + 1


def test_init_params_shapes_and_forget_gate_bias():
    layer = prec.GravesLSTM(n_in=F, n_out=H, activation="tanh",
                            weight_init="xavier", forget_gate_bias_init=2.5)
    params, state = layer.init_params(torch.Generator().manual_seed(1),
                                      InputType.recurrent(F))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "W": (F, 4 * H), "RW": (H, 4 * H), "b": (4 * H,), "P": (3, H)}
    assert state == {}
    b = params["b"]
    assert torch.all(b[H:2 * H] == 2.5)
    assert torch.all(b[:H] == 0) and torch.all(b[2 * H:] == 0)
    assert torch.all(params["P"] == 0)
    bidi = prec.Bidirectional(layer=layer)
    nested, _ = bidi.init_params(torch.Generator().manual_seed(1),
                                 InputType.recurrent(F))
    assert set(nested) == {"fwd", "bwd"}
    assert not torch.equal(nested["fwd"]["W"], nested["bwd"]["W"])


def test_fused_true_with_other_activations_is_an_error():
    layer = prec.LSTM(n_in=F, n_out=H, activation="relu", fused=True)
    params, _ = layer.init_params(torch.Generator().manual_seed(0),
                                  InputType.recurrent(F))
    with pytest.raises(ValueError, match="fused=True requires"):
        layer.apply(params, torch.zeros(B, T, F))


# ------------------------------------------------------------ the models
def _bench_conf(updater, h=16, fused=True):
    """The LSTM bench model (GravesLSTM x 2 + RnnOutputLayer), narrow."""
    return (JaxNNC.builder().seed(0).updater(updater).activation("tanh")
            .list(jrec.GravesLSTM(n_out=h, fused=fused),
                  jrec.GravesLSTM(n_out=h, fused=fused),
                  jrec.RnnOutputLayer(n_out=5, activation="softmax"))
            .set_input_type(JaxInputType.recurrent(7)).build())


def _pair(jconf):
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    return jnet, pnet


def _seq_batch(rng, b, t, f, c, masked):
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, (b, t))]
    fm = None
    if masked:
        lens = rng.integers(t // 4, t, b)
        fm = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return x, y, fm


def _onehot_batch(rng, b, t, vocab):
    ids = rng.integers(0, vocab, (b, t + 1))
    eye = np.eye(vocab, dtype=np.float32)
    return eye[ids[:, :t]], eye[ids[:, 1:]]


def _tgl(t=24, tbptt=(8, None), **kw):
    import dataclasses

    jconf = JaxTGL(input_shape=(t, 11), num_classes=11,
                   updater=JaxAdam(learning_rate=1e-2, epsilon=1e-3),
                   **kw).conf()
    layers = tuple(dataclasses.replace(l, n_out=12, n_in=None if i == 0
                                       else 12) if i < 2 else
                   dataclasses.replace(l, n_in=12)
                   for i, l in enumerate(jconf.layers))
    layers = (dataclasses.replace(layers[0], n_in=11, fused=True),
              dataclasses.replace(layers[1], fused=True), layers[2])
    fwd, back = tbptt
    return dataclasses.replace(jconf, layers=layers, tbptt_fwd_length=fwd,
                               tbptt_back_length=back or fwd)


def test_config_json_both_ways():
    for jconf in (_bench_conf(JaxNesterovs(0.01, 0.9), h=512, fused=None),
                  JaxTGL().conf()):
        pconf = MultiLayerConfiguration.from_json(jconf.to_json())
        assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
        assert JaxConf.from_json(pconf.to_json()) == jconf
        assert [type(l).__name__ for l in pconf.layers] == \
            [type(l).__name__ for l in jconf.layers]
    assert pconf.tbptt_fwd_length == 50 and pconf.tbptt_back_length == 50
    assert pconf.layers[0].fused is None
    # the port's own zoo model builds the same configuration
    assert ZOO_REGISTRY["textgenerationlstm"] is TextGenerationLSTM
    own = TextGenerationLSTM().conf()
    assert json.loads(own.to_json()) == json.loads(jconf.to_json())
    assert own.updater == Adam(1e-3)
    bench = MultiLayerConfiguration.from_json(
        _bench_conf(JaxNesterovs(0.01, 0.9)).to_json())
    assert bench.updater == Nesterovs(0.01, 0.9)
    assert bench.layers[0].peephole and bench.layers[0].fused is True


def test_three_nesterovs_steps_of_the_lstm_model_match_jax():
    """The `path_l` model, narrow: GravesLSTM x 2 through the LSTM
    kernels (Pallas in interpret mode against the plain versions) and
    Nesterovs through B1b's plain version; batch 2 of 3 is masked."""
    jnet, pnet = _pair(_bench_conf(JaxNesterovs(0.01, 0.9)))
    rng = np.random.default_rng(11)
    batches = [_seq_batch(rng, 4, 12, 7, 5, masked=i == 1) for i in range(3)]
    js, ps = JaxScores(), CollectScoresIterationListener()
    jnet.listeners.append(js)
    pnet.listeners.append(ps)
    jnet.fit([JaxDataSet(x, y, fm, None) for x, y, fm in batches])
    pnet.fit([DataSet(x, y, fm, None) for x, y, fm in batches])
    assert len(ps.scores) == 3 and pnet.iteration == 3
    np.testing.assert_allclose([s for _, s in ps.scores],
                               [s for _, s in js.scores], **LOSS_TOL)
    _assert_tree(pnet.params_tree, jnet.params_tree, **PARAM_TOL)
    _assert_tree({n: s["v"] for n, s in pnet.updater_state.items()},
                 {n: s["v"] for n, s in jnet.updater_state.items()},
                 **PARAM_TOL)
    x, y, _ = batches[0]
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)


@pytest.mark.parametrize("tbptt", [(8, None), (8, 4), (10, None)],
                         ids=["fwd8", "fwd8_back4", "fwd10_ragged"])
def test_tbptt_fit_of_the_zoo_lstm_matches_jax(tbptt):
    """Two batches of `TextGenerationLSTM` (narrow, T 24) by truncated
    BPTT with Adam: every chunk of a batch is one optimizer step at the
    SAME step count (the iteration advances once a batch), which Adam's
    bias correction shows from the second chunk on."""
    jnet, pnet = _pair(_tgl(tbptt=tbptt))
    rng = np.random.default_rng(12)
    batches = [_onehot_batch(rng, 3, 24, 11) for _ in range(2)]
    js, ps = JaxScores(), CollectScoresIterationListener()
    jnet.listeners.append(js)
    pnet.listeners.append(ps)
    jnet.fit([JaxDataSet(x, y) for x, y in batches])
    pnet.fit([DataSet(x, y) for x, y in batches])
    assert pnet.iteration == jnet.iteration == 2
    assert int(pnet._step_t) == 2
    np.testing.assert_allclose([s for _, s in ps.scores],
                               [s for _, s in js.scores], **LOSS_TOL)
    _assert_tree(pnet.params_tree, jnet.params_tree, **PARAM_TOL)
    _assert_tree(pnet.updater_state, jnet.updater_state, rtol=1e-4,
                 atol=1e-6)


def test_tbptt_needs_per_timestep_labels():
    _, pnet = _pair(_tgl())
    x, _ = _onehot_batch(np.random.default_rng(13), 2, 24, 11)
    with pytest.raises(ValueError, match="per-timestep"):
        pnet.fit([DataSet(x, np.zeros((2, 11), np.float32))])


def test_updater_state_from_numpy_takes_nesterovs_and_nested_trees():
    jconf = (JaxNNC.builder().seed(1).updater(JaxNesterovs(0.05, 0.8))
             .activation("tanh")
             .list(jrec.Bidirectional(layer=jrec.LSTM(n_out=6)),
                   jrec.RnnOutputLayer(n_out=4, activation="softmax"))
             .set_input_type(JaxInputType.recurrent(5)).build())
    jnet, pnet = _pair(jconf)
    rng = np.random.default_rng(14)
    x, y, _ = _seq_batch(rng, 3, 6, 5, 4, masked=False)
    jnet.fit([JaxDataSet(x, y)])
    assert set(pnet.params_tree["layer0_bidirectional"]) == {"fwd", "bwd"}
    params_from_numpy(pnet, _np(jnet.params_tree))
    updater_state_from_numpy(pnet, _np(jnet.updater_state))
    pnet.iteration = jnet.iteration
    _assert_tree(pnet.updater_state, jnet.updater_state, rtol=0, atol=0)
    jnet.fit([JaxDataSet(x, y)])
    pnet.fit([DataSet(x, y)])
    np.testing.assert_allclose(pnet.score_, jnet.score_, **LOSS_TOL)
    _assert_tree(pnet.params_tree, jnet.params_tree, **PARAM_TOL)
    bad = _np(jnet.params_tree)
    del bad["layer0_bidirectional"]["bwd"]["RW"]
    with pytest.raises(KeyError):
        params_from_numpy(pnet, bad)


# ---------------------------------------------------- stepping, generate
def test_rnn_time_step_matches_jax_then_clear_and_reorder():
    jnet, pnet = _pair(_bench_conf(JaxNesterovs(0.01, 0.9)))
    rng = np.random.default_rng(15)
    xs = rng.standard_normal((10, 4, 7)).astype(np.float32)
    outs = []
    for i, x in enumerate(xs):
        # a 2-D input is one step; every third call feeds two steps
        feed = x if i % 3 else np.stack([x, x[::-1]], axis=1)
        got = pnet.rnn_time_step(feed)
        want = np.asarray(jnet.rnn_time_step(feed))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        outs.append(got)
    _assert_tree(pnet._decode_state.carries, jnet._decode_state.carries,
                 **TOL)
    # stepping T steps one at a time equals output() over the sequence
    pnet.rnn_clear_previous_state()
    assert pnet._decode_state.carries == {}
    seq = np.transpose(xs[:6], (1, 0, 2))
    stepped = torch.cat([pnet.rnn_time_step(seq[:, t]) for t in range(6)],
                        dim=1)
    np.testing.assert_allclose(stepped.numpy(), pnet.output(seq).numpy(),
                               **TOL)
    # reorder: row i of the carries becomes row idx[i], on both sides
    idx = [2, 0, 0, 3, 1]
    jnet.rnn_clear_previous_state()
    for t in range(3):
        jnet.rnn_time_step(seq[:, t])
    pnet.rnn_clear_previous_state()
    for t in range(3):
        pnet.rnn_time_step(seq[:, t])
    pnet.rnn_reorder_state(idx)
    jnet.rnn_reorder_state(idx)
    _assert_tree(pnet._decode_state.carries, jnet._decode_state.carries,
                 **TOL)
    nxt = seq[idx, 3]
    np.testing.assert_allclose(pnet.rnn_time_step(nxt).numpy(),
                               np.asarray(jnet.rnn_time_step(nxt)), **TOL)


def test_rnn_time_step_keeps_its_carries_when_a_step_fails():
    _, pnet = _pair(_bench_conf(JaxNesterovs(0.01, 0.9)))
    x = np.random.default_rng(16).standard_normal((2, 7)).astype(np.float32)
    pnet.rnn_time_step(x)
    before = {n: {k: v.clone() for k, v in c.items()}
              for n, c in pnet._decode_state.carries.items()}
    with pytest.raises(ValueError, match="does not match configured"):
        pnet.rnn_time_step(np.zeros((2, 9), np.float32))
    with pytest.raises(ValueError, match="h0 is"):
        pnet.rnn_time_step(np.zeros((3, 7), np.float32))    # batch changed
    for n, c in pnet._decode_state.carries.items():
        for k, v in c.items():
            assert torch.equal(v, before[n][k])


def test_output_and_rnn_time_step_check_the_input_width():
    jnet, pnet = _pair(_bench_conf(JaxNesterovs(0.01, 0.9)))
    bad = np.zeros((2, 6, 9), np.float32)
    with pytest.raises(ValueError) as jerr:
        jnet.output(bad)
    with pytest.raises(ValueError) as perr:
        pnet.output(bad)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="does not match configured"):
        pnet.rnn_time_step(bad)
    # a configured sequence length binds output() but not stepping
    _, fixed = _pair(_tgl())
    x, _ = _onehot_batch(np.random.default_rng(17), 2, 24, 11)
    with pytest.raises(ValueError, match="does not match configured"):
        fixed.output(x[:, :7])
    assert tuple(fixed.rnn_time_step(x[:, :7]).shape) == (2, 7, 11)


def test_rnn_time_step_refuses_attention_stacks():
    """Attention stacks step (once refused naming A4) through lockstep
    KV caches: token by token equals the full forward; a step past the
    cache is refused before it runs."""
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    net = TextGenerationTransformer(input_shape=(8, 1), d_model=16,
                                    num_heads=2, num_blocks=1
                                    ).init(device="cpu")
    x = np.random.default_rng(19).integers(0, 256, (2, 8, 1)).astype(
        np.float32)
    stepped = torch.cat([net.rnn_time_step(x[:, i:i + 1])
                         for i in range(8)], dim=1)
    torch.testing.assert_close(stepped, net.output(x), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="exceeds the smallest"):
        net.rnn_time_step(x[:, :1])


@pytest.mark.parametrize("chunk", [None, 3])
def test_generate_greedy_matches_jax_token_for_token(chunk):
    jnet, pnet = _pair(_tgl())
    # a few steps of training so the argmax is not a tie of near-uniforms
    rng = np.random.default_rng(18)
    batches = [_onehot_batch(rng, 3, 24, 11) for _ in range(2)]
    jnet.fit([JaxDataSet(x, y) for x, y in batches], epochs=2)
    params_from_numpy(pnet, _np(jnet.params_tree))
    prompt = rng.integers(0, 11, (3, 7))
    want = jax_generate(jnet, prompt, 12, greedy=True, prefill_chunk=chunk)
    got = generate(pnet, prompt, 12, greedy=True, prefill_chunk=chunk)
    assert got.shape == (3, 12) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    pen = generate(pnet, prompt, 12, greedy=True, repetition_penalty=1.5)
    np.testing.assert_array_equal(
        pen, jax_generate(jnet, prompt, 12, greedy=True,
                          repetition_penalty=1.5))


def test_generate_sampling_is_seeded_and_in_vocabulary():
    _, pnet = _pair(_tgl())
    prompt = np.array([1, 2, 3])
    a = generate(pnet, prompt, 20, temperature=0.9, top_k=5, top_p=0.9,
                 seed=4)
    b = generate(pnet, prompt, 20, temperature=0.9, top_k=5, top_p=0.9,
                 seed=4)
    c = generate(pnet, prompt, 20, temperature=0.9, top_k=5, top_p=0.9,
                 seed=5)
    assert a.shape == (1, 20) and a.min() >= 0 and a.max() < 11
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError, match="repetition_penalty"):
        generate(pnet, prompt, 2, repetition_penalty=0.5)
    with pytest.raises(ValueError, match="top_k"):
        generate(pnet, prompt, 2, top_k=0)
