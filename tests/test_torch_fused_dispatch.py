"""K steps a dispatch in the PyTorch port, on the CPU, against the JAX
package: `fit(steps_per_dispatch=K)` on both runtimes (the executor's
fused buffer, its drain of a short tail or a shape change, tBPTT per
step), the prefetch iterator's depth and counters, and the static-buffer
discipline of `utils/cuda_graphs.NetGraphs` that carries the CUDA graphs
on the card: here it fills the same static buffers and calls the
function on them directly, so an output that aliased a buffer would show.

Tolerances, float32, as `test_torch_training.py`: losses within 1e-5
relative; parameters and running statistics within 1e-5 absolute under
Sgd and within 2e-5 under Adam (float32 sums in another order, amplified
by Adam's division by √v; ε 1e-3 as there). The port at K 4 against the
port at K 1, and the graphed stepping and decode windows against the
eager ones: bit for bit."""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
import deeplearning4j_tpu.nn.layers as jlayers
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.optim.listeners import (
    CollectScoresIterationListener as JaxScores,
)
from deeplearning4j_tpu.optim.updaters import (
    Adam as JaxAdam, Nesterovs as JaxNesterovs, Sgd as JaxSgd,
)
from deeplearning4j_tpu.zoo import models as jax_zoo
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.data.iterators import DevicePrefetchIterator
from deeplearning4j_tpu_torch.models import (
    ComputationGraph, MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, state_from_numpy,
)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.observe import get_registry
from deeplearning4j_tpu_torch.optim.executor import batch_signature
from deeplearning4j_tpu_torch.optim.listeners import (
    CollectScoresIterationListener, TrainingListener,
)
from deeplearning4j_tpu_torch.optim.updaters import tree_leaves
from deeplearning4j_tpu_torch.utils.cuda_graphs import NetGraphs

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
SGD_TOL = dict(rtol=0, atol=1e-5)
ADAM_TOL = dict(rtol=0, atol=2e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(port_tree, jax_tree, path="", **tol):
    if isinstance(port_tree, dict):
        assert set(port_tree) == set(jax_tree), path
        for k, v in port_tree.items():
            _assert_trees(v, jax_tree[k], f"{path}/{k}", **tol)
    elif isinstance(port_tree, tuple):
        assert port_tree == () and len(jax_tree) == 0, path
    else:
        np.testing.assert_allclose(port_tree.detach().float().numpy(),
                                   np.asarray(jax_tree), **tol, err_msg=path)


def _assert_equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ------------------------------------------------------------ the models
def _mlp_conf(updater=None):
    return (JaxNNC.builder().seed(1).updater(updater or JaxSgd(0.1))
            .list(jlayers.DenseLayer(n_out=32, activation="relu"),
                  jlayers.OutputLayer(n_out=4, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(16)).build())


def _lenet_conf():
    return jax_zoo.LeNet(updater=JaxSgd(0.05)).conf()


def _tgt_conf():
    return JaxTGT(input_shape=(8, 1), d_model=16, num_heads=4, num_blocks=1,
                  updater=JaxAdam(1e-2, epsilon=1e-3)).conf()


def _graph_conf():
    """in -> conv 3x3 -> batch norm -> global pool -> output."""
    g = (JaxNNC.builder().seed(5).updater(JaxNesterovs(0.05, 0.9))
         .graph_builder().add_inputs("in")
         .set_input_types(JaxInputType.convolutional(8, 8, 3)))
    g.add_layer("c", jlayers.ConvolutionLayer(
        n_out=6, kernel=(3, 3), convolution_mode="same",
        activation="identity"), "in")
    g.add_layer("b", jlayers.BatchNormalization(activation="relu"), "c")
    g.add_layer("gap", jlayers.GlobalPoolingLayer(pooling="avg"), "b")
    g.add_layer("output", jlayers.OutputLayer(n_out=3, activation="softmax"),
                "gap")
    g.set_outputs("output")
    return g.build()


def _batches(name, n, seed=0):
    rng = np.random.default_rng(seed)
    if name == "mlp":
        x = rng.standard_normal((n * 8, 16)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n * 8)]
    elif name == "lenet":
        x = rng.random((n * 4, 784), dtype=np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n * 4)]
    elif name == "tgt":
        toks = rng.integers(0, 256, (n * 2, 9))
        x = toks[:, :8, None].astype(np.float32)
        y = np.eye(256, dtype=np.float32)[toks[:, 1:]]
    else:
        x = rng.standard_normal((n * 4, 8, 8, 3)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n * 4)]
    b = x.shape[0] // n
    return [(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]) for i in range(n)]


MODELS = {"mlp": (_mlp_conf, SGD_TOL), "lenet": (_lenet_conf, SGD_TOL),
          "tgt": (_tgt_conf, ADAM_TOL), "graph": (_graph_conf, SGD_TOL)}


def _port(name, jnet):
    if name == "graph":
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            jnet.conf.to_json()), device="cpu").init()
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(net, _np(jnet.params_tree))
    state_from_numpy(net, _np(jnet.state_tree))
    return net


def _jax(name):
    conf = MODELS[name][0]()
    return (JaxGraph if name == "graph" else JaxNet)(conf).init()


def _fit(net, batches, k, epochs=1, jax_side=False):
    scores = (JaxScores if jax_side else CollectScoresIterationListener)()
    cls = JaxDataSet if jax_side else DataSet
    if jax_side:
        net.set_listeners(scores)
    else:
        net.listeners.append(scores)
    net.fit([cls(x, y) for x, y in batches], epochs=epochs,
            steps_per_dispatch=k)
    return [s for _, s in scores.scores]


# -------------------------------------------------- fit against JAX's fit
@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_at_k4_matches_jax_at_k4(name):
    """8 batches, K 4: two fused windows on both sides."""
    jnet = _jax(name)
    net = _port(name, jnet)
    batches = _batches(name, 8)
    want = _fit(jnet, batches, 4, jax_side=True)
    got = _fit(net, batches, 4)
    tol = MODELS[name][1]
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    _assert_trees(net.params_tree, _np(jnet.params_tree), **tol)
    _assert_trees(net.state_tree, _np(jnet.state_tree), **tol)
    assert net.iteration == jnet.iteration == 8
    assert net._graphs.stats["fit"]["eager"] == 2


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_at_k4_equals_k1_bit_for_bit(name):
    """Same weights, same batches (6: one window and a drained tail of
    2): parameters, optimizer state, running statistics and every loss
    equal."""
    jnet = _jax(name)
    a, b = _port(name, jnet), _port(name, jnet)
    batches = _batches(name, 6, seed=3)
    la = _fit(a, batches, 1, epochs=2)
    lb = _fit(b, batches, 4, epochs=2)
    assert la == lb
    for t in ("params_tree", "updater_state", "state_tree"):
        _assert_equal_trees(getattr(a, t), getattr(b, t))
    assert a.fit_stats == {"graph_windows": 0, "eager_steps": 12}
    # on the CPU every window runs eagerly: 2 windows and 4 single steps
    assert b.fit_stats == {"graph_windows": 0, "eager_steps": 12}
    assert b._graphs.stats["fit"]["eager"] == 2


def test_dropout_and_batch_norm_at_k4_equal_k1():
    """SimpleCNN (batch norm, dropout 0.5): dropout draws from the net's
    generator in the same order, and the running statistics are copied
    into the stored tensors in place, at K 4 as at K 1."""
    from deeplearning4j_tpu_torch.zoo import models as zoo

    conf = zoo.SimpleCNN(input_shape=(16, 16, 3), num_classes=5).conf()
    a = MultiLayerNetwork(conf, device="cpu").init()
    b = MultiLayerNetwork(conf, device="cpu").init()
    state_ids = [id(t) for t in tree_leaves(b.state_tree)]
    rng = np.random.default_rng(2)
    x = rng.random((16, 16, 16, 3), dtype=np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)]
    batches = [(x[i:i + 4], y[i:i + 4]) for i in range(0, 16, 4)]
    assert _fit(a, batches, 1) == _fit(b, batches, 4)
    _assert_equal_trees(a.params_tree, b.params_tree)
    _assert_equal_trees(a.state_tree, b.state_tree)
    assert [id(t) for t in tree_leaves(b.state_tree)] == state_ids
    assert any(not torch.all(t == 0) for t in tree_leaves(b.state_tree))


# ------------------------------------ the executor's cases (JAX's tests)
def _mlp_pair():
    jnet = JaxNet(_mlp_conf()).init()
    return _port("mlp", jnet), _port("mlp", jnet)


def test_partial_buffer_drains_as_single_steps():
    a, b = _mlp_pair()
    batches = _batches("mlp", 6)
    assert _fit(a, batches, 4) == _fit(b, batches, 1)
    assert a.iteration == b.iteration == 6
    assert a._graphs.stats["fit"]["eager"] == 1
    _assert_equal_trees(a.params_tree, b.params_tree)


def test_shape_change_flushes_the_buffer():
    """Batches of 24, 24, 24 and 8: the fourth's shape drains the three
    buffered ones, and the last drains at the epoch's end."""
    a, b = _mlp_pair()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((80, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 80)]
    a.fit(x, y, batch_size=24, steps_per_dispatch=4)
    b.fit(x, y, batch_size=24)
    assert a.iteration == b.iteration == 4
    assert "fit" not in a._graphs.stats
    _assert_equal_trees(a.params_tree, b.params_tree)


def test_signature_covers_shapes_dtypes_and_masks():
    x = torch.zeros(4, 3)
    y = torch.zeros(4, 2)
    assert batch_signature(DataSet(x, y)) == batch_signature(
        DataSet(x.clone(), y.clone()))
    assert batch_signature(DataSet(x, y)) != batch_signature(
        DataSet(x[:2], y[:2]))
    assert batch_signature(DataSet(x, y)) != batch_signature(
        DataSet(x.double(), y))
    assert batch_signature(DataSet(x, y)) != batch_signature(
        DataSet(x, y, None, torch.ones(4)))


def test_tbptt_runs_per_step():
    conf = (JaxNNC.builder().seed(1).updater(JaxSgd(0.1))
            .list(jrec.LSTM(n_out=7), jrec.RnnOutputLayer(
                n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(5)).tbptt(4).build())
    jnet = JaxNet(conf).init()
    net = _port("lstm", jnet)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 8, 5)).astype(np.float32)
    y = np.zeros((8, 8, 2), np.float32)
    y[..., 0] = 1.0
    jnet.fit(x, y, epochs=1, batch_size=4, steps_per_dispatch=4)
    net.fit(x, y, epochs=1, batch_size=4, steps_per_dispatch=4)
    assert net.iteration == jnet.iteration == 2
    assert "fit" not in net._graphs.stats
    assert net.fit_stats["eager_steps"] == 2
    np.testing.assert_allclose(net.score_, float(jnet.score_), **LOSS_TOL)
    _assert_trees(net.params_tree, _np(jnet.params_tree), **SGD_TOL)


def test_iteration_and_epoch_counts():
    a, b = _mlp_pair()
    batches = _batches("mlp", 8)
    _fit(a, batches, 4, epochs=2)
    _fit(b, batches, 1, epochs=2)
    assert (a.iteration, a.epoch) == (b.iteration, b.epoch) == (16, 2)
    assert a._graphs.stats["fit"]["eager"] == 4
    assert int(a._step_t) == int(b._step_t) == 16


def test_listener_losses_of_window_1_survive_window_3():
    """The device losses a listener keeps are the (K,) output's slices,
    cloned before they left the call: window 1's still read window 1's
    values after window 3."""

    class Keep(TrainingListener):
        def __init__(self):
            self.kept = []

        def iteration_done(self, model, iteration, epoch, score):
            self.kept.append(score)

    a, b = _mlp_pair()
    keep = Keep()
    a.listeners.append(keep)
    batches = _batches("mlp", 12)
    _fit(a, batches, 4)
    want = _fit(b, batches, 1)
    assert all(isinstance(t, torch.Tensor) for t in keep.kept)
    assert [float(t) for t in keep.kept] == want


def test_second_fit_carries_on_from_the_counter_in_place():
    """A second fit fills the step counter in place (a graph captured
    in the first reads the live one) and goes on where the first
    stopped: Adam's bias correction sees steps 4-7."""
    jnet = JaxNet(_mlp_conf(JaxAdam(1e-2, epsilon=1e-3))).init()
    a, b = _port("mlp", jnet), _port("mlp", jnet)
    batches = _batches("mlp", 8)
    _fit(a, batches[:4], 4)
    counter = a._step_t
    _fit(a, batches[4:], 4)
    assert a._step_t is counter and int(counter) == 8
    _fit(b, batches, 1)
    _assert_equal_trees(a.params_tree, b.params_tree)
    _assert_equal_trees(a.updater_state, b.updater_state)


def test_graphs_off_runs_the_same_steps():
    a, b = _mlp_pair()
    b.cuda_graphs = False
    batches = _batches("mlp", 8)
    assert _fit(a, batches, 4) == _fit(b, batches, 4)
    _assert_equal_trees(a.params_tree, b.params_tree)
    assert "fit" not in b._graphs.stats


# ------------------------------------------------------------- prefetch
def test_prefetch_runs_depth_batches_ahead_and_counts():
    x = np.arange(48, dtype=np.float32).reshape(12, 4)
    y = np.zeros((12, 2), np.float32)
    puts = []

    def put(ds):
        puts.append(ds)
        return ds

    reg = get_registry()
    hits = reg.counter("prefetch_hits_total", stage="device")
    misses = reg.counter("prefetch_misses_total", stage="device")
    batches = reg.counter("etl_batches_total", stage="device")
    h0, m0, b0 = hits.value, misses.value, batches.value
    it = DevicePrefetchIterator(ArrayDataSetIterator(x, y, 2), put, depth=3,
                                device="cpu")
    first = next(iter(it))
    np.testing.assert_array_equal(first.features, x[:2])
    assert len(puts) == 4          # 3 in flight, then 1 refilled
    rest = []
    while True:                     # list(it) would reset it
        try:
            rest.append(next(it))
        except StopIteration:
            break
    assert len(rest) == 5 and len(puts) == 6
    np.testing.assert_array_equal(rest[-1].features, x[10:])
    assert (hits.value - h0, misses.value - m0,
            batches.value - b0) == (5, 1, 6)


@pytest.mark.parametrize("k,depth", [(1, 2), (4, 4), (8, 8)])
def test_fit_prefetches_max_2_k_batches(monkeypatch, k, depth):
    import deeplearning4j_tpu_torch.models.multilayer as ml

    seen = []
    real = ml.DevicePrefetchIterator

    def spy(base, put, depth=2, device=None):
        seen.append(depth)
        return real(base, put, depth=depth, device=device)

    monkeypatch.setattr(ml, "DevicePrefetchIterator", spy)
    net, _ = _mlp_pair()
    _fit(net, _batches("mlp", 4), k)
    assert seen == [depth]
    seen.clear()
    net.fit([DataSet(x, y) for x, y in _batches("mlp", 4)],
            steps_per_dispatch=k, device_prefetch=False)
    assert seen == [] and net.iteration == 8


# --------------------------------------------- the static-buffer helper
def test_outputs_are_cloned_off_the_static_buffers():
    """A function that returns its own static input: the output of call
    1 must keep call 1's values after call 2 refills the buffer."""
    g = NetGraphs("cpu")
    one = g.run(("id",), lambda t: t, (torch.ones(3),))
    two = g.run(("id",), lambda t: t, (torch.full((3,), 2.0),))
    assert torch.equal(one, torch.ones(3))
    assert torch.equal(two, torch.full((3,), 2.0))
    assert g.stats["id"]["eager"] == 2


def test_lists_are_stacked_and_new_addresses_drop_the_entry():
    g = NetGraphs("cpu")
    xs = [torch.full((2,), float(i)) for i in range(3)]
    out = g.run(("sum",), lambda s: s.sum(0), (xs,), addresses=(1,))
    assert torch.equal(out, torch.full((2,), 3.0))
    static = g.inputs(g.last_key)[0]
    assert static.shape == (3, 2)
    g.run(("sum",), lambda s: s.sum(0), (xs,), addresses=(1,))
    assert g.inputs(g.last_key)[0] is static
    g.run(("sum",), lambda s: s.sum(0), (xs,), addresses=(2,))
    assert g.inputs(g.last_key)[0] is not static


# ---------------------------------------- rnn_time_step and the windows
def _lstm_pair():
    conf = (JaxNNC.builder().seed(0).updater(JaxNesterovs(0.01, 0.9))
            .activation("tanh")
            .list(jrec.GravesLSTM(n_out=12, fused=True),
                  jrec.GravesLSTM(n_out=12, fused=True),
                  jrec.RnnOutputLayer(n_out=5, activation="softmax"))
            .set_input_type(JaxInputType.recurrent(7)).build())
    jnet = JaxNet(conf).init()
    return jnet, _port("lstm", jnet)


def test_rnn_time_step_through_static_buffers_matches_jax_and_eager():
    jnet, pnet = _lstm_pair()
    eager = _port("lstm", jnet)
    eager.cuda_graphs = False
    rng = np.random.default_rng(15)
    xs = rng.standard_normal((8, 4, 7)).astype(np.float32)
    kept = []
    for i, x in enumerate(xs):
        feed = x if i % 3 else np.stack([x, x[::-1]], axis=1)
        got = pnet.rnn_time_step(feed)
        kept.append((got, eager.rnn_time_step(feed)))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jnet.rnn_time_step(feed)),
                                   rtol=1e-5, atol=1e-5)
    # outputs kept from early calls still hold their own values
    for got, want in kept:
        assert torch.equal(got, want)
    # the carries live in the carry-key graph's static buffers (one a
    # carry leaf: the h and c of each layer)
    static = pnet._graphs.inputs(pnet._graphs.last_key)[1]

    def in_static():
        leaves = jax.tree_util.tree_leaves(pnet._decode_state.carries)
        return len(leaves) == len(static) == 4 and all(
            any(a is b for b in static) for a in leaves)

    assert in_static()
    # reorder gathers in place; clear drops to the no-carry graph
    idx = [2, 0, 0, 3]
    for net in (pnet, eager):
        net.rnn_reorder_state(idx)
    jnet.rnn_reorder_state(idx)
    assert in_static()
    nxt = xs[0][idx]
    got = pnet.rnn_time_step(nxt)
    assert torch.equal(got, eager.rnn_time_step(nxt))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jnet.rnn_time_step(nxt)),
                               rtol=1e-5, atol=1e-5)
    pnet.rnn_clear_previous_state()
    eager.rnn_clear_previous_state()
    assert torch.equal(pnet.rnn_time_step(xs[1]), eager.rnn_time_step(xs[1]))
    assert pnet._graphs.last_key[1] is False


def _window_nets():
    jconf = JaxTGT(input_shape=(32, 1), d_model=32, num_heads=4,
                   num_blocks=2).conf()
    jnet = JaxNet(jconf).init()
    nets = []
    for graphs in (True, False):
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
        params_from_numpy(net, _np(jnet.params_tree))
        net.cuda_graphs = graphs
        nets.append(net)
    return jnet, nets


def _decode(net, prompts, k, n, eos=-1, jax_side=False):
    """Prefill each prompt's stem in one padded chunk, then windows of k
    until every lane has n tokens or stopped; per-lane streams."""
    S = len(prompts)
    c = net.session_carries(S)
    L = max(len(p) for p in prompts) - 1
    tok = np.zeros((S, L), np.float32)
    val = np.zeros((S, L), np.float32)
    for i, p in enumerate(prompts):
        tok[i, :len(p) - 1] = p[:-1]
        val[i, :len(p) - 1] = 1.0
    _, c = net.session_step(tok[:, :, None], c, active=np.ones(S, bool),
                            valid=val)
    first = np.array([p[-1] for p in prompts], np.int32)
    streams = [[] for _ in range(S)]
    live = np.ones(S, bool)
    kept = []
    while live.any():
        offs = np.array([len(s) for s in streams], np.int32)
        toks, emits, c = net.session_decode_window(
            first, c, active=live, k=k, temperature=np.ones(S, np.float32),
            top_k=np.full(S, 256, np.int32), top_p=np.ones(S, np.float32),
            greedy=np.ones(S, bool), keys=np.zeros((S, 2), np.uint32),
            offsets=offs, budgets=n - offs, eos_ids=np.full(S, eos,
                                                            np.int32))
        kept.append((toks, np.asarray(toks).copy()))
        toks, emits = np.asarray(toks), np.asarray(emits)
        for i in range(S):
            new = [int(t) for t, e in zip(toks[i], emits[i]) if e]
            streams[i] += new
            if new:
                first[i] = new[-1]
            if len(streams[i]) >= n or eos in new:
                live[i] = False
    if not jax_side:
        for toks, copy in kept:
            np.testing.assert_array_equal(toks.numpy(), copy)
    return streams


def test_decode_windows_through_static_buffers_match_jax_and_eager():
    """Greedy streams, windows of 4: the graphed discipline, the eager
    loop and the JAX package token for token; then with lane 0's EOS
    inside a window, the lane stops AT the EOS (the documented
    contract), on both ways of the port."""
    jnet, (pnet, eager) = _window_nets()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n) for n in (5, 9, 3)]
    want = _decode(jnet, prompts, 4, 10, jax_side=True)
    got = _decode(pnet, prompts, 4, 10)
    assert got == want == _decode(eager, prompts, 4, 10)
    free = got[0]
    # a token first seen inside a window (not at a window's last place)
    i = next(j for j in range(1, len(free))
             if free[j] not in free[:j] and j % 4 != 3)
    stopped = _decode(pnet, prompts, 4, 10, eos=free[i])
    assert stopped == _decode(eager, prompts, 4, 10, eos=free[i])
    assert stopped[0] == free[:i + 1]
    st = pnet._graphs.stats["decode_window"]
    assert st["eager"] >= 6 and st["replays"] == 0


def test_window_key_ignores_the_order_of_a_carry_s_keys():
    """A step returns a layer's carry keys in another order than
    `session_carries` made them (`pos` before `page_table`): the window
    keeps one entry, so on the card the manager's warm-up capture is the
    one every later window replays."""
    _, (net, _) = _window_nets()
    S = 2
    args = dict(active=np.ones(S, bool), k=2,
                temperature=np.ones(S, np.float32),
                top_k=np.full(S, 256, np.int32), top_p=np.ones(S, np.float32),
                greedy=np.ones(S, bool), keys=np.zeros((S, 2), np.uint32),
                offsets=np.zeros(S, np.int32), budgets=np.full(S, 8, np.int32),
                eos_ids=np.full(S, -1, np.int32))
    c = net.session_carries(S, page_len=8)
    _, _, c = net.session_decode_window(np.arange(S), c, **args)
    _, c = net.session_step(np.ones((S, 1, 1), np.float32), c)
    orders = {tuple(layer["attn"]) for layer in c.values() if "attn" in layer}
    assert orders and all(o.index("pos") < o.index("page_table")
                          for o in orders)
    net.session_decode_window(np.arange(S), c, **args)
    assert len(net._graphs._entries) == 1
