"""The port's CUDA graphs on the card (`utils/cuda_graphs.py`):
`fit(steps_per_dispatch=K)`'s K-step graphs (with gradient
checkpointing and dropout too), the graphed `rnn_time_step` (over LSTM
carries and lockstep KV caches, with beam reorders), decode window and
speculative propose/verify windows, and a window after a pool's
`rebind`, against the same calls run eagerly. These tests
import only torch, so they run on a machine with a card and no JAX:
    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_graphs.py
Where there is no card they skip: a graph is captured and replayed only
on CUDA (the CPU runs the same static-buffer discipline without graphs,
held to the JAX package in `tests/test_torch_fused_dispatch.py`).

Every comparison is bit for bit: a graph replays the kernels its eager
warm-up ran, on the same inputs, in the same order."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.models import (
    ComputationGraph, MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization, ConvolutionLayer, DenseLayer, GlobalPoolingLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers import recurrent as rec
from deeplearning4j_tpu_torch.ops import fused_update as fu
from deeplearning4j_tpu_torch.optim.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.optim.updaters import (
    Adam, Nesterovs, tree_leaves,
)
from deeplearning4j_tpu_torch.utils.cuda_graphs import NetGraphs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured and "
                    "replayed only there")
    return torch.device("cuda")


def _mlp(dropout=0.0):
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater(Adam(1e-2, epsilon=1e-3))
            .list(DenseLayer(n_out=32, activation="relu", dropout=dropout),
                  OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(16)).build())
    return MultiLayerNetwork(conf, device="cuda").init()


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.standard_normal((8, 16)).astype(np.float32),
                    np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)])
            for _ in range(n)]


def _fit(net, batches, k, epochs=1):
    scores = CollectScoresIterationListener()
    net.listeners.append(scores)
    net.fit(batches, epochs=epochs, steps_per_dispatch=k)
    return [s for _, s in scores.scores]


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.5], ids=["plain", "dropout"])
def test_k_step_graph_equals_k_eager_steps(cuda_device, dropout):
    """12 batches at K 4: the first window eager, then captured, then
    two replays; losses, parameters, Adam's moments and the generator's
    draws equal 12 eager steps; B1a's launch count equals K 1's."""
    a, b = _mlp(dropout), _mlp(dropout)
    batches = _batches(12)
    fu.reset_counts()
    la = _fit(a, batches, 1)
    eager_launches = fu.LAUNCHES["adam_update"]
    fu.reset_counts()
    lb = _fit(b, batches, 4)
    assert la == lb
    assert _equal_trees(a.params_tree, b.params_tree)
    assert _equal_trees(a.updater_state, b.updater_state)
    assert fu.LAUNCHES["adam_update"] == eager_launches == 12
    assert b.fit_stats == {"graph_windows": 2, "eager_steps": 4}
    assert b._graphs.stats["fit"]["captures"] == 1


@pytest.mark.cuda
def test_batch_norm_graph_copies_running_statistics_in_place(cuda_device):
    """A small ComputationGraph with batch norm under Nesterovs (B1b):
    K 4 equals K 1, and the running statistics stay the same tensors."""
    def graph():
        g = (NeuralNetConfiguration.builder().seed(5)
             .updater(Nesterovs(0.05, 0.9)).graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(8, 8, 3)))
        g.add_layer("c", ConvolutionLayer(n_out=8, kernel=(3, 3),
                                          convolution_mode="same"), "in")
        g.add_layer("b", BatchNormalization(activation="relu"), "c")
        g.add_layer("gap", GlobalPoolingLayer(pooling="avg"), "b")
        g.add_layer("output", OutputLayer(n_out=3, activation="softmax"),
                    "gap")
        g.set_outputs("output")
        return ComputationGraph(g.build(), device="cuda").init()

    rng = np.random.default_rng(1)
    batches = [DataSet(rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
                       np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)])
               for _ in range(8)]
    a, b = graph(), graph()
    stats = [t.data_ptr() for t in tree_leaves(b.state_tree)]
    fu.reset_counts()
    assert _fit(a, batches, 1) == _fit(b, batches, 4)
    assert fu.LAUNCHES["nesterov_update"] == 16
    assert _equal_trees(a.params_tree, b.params_tree)
    assert _equal_trees(a.state_tree, b.state_tree)
    assert [t.data_ptr() for t in tree_leaves(b.state_tree)] == stats
    assert b.fit_stats["graph_windows"] == 1


@pytest.mark.cuda
def test_host_read_in_a_step_raises_at_capture(cuda_device):
    """A float() planted in the step: the first window's eager warm-up
    runs (4 real steps), capture raises, and nothing runs eagerly in
    its place: the step counter stands at 4, not 8."""
    net = _mlp()
    real = net._train_step

    def reads_the_loss(*args):
        loss = real(*args)
        float(loss)
        return loss

    net._train_step = reads_the_loss
    with pytest.raises(RuntimeError):
        net.fit(_batches(8), steps_per_dispatch=4)
    torch.cuda.synchronize()
    assert int(net._step_t) == 4
    assert net.iteration == 0
    assert net._graphs.stats["fit"]["captures"] == 0


@pytest.mark.cuda
def test_second_fit_replays_and_new_addresses_recapture(cuda_device):
    a, b = _mlp(), _mlp()
    batches = _batches(8)
    _fit(a, batches, 1, epochs=3)
    _fit(b, batches, 4)
    _fit(b, batches, 4)           # the graph of the first fit, replayed
    assert b._graphs.stats["fit"]["captures"] == 1
    # the parameters rebound (a loaded model): captured anew
    b.params_tree = {n: {k: v.clone() for k, v in sub.items()}
                     for n, sub in b.params_tree.items()}
    _fit(b, batches, 4)
    assert b._graphs.stats["fit"]["captures"] == 2
    assert _equal_trees(a.params_tree, b.params_tree)
    assert _equal_trees(a.updater_state, b.updater_state)


@pytest.mark.cuda
def test_a_nets_graphs_share_one_pool_and_stream(cuda_device):
    net = _mlp()
    _fit(net, _batches(8), 4)
    _fit(net, _batches(4), 2)
    g = net._graphs
    pools = {e.graph.pool() for e in g._entries.values()}
    assert len(g._entries) == 2 and pools == {g._pool}
    assert g._stream is not None


@pytest.mark.cuda
def test_outputs_are_clones_and_counts_replay(cuda_device):
    g = NetGraphs("cuda")
    x = torch.ones(4, device="cuda")
    kept = [g.run(("double",), lambda t: t * 2, (x * i,)) for i in range(4)]
    for i, t in enumerate(kept):
        assert torch.equal(t, torch.full((4,), 2.0 * i, device="cuda"))
    assert g.stats["double"] == {"replays": 3, "eager": 1, "captures": 1,
                                 "capture_ms": g.stats["double"][
                                     "capture_ms"]}


def _lstm_net():
    conf = (NeuralNetConfiguration.builder().seed(0).activation("tanh")
            .list(rec.GravesLSTM(n_out=64, fused=True),
                  rec.GravesLSTM(n_out=64, fused=True),
                  rec.RnnOutputLayer(n_out=11, activation="softmax"))
            .set_input_type(InputType.recurrent(11)).build())
    return MultiLayerNetwork(conf, device="cuda").init()


@pytest.mark.cuda
def test_graphed_stepping_equals_eager(cuda_device):
    from deeplearning4j_tpu_torch.ops import lstm as lk

    a, b = _lstm_net(), _lstm_net()
    b.cuda_graphs = False
    eye = torch.eye(11, device="cuda")
    tok_a = tok_b = torch.arange(8, device="cuda") % 11
    lk.reset_counts()
    for _ in range(12):
        out_a = a.rnn_time_step(eye[tok_a])
        tok_a = torch.argmax(out_a[:, -1], dim=-1)
    graphed = lk.LAUNCHES["lstm_fwd_inference"]
    lk.reset_counts()
    for _ in range(12):
        out_b = b.rnn_time_step(eye[tok_b])
        tok_b = torch.argmax(out_b[:, -1], dim=-1)
    assert torch.equal(out_a, out_b)
    assert graphed == lk.LAUNCHES["lstm_fwd_inference"] == 24
    a.rnn_reorder_state([1, 0, 2, 3, 4, 5, 6, 7])
    b.rnn_reorder_state([1, 0, 2, 3, 4, 5, 6, 7])
    assert torch.equal(a.rnn_time_step(eye[tok_a]),
                       b.rnn_time_step(eye[tok_b]))
    assert a._graphs.stats["rnn_time_step"]["replays"] >= 10


def _window(net, carries, S, k=4):
    return net.session_decode_window(
        np.arange(S) % 256, carries, active=np.ones(S, bool), k=k,
        temperature=np.full(S, 0.8, np.float32),
        top_k=np.full(S, 40, np.int32), top_p=np.ones(S, np.float32),
        greedy=np.arange(S) % 2 == 0, keys=np.arange(2 * S, dtype=np.uint32)
        .reshape(S, 2), offsets=np.zeros(S, np.int32),
        budgets=np.full(S, 64, np.int32), eos_ids=np.full(S, -1, np.int32))


@pytest.mark.cuda
def test_decode_window_graph_equals_eager_and_a_new_pool_recaptures(
        cuda_device):
    """Windows of 4 on a paged pool, greedy and sampled lanes: the graph
    replays equal the eager loop's tokens and positions; a second pool,
    alive beside the first and so at other addresses, is captured anew;
    B6's launches replay."""
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    def net():
        return MultiLayerNetwork(TextGenerationTransformer(
            input_shape=(64, 1), d_model=64, num_heads=4, num_blocks=2,
            seed=3).conf(), device="cuda").init()

    a, b = net(), net()
    b.cuda_graphs = False
    S = 4
    ca, cb = a.session_carries(S, page_len=16), b.session_carries(S,
                                                                 page_len=16)
    for c in (ca, cb):
        for layer in c.values():
            if "attn" in layer:
                layer["attn"]["page_table"].copy_(torch.arange(
                    S * 4, dtype=torch.int32, device="cuda").view(S, 4))
    ba.reset_counts()
    for _ in range(3):
        ta, ea, ca = _window(a, ca, S)
        tb, eb, cb = _window(b, cb, S)
        assert torch.equal(ta, tb) and torch.equal(ea, eb)
    assert ba.LAUNCHES["paged_decode_attention"] == 2 * 2 * 3 * 4
    pos = [t for n, layer in ca.items() for k, t in layer.get(
        "attn", {}).items() if k == "pos"]
    assert all(int(p.min()) == 12 for p in pos)
    st = a._graphs.stats["decode_window"]
    assert (st["eager"], st["replays"], st["captures"]) == (1, 2, 1)
    c2 = a.session_carries(S, page_len=16)
    _window(a, c2, S)
    assert a._graphs.stats["decode_window"]["captures"] == 2


@pytest.mark.cuda
def test_a_dead_nets_graph_is_not_freed_inside_a_capture(cuda_device):
    """A net whose graph sits in a reference cycle dies while another
    call is being captured. The cyclic collector, were it to run inside
    the capture, would free that graph there, which CUDA refuses, and the
    capture would fail; it runs after the capture instead."""
    import gc

    dead = {"net": _mlp()}
    _fit(dead["net"], _batches(8), 4)
    dead["net"].cycle = dead["net"]

    def fn(t):
        if torch.cuda.is_current_stream_capturing() and dead:
            dead.clear()                      # the net is cyclic garbage
            [[i] for i in range(5000)]        # the collector's trigger
        return t * 2

    g = NetGraphs("cuda")
    x = torch.ones(4, device="cuda")
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        outs = [g.run(("f",), fn, (x,)) for _ in range(3)]
    finally:
        gc.set_threshold(*threshold)
    assert g.stats["f"]["captures"] == 1
    assert all(torch.equal(o, x * 2) for o in outs)


def _spec_nets(seed=3, blocks=2):
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    return MultiLayerNetwork(TextGenerationTransformer(
        input_shape=(64, 1), d_model=256, num_heads=4, num_blocks=blocks,
        seed=seed).conf(), device="cuda").init()


def _spec_round(target, draft, tc, dc, S, k, state):
    """One propose + verify window with the manager's bookkeeping."""
    tok0, rew, ptk, pvl, offs = state
    knobs = dict(temperature=np.full(S, 0.9, np.float32),
                 top_k=np.full(S, 40, np.int32), top_p=np.ones(S, np.float32),
                 greedy=np.arange(S) % 2 == 0,
                 keys=np.arange(2 * S, dtype=np.uint32).reshape(S, 2),
                 offsets=offs)
    d_t, d_p, dc = draft.session_propose_window(
        tok0, dc, active=np.ones(S, bool), k=k, rewind=rew, pre_tokens=ptk,
        pre_valid=pvl, **knobs)
    packed, tc = target.session_verify_window(
        tok0, tc, active=np.ones(S, bool), k=k, draft_tokens=d_t,
        draft_probs=d_p, budgets=np.full(S, 48, np.int32),
        eos_ids=np.full(S, -1, np.int32), **knobs)
    ph = packed.cpu().numpy()
    n = ph[:, 0]
    state = (np.where(n > 0, ph[np.arange(S), 2 + n], tok0),
             np.maximum(k - n, 0).astype(np.int32), ph[:, 2].copy(),
             n == k + 1, (offs + n).astype(np.int32))
    return (d_t, d_p, packed), tc, dc, state


@pytest.mark.cuda
def test_spec_windows_graph_equal_eager(cuda_device):
    """Propose and verify windows (k 4, greedy and sampled lanes, a
    1-block draft; head dim 64) as graph replays against the same calls
    run eagerly, over slot pools: draft tokens, draft probabilities and
    the packed rows bit-equal, window after window (rewinds, catch-up);
    each window's first call eager, then captured, then replayed; the
    draft's steps launch B5, on design 2."""
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    S, k = 4, 4
    nets = {g: (_spec_nets(), _spec_nets(blocks=1)) for g in (True, False)}
    for g, (t, d) in nets.items():
        t.cuda_graphs = d.cuda_graphs = g
    rng = np.random.default_rng(0)
    stem = rng.integers(0, 256, (S, 11)).astype(np.float32)[:, :, None]
    tok0 = rng.integers(0, 256, S)
    out = {}
    ba.reset_counts()
    for g, (t, d) in nets.items():
        tc, dc = t.session_carries(S), d.session_carries(S)
        val = np.ones((S, 11), np.float32)
        _, tc = t.session_step(stem, tc, active=np.ones(S, bool), valid=val)
        _, dc = d.session_step(stem, dc, active=np.ones(S, bool), valid=val)
        state = (tok0, np.zeros(S, np.int32), np.zeros(S, np.int32),
                 np.zeros(S, bool), np.zeros(S, np.int32))
        rows = []
        for _ in range(4):
            r, tc, dc, state = _spec_round(t, d, tc, dc, S, k, state)
            rows.append(r)
        out[g] = rows
    for a, b in zip(out[True], out[False]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    t, d = nets[True]
    for net, kind in ((d, "propose_window"), (t, "verify_window")):
        st = net._graphs.stats[kind]
        assert (st["eager"], st["captures"], st["replays"]) == (1, 1, 3)
    # the draft's 4 steps + catch-up a window, 1 block, both runs
    assert ba.LAUNCHES["banded_decode_attention"] == 2 * 4 * (k + 1)
    assert ba.LAUNCHES_BY_DESIGN[("banded_decode_attention", "split")] == \
        ba.LAUNCHES["banded_decode_attention"]


@pytest.mark.cuda
def test_rebind_then_a_window_recaptures(cuda_device):
    """A pool rebound to another net keeps its caches where they lie; the
    new net's first window over them is eager, then captured, and its
    replays equal the eager calls of a copy on the same carries."""
    from deeplearning4j_tpu_torch.observe import MetricsRegistry
    from deeplearning4j_tpu_torch.serving import KVSlotPool

    S = 4
    v1, v2, v2_eager = _spec_nets(3), _spec_nets(8), _spec_nets(8)
    v2_eager.cuda_graphs = False
    pool = KVSlotPool(v1, S, metrics=MetricsRegistry(), page_len=16)
    for layer in pool.carries.values():
        if "attn" in layer:
            layer["attn"]["page_table"].copy_(torch.arange(
                S * 4, dtype=torch.int32, device="cuda").view(S, 4))
    _, _, c = _window(v1, pool.carries, S)
    ptrs = [a.data_ptr() for layer in pool.carries.values()
            for a in layer.get("attn", {}).values()]
    pool.rebind(v2)
    assert pool.net is v2
    assert ptrs == [a.data_ptr() for layer in pool.carries.values()
                    for a in layer.get("attn", {}).values()]
    snapshot = {n: {kk: t.clone() for kk, t in layer.get("attn", {}).items()}
                for n, layer in c.items()}
    for _ in range(3):
        ta, ea, c_next = _window(v2, c, S)
        # the eager copy on the same caches, restored to the same state
        for n, leaves in snapshot.items():
            for kk, t in leaves.items():
                c[n]["attn"][kk].copy_(t)
        tb, eb, _ = _window(v2_eager, c, S)
        assert torch.equal(ta, tb) and torch.equal(ea, eb)
        c = c_next
        snapshot = {n: {kk: t.clone()
                        for kk, t in layer.get("attn", {}).items()}
                    for n, layer in c.items()}
    st = v2._graphs.stats["decode_window"]
    assert (st["eager"], st["captures"], st["replays"]) == (1, 1, 2)


def _tiny_transformer(**kw):
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    return TextGenerationTransformer(input_shape=(64, 1), d_model=64,
                                     num_heads=4, num_blocks=2, seed=4,
                                     **kw).init(device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(pos_encoding="rope", norm="rms",
                                         ffn_activation="swiglu",
                                         num_kv_heads=2, window=16,
                                         rolling_cache=True)],
                         ids=["linear", "ring"])
def test_lockstep_stepping_and_beam_reorders_graph_equal_eager(cuda_device,
                                                               kw):
    """Prefill chunks and single-token steps over lockstep KV caches, a
    beam expansion (new caches: a new graph) and same-batch reorders
    (in place: replays), graphed against eager, bit for bit; B5 on every
    single-token step."""
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    graphed, eager = _tiny_transformer(**kw), _tiny_transformer(**kw)
    eager.cuda_graphs = False
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (2, 48, 1)).astype(np.float32)
    for net in (graphed, eager):
        net.rnn_clear_previous_state()
    outs = []
    for lo, hi in ((0, 16), (16, 32), (32, 33), (33, 34)):
        outs.append([n.rnn_time_step(x[:, lo:hi]) for n in (graphed, eager)])
    for n in (graphed, eager):
        n.rnn_reorder_state([0, 0, 1, 1])
    before = ba.LAUNCHES["banded_decode_attention"]
    for i in range(34, 44):
        idx = rng.permutation(4)
        for n in (graphed, eager):
            n.rnn_reorder_state(idx)
        step = np.repeat(x[:, i:i + 1], 2, axis=0)
        outs.append([n.rnn_time_step(step) for n in (graphed, eager)])
    torch.cuda.synchronize()
    assert ba.LAUNCHES["banded_decode_attention"] == before + 2 * 2 * 10
    for a, b in outs:
        assert torch.equal(a, b)
    st = graphed._graphs.stats["rnn_time_step"]
    # one graph a (step length, batch): the second 16-token chunk, the
    # second step at batch 2 and the 9 steps after the first at batch 4
    # replay
    assert st["captures"] == 3 and st["replays"] == 11


@pytest.mark.cuda
def test_checkpointed_k4_graph_equals_eager_checkpointed_steps(cuda_device):
    """Gradient checkpointing with dropout inside a K 4 graph (the
    recompute replays the forward's masks): bit for bit against the
    same steps eager, and against the steps without checkpointing."""
    import dataclasses

    from deeplearning4j_tpu_torch.nn.layers import TransformerEncoderBlock

    def net(ckpt):
        n = _tiny_transformer()
        conf = dataclasses.replace(n.conf, gradient_checkpointing=ckpt,
                                   layers=tuple(
            dataclasses.replace(l, dropout=0.1)
            if isinstance(l, TransformerEncoderBlock) else l
            for l in n.conf.layers))
        return MultiLayerNetwork(conf, device="cuda").init()

    rng = np.random.default_rng(6)
    toks = rng.integers(0, 256, (8, 4, 65))
    batches = [DataSet(t[:, :64, None].astype(np.float32),
                       np.eye(256, dtype=np.float32)[t[:, 1:]])
               for t in toks]
    k4, k1, plain = net(True), net(True), net(False)
    k1.cuda_graphs = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        k4.fit(batches, steps_per_dispatch=4)
        k1.fit(batches)
        plain.fit(batches)
    finally:
        torch.use_deterministic_algorithms(False)
    assert k4.fit_stats["graph_windows"] == 1
    for a, b, c in zip(tree_leaves(k4.params_tree),
                       tree_leaves(k1.params_tree),
                       tree_leaves(plain.params_tree)):
        assert torch.equal(a, b) and torch.equal(b, c)
