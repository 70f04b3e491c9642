"""Recurrent decode sessions of the PyTorch port against the JAX package,
on the CPU: the slot-indexed `session_step` / `session_decode_window`
seam over recurrent h/c carries, and `DecodeSessionManager` serving a
one-hot LSTM net, with JAX's weights carried across.

C12 (ROADMAP §C): the port's session carries dropped every recurrent
layer, so a hybrid net's LSTM restarted from zeros at every step, and
the port called such a net able to speculate and page. Here the hybrid
net's four steps agree with JAX within 1e-5 and the capability answers
equal JAX's. Greedy streams equal JAX's token for token; windows of K 1
and K 4, eager and through the graph buffers, give the same streams."""

import functools
import time

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.inputs import InputType as JaxIT
from deeplearning4j_tpu.nn.layers import (
    LSTM as JLSTM, EmbeddingSequenceLayer as JEmb, GravesLSTM as JGraves,
    RnnOutputLayer as JOut,
)
from deeplearning4j_tpu.nn.layers.attention import (
    PositionEmbeddingLayer as JPos, TransformerEncoderBlock as JBlock,
)
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration

V = 11
TIMEOUT = 60


def _twin(jconf):
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return jnet, pnet


@functools.lru_cache(maxsize=None)
def _hybrid():
    """Embedding -> positions -> causal block -> LSTM -> softmax: C12's
    net."""
    return _twin(JaxNNC.builder().seed(3).activation("identity")
                 .weight_init("xavier")
                 .list(JEmb(n_in=13, n_out=12, activation="identity"),
                       JPos(max_length=16),
                       JBlock(num_heads=2, causal=True, max_cache=16),
                       JLSTM(n_out=12, activation="tanh"),
                       JOut(n_out=13, activation="softmax", loss="mcxent"))
                 .set_input_type(JaxIT.recurrent(1, 16)).build())


@functools.lru_cache(maxsize=None)
def _lstm(seed=5, graves=False):
    """The one-hot character model's shape at a tiny width: 2 x LSTM 16
    over a vocabulary of 11."""
    cell = JGraves if graves else JLSTM
    return _twin(JaxNNC.builder().seed(seed).activation("tanh")
                 .list(cell(n_out=16), cell(n_out=16),
                       JOut(n_out=V, activation="softmax", loss="mcxent"))
                 .set_input_type(JaxIT.recurrent(V, 20)).tbptt(8).build())


def _tree_close(a, b, tol):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _tree_close(a[k], b[k], tol)
        return
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=tol,
                               rtol=0)


def test_c12_hybrid_net_carries_its_lstm_through_session_steps():
    jnet, pnet = _hybrid()
    jc, pc = jnet.session_carries(2), pnet.session_carries(2)
    assert sorted(pc) == sorted(jc) and "layer3_lstm" in pc
    rng = np.random.default_rng(0)
    for _ in range(4):
        x = rng.integers(0, 13, (2, 1, 1)).astype(np.float32)
        jo, jc = jnet.session_step(x, jc)
        po, pc = pnet.session_step(x, pc)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5,
                                   rtol=0)
    _tree_close({k: v for k, v in pc.items() if k == "layer3_lstm"},
                {k: v for k, v in jc.items() if k == "layer3_lstm"}, 1e-5)


@pytest.mark.parametrize("which", ["hybrid", "lstm", "transformer"])
def test_capabilities_equal_jax(which):
    if which == "hybrid":
        jnet, pnet = _hybrid()
    elif which == "lstm":
        jnet, pnet = _lstm()
    else:
        jnet, pnet = _twin(JaxTGT(input_shape=(16, 1), d_model=16,
                                  num_heads=2, num_blocks=1).conf())
    assert pnet.spec_decode_capable() == jnet.spec_decode_capable()
    assert pnet.prefix_cache_capable() == jnet.prefix_cache_capable()
    assert pnet.spec_decode_capable() == (which == "transformer")


def test_streaming_refuses_what_jax_refuses():
    from deeplearning4j_tpu_torch.nn.layers import (
        GravesBidirectionalLSTM, RnnOutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType

    conf = (NeuralNetConfiguration.builder().list(
        GravesBidirectionalLSTM(n_out=4),
        RnnOutputLayer(n_out=3, activation="softmax"))
        .set_input_type(InputType.recurrent(3, 5)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="cannot stream"):
        net.session_carries(2)


def _onehot(tok, n=V):
    return np.eye(n, dtype=np.float32)[np.asarray(tok)]


def _knobs(S, greedy=True):
    return dict(temperature=np.full(S, 0.9, np.float32),
                top_k=np.full(S, 5, np.int32),
                top_p=np.full(S, 0.95, np.float32),
                greedy=np.full(S, greedy), keys=np.zeros((S, 2), np.uint32))


def _drive(net, prompts, k, n_tokens, active=None):
    """Prefill each lane's prompt stem in padded chunks of 4 through
    `session_step` (lanes with nothing left inactive), then decode
    through `session_decode_window`. Returns (streams, carries)."""
    S = len(prompts)
    c = net.session_carries(S)
    act = np.ones(S, bool) if active is None else np.asarray(active)
    stems = [p[:-1] for p in prompts]
    off = 0
    while any(off < len(s) for s in stems):
        tok = np.zeros((S, 4), np.int64)
        val = np.zeros((S, 4), np.float32)
        for i, s in enumerate(stems):
            part = s[off:off + 4]
            tok[i, :len(part)] = part
            val[i, :len(part)] = 1.0
        lane = act & (val.sum(1) > 0)
        _, c = net.session_step(_onehot(tok), c, active=lane, valid=val)
        off += 4
    streams = [[] for _ in range(S)]
    first = np.array([p[-1] for p in prompts], np.int32)
    live = act.copy()
    while live.any():
        offs = np.array([len(s) for s in streams], np.int32)
        toks, emits, c = net.session_decode_window(
            first, c, active=live, k=k, **_knobs(S), offsets=offs,
            budgets=n_tokens - offs, eos_ids=np.full(S, -1, np.int32))
        toks, emits = np.asarray(toks), np.asarray(emits)
        for i in range(S):
            new = [int(t) for t, e in zip(toks[i], emits[i]) if e]
            streams[i] += new
            if new:
                first[i] = new[-1]
            if len(streams[i]) >= n_tokens:
                live[i] = False
    return streams, c


PROMPTS = [[1, 4, 2, 8, 5, 7], [3, 9], [10, 0, 6, 6, 2, 1, 5, 3, 8],
           [7, 7, 1]]


def test_session_step_matches_jax_with_padded_and_inactive_lanes():
    jnet, pnet = _lstm()
    jc, pc = jnet.session_carries(3), pnet.session_carries(3)
    rng = np.random.default_rng(1)
    for i in range(3):
        x = _onehot(rng.integers(0, V, (3, 4)))
        val = np.ones((3, 4), np.float32)
        val[1, 2 + i % 2:] = 0          # a short chunk
        act = np.array([True, True, i != 1])
        jo, jc = jnet.session_step(x, jc, active=act, valid=val)
        po, pc = pnet.session_step(x, pc, active=act, valid=val)
        live = act[:, None] & (val > 0)
        np.testing.assert_allclose(po.numpy()[live], np.asarray(jo)[live],
                                   atol=1e-5, rtol=0)
        _tree_close(pc, jc, 1e-5)


@pytest.mark.parametrize("k", [1, 4])
def test_decode_windows_match_jax(k):
    jnet, pnet = _lstm()
    want, jc = _drive(jnet, PROMPTS, k, 9)
    got, pc = _drive(pnet, PROMPTS, k, 9)
    assert got == want
    _tree_close(pc, jc, 1e-5)


def test_windows_are_k_invariant_eager_and_graphed():
    _, pnet = _lstm(graves=True)
    runs = []
    for graphs in (True, False):
        pnet.cuda_graphs = graphs
        try:
            for k in (1, 4):
                runs.append(_drive(pnet, PROMPTS, k, 10))
        finally:
            pnet.cuda_graphs = True
    streams = [r[0] for r in runs]
    assert all(s == streams[0] for s in streams)
    for _, c in runs[1:]:
        for name in c:
            for leaf in ("h", "c"):
                assert torch.equal(c[name][leaf], runs[0][1][name][leaf])


def test_window_writes_hc_back_into_the_callers_tensors():
    _, pnet = _lstm()
    c = pnet.session_carries(2)
    ptrs = {n: (v["h"].data_ptr(), v["c"].data_ptr()) for n, v in c.items()}
    h_before = c["layer0_lstm"]["h"].clone()
    _, _, new = pnet.session_decode_window(
        np.array([1, 2], np.int32), c, active=np.array([True, False]), k=2,
        **_knobs(2), offsets=np.zeros(2, np.int32),
        budgets=np.full(2, 5, np.int32), eos_ids=np.full(2, -1, np.int32))
    assert {n: (v["h"].data_ptr(), v["c"].data_ptr())
            for n, v in new.items()} == ptrs
    h = c["layer0_lstm"]["h"]
    assert not torch.equal(h[0], h_before[0])      # the active lane moved
    assert torch.equal(h[1], h_before[1])          # the inactive one held


# ---------------------------------------------------- the session manager
def _plane(pkg, net, **kw):
    if pkg == "jax":
        from deeplearning4j_tpu.serving import (
            ContinuousBatchingScheduler, ModelRegistry, ServingStats,
        )
        from deeplearning4j_tpu.serving.sessions import (
            DecodeSessionManager,
        )
    else:
        from deeplearning4j_tpu_torch.serving import (
            ContinuousBatchingScheduler, DecodeSessionManager,
            ModelRegistry, ServingStats,
        )
    registry = ModelRegistry()
    registry.deploy("default", 1, net, warm=False)
    stats = ServingStats()
    sched = ContinuousBatchingScheduler(registry, stats, max_batch_size=8)
    kw.setdefault("fused_k", 4)
    mgr = DecodeSessionManager(registry, sched, "default", slots=4,
                               prefill_chunk=4, metrics=stats.registry,
                               **kw)
    return registry, sched, mgr


def _serve(pkg, net, prompts, n=12, **kw):
    registry, sched, mgr = _plane(pkg, net, **kw)
    try:
        sessions = [mgr.open_session(p, max_tokens=n, greedy=True)
                    for p in prompts]
        return [s.result(timeout=TIMEOUT) for s in sessions], \
            mgr.snapshot()
    finally:
        sched.shutdown()
        registry.close()


def test_manager_streams_equal_jax_with_spec_and_prefix_off():
    jnet, pnet = _lstm()
    want, jsnap = _serve("jax", jnet, PROMPTS, page_len=4)
    got, psnap = _serve("torch", pnet, PROMPTS, page_len=4)
    assert got == want
    for snap in (psnap, jsnap):
        assert not snap["prefix_cache"]["enabled"]
    assert "recurrent carries" in psnap["prefix_cache"]["reason"]
    assert psnap["kernel_policy"] == []


def test_a_draft_is_refused_for_a_recurrent_target():
    jnet, pnet = _lstm()
    _, pdraft = _lstm(seed=9)
    jdraft, _ = _lstm(seed=9)
    got, psnap = _serve("torch", pnet, PROMPTS[:2], draft_net=pdraft,
                        spec_k=4)
    want, jsnap = _serve("jax", jnet, PROMPTS[:2], draft_net=jdraft,
                         spec_k=4)
    assert got == want
    assert not psnap["spec_decode"]["enabled"]
    assert not jsnap["spec_decode"]["enabled"]
    assert "recurrent carries" in psnap["spec_decode"]["reason"]


@pytest.mark.parametrize("flag", ["spec_enabled", "prefix_enabled"])
def test_swap_compat_refuses_a_recurrent_candidate_with_jax_message(flag):
    from deeplearning4j_tpu_torch.serving.kv_pool import (
        IncompatibleSessionSwapError,
    )
    _, tnet = _twin(JaxTGT(input_shape=(16, 1), d_model=16, num_heads=2,
                           num_blocks=1, num_classes=13).conf())
    _, hybrid = _hybrid()
    registry, sched, mgr = _plane("torch", tnet, warm=False)
    try:
        setattr(mgr, flag, True)
        want = ("cannot rewind its decode caches \\(recurrent carries or "
                "rolling rings\\) — this manager speculates"
                if flag == "spec_enabled" else
                "cannot page its KV caches — this manager runs the prefix "
                "cache")
        with pytest.raises(IncompatibleSessionSwapError, match=want):
            mgr._check_swap_compat(hybrid)
    finally:
        sched.shutdown()
        registry.close()


def test_freed_slot_hc_is_zeroed_and_counted():
    from deeplearning4j_tpu_torch.observe import MetricsRegistry
    from deeplearning4j_tpu_torch.serving.kv_pool import KVSlotPool

    _, pnet = _lstm()
    pool = KVSlotPool(pnet, 3, metrics=MetricsRegistry())
    s = pool.alloc()
    for layer in pool.carries.values():
        layer["h"].fill_(0.5)
        layer["c"].fill_(-0.5)
    pool.free(s)
    for layer in pool.carries.values():
        assert torch.all(layer["h"][s] == 0) and torch.all(layer["c"][s] == 0)
        assert torch.all(layer["h"][s + 1] == 0.5)
    # two LSTM layers of 16, h and c, float32
    assert pool.describe()["slot_bytes"] == 2 * 2 * 16 * 4


def test_same_shape_hot_swap_carries_hc_so_streams_continue():
    """A mid-stream deploy of a copy of the live weights: the streams
    equal those served without a swap, which they would not if the
    flip dropped the live h/c."""
    _, pnet = _lstm()
    twin = pnet.clone()
    want, _ = _serve("torch", pnet, PROMPTS, n=30)
    registry, sched, mgr = _plane("torch", pnet)
    try:
        live = [mgr.open_session(p, max_tokens=30, greedy=True)
                for p in PROMPTS]
        deadline = time.monotonic() + TIMEOUT
        while any(len(s.generated) < 2 for s in live):
            assert time.monotonic() < deadline, "no window landed"
            time.sleep(0.002)
        registry.deploy("default", 2, twin, feat_shape=(20, V))
        got = [s.result(timeout=TIMEOUT) for s in live]
        assert mgr.pool.net is twin
        assert all(s.outcome == "completed" for s in live)
    finally:
        sched.shutdown()
        registry.close()
    assert got == want
