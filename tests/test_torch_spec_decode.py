"""Speculative decoding of the PyTorch port against the JAX package, on
the CPU: `utils.sampling.spec_accept_lanes`, the draft's
`session_propose_window` and the target's `session_verify_window`, and
the `DecodeSessionManager` with a draft.

Greedy results must equal the JAX package's exactly: n_acc, the packed
rows [n_emit, n_acc, last_draft, tok_0..tok_k], the positions and the
streams; the draft's probabilities within 1e-5. Stochastic acceptance is
held to JAX's n_acc on the same uniforms and to the target's marginal
(the extra draws are the port's own inverse CDF, not threefry). EOS
follows the documented contract: a lane stops AT its EOS token (ROADMAP
C0), whatever the reference's current output is."""

import functools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.ops import kernel_defaults as kd
from deeplearning4j_tpu_torch.utils import sampling

V = 64
TIMEOUT = 60


@functools.lru_cache(maxsize=None)
def _pair(seed, blocks=2, **kw):
    """A JAX TextGenerationTransformer (vocabulary 64, d_model 32) and the
    port's copy of it, on the same weights."""
    jconf = JaxTGT(num_classes=V, input_shape=(32, 1), d_model=32,
                   num_heads=4, num_blocks=blocks, seed=seed, **kw).conf()
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return jnet, pnet


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, n) for n in lengths]


# ------------------------------------------------- spec_accept_lanes
def _jax_accept(p_raw, p_warp, q_warp, d, greedy, u, seed=0):
    from deeplearning4j_tpu.utils.sampling import spec_accept_lanes

    keys = jax.random.split(jax.random.PRNGKey(seed), p_raw.shape[0])
    n_acc, extra = spec_accept_lanes(
        jnp.asarray(p_raw, jnp.float32), jnp.asarray(p_warp, jnp.float32),
        jnp.asarray(q_warp, jnp.float32), jnp.asarray(d, jnp.int32),
        jnp.asarray(greedy, bool), jnp.asarray(u, jnp.float32), keys)
    return np.asarray(n_acc), np.asarray(extra)


def _port_accept(p_raw, p_warp, q_warp, d, greedy, u, extra_u):
    n_acc, extra = sampling.spec_accept_lanes(
        torch.tensor(p_raw, dtype=torch.float32),
        torch.tensor(p_warp, dtype=torch.float32),
        torch.tensor(q_warp, dtype=torch.float32),
        torch.tensor(d, dtype=torch.int64),
        torch.tensor(greedy, dtype=torch.bool),
        torch.tensor(u, dtype=torch.float32),
        torch.tensor(extra_u, dtype=torch.float32))
    return n_acc.numpy(), extra.numpy()


def _dists(rng, shape):
    p = rng.random(shape).astype(np.float32) + 0.01
    return p / p.sum(-1, keepdims=True)


def test_greedy_longest_prefix_and_bonus_match_jax():
    S, k = 5, 3
    rng = np.random.default_rng(0)
    p = _dists(rng, (S, k + 1, V))
    tgt = p.argmax(-1)
    d = tgt[:, :k].copy()
    # lane 0 matches fully (bonus), lanes 1-3 miss at 0, 1, 2
    for lane, miss in ((1, 0), (2, 1), (3, 2), (4, 0)):
        d[lane, miss] = (d[lane, miss] + 1) % V
    u = rng.random((S, k))
    want = _jax_accept(p, p, p[:, :k], d, np.ones(S, bool), u)
    got = _port_accept(p, p, p[:, :k], d, np.ones(S, bool), u,
                       rng.random(S))
    assert got[0].tolist() == want[0].tolist() == [k, 0, 1, 2, 0]
    assert got[1].tolist() == want[1].tolist()
    assert all(got[1][s] == tgt[s, got[0][s]] for s in range(S))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_stochastic_n_acc_matches_jax_on_the_same_uniforms(seed):
    """Warped, unnormalised target and draft distributions of their own,
    drafts drawn from q: the number accepted equals JAX's exactly, lane
    by lane, on JAX's uniforms."""
    S, k = 64, 4
    rng = np.random.default_rng(seed)
    p_raw = _dists(rng, (S, k + 1, V))
    p_warp = p_raw * rng.uniform(0.5, 2.0, (S, k + 1, 1))
    q = _dists(rng, (S, k, V)) * 3.0
    d = np.stack([[rng.choice(V, p=q[s, i] / q[s, i].sum())
                   for i in range(k)] for s in range(S)])
    # a quarter of the drafts taken from p: some lanes accept deep
    d[::4] = p_raw[::4, :k].argmax(-1)
    u = rng.random((S, k)).astype(np.float32)
    greedy = np.zeros(S, bool)
    greedy[::5] = True
    want = _jax_accept(p_raw, p_warp, q, d, greedy, u)
    got = _port_accept(p_raw, p_warp, q, d, greedy, u, rng.random(S))
    assert got[0].tolist() == want[0].tolist()
    assert 0 < got[0].sum() < S * k
    assert got[1][greedy].tolist() == want[1][greedy].tolist()


def test_one_hot_residual_extra_matches_jax():
    """Where the residual max(p - q, 0) has one token of mass, the extra
    token is determined: equal to JAX's whatever the draw."""
    S, k = 16, 2
    rng = np.random.default_rng(4)
    q = np.zeros((S, k, V), np.float32)
    q[:, :, 0] = 1.0                          # the draft proposes token 0
    p = np.zeros((S, k + 1, V), np.float32)
    p[np.arange(S), :, 1 + np.arange(S) % (V - 1)] = 1.0
    d = np.zeros((S, k), np.int64)
    u = rng.random((S, k))
    want = _jax_accept(p, p, q, d, np.zeros(S, bool), u)
    got = _port_accept(p, p, q, d, np.zeros(S, bool), u, rng.random(S))
    assert got[0].tolist() == want[0].tolist() == [0] * S
    assert got[1].tolist() == want[1].tolist()


def test_identical_distributions_accept_everything():
    S, k = 8, 4
    rng = np.random.default_rng(5)
    q = _dists(rng, (S, k, V))
    p = np.concatenate([q, q[:, -1:]], axis=1)
    d = rng.integers(0, V, (S, k))
    n_acc, _ = _port_accept(p, p, q, d, np.zeros(S, bool),
                            rng.random((S, k)), rng.random(S))
    assert (n_acc == k).all()


def test_emitted_marginal_matches_target():
    """The rejection rule's point: over many lanes with one draft each,
    the emitted token (accepted proposal or residual draw) follows the
    TARGET distribution p."""
    S, k = 20000, 1
    rng = np.random.default_rng(7)
    p1 = _dists(rng, (V,))
    q1 = _dists(rng, (V,))
    p = np.broadcast_to(p1, (S, k + 1, V))
    q = np.broadcast_to(q1, (S, k, V))
    d = rng.choice(V, size=(S, k), p=q1 / q1.sum())
    n_acc, extra = _port_accept(p, p, q, d, np.zeros(S, bool),
                                rng.random((S, k)), rng.random(S))
    emitted = np.where(n_acc >= 1, d[:, 0], extra)
    freq = np.bincount(emitted, minlength=V) / S
    # chi-square over 64 cells: 99.9% point of chi2(63) is ~103
    chi2 = (S * (freq - p1) ** 2 / p1).sum()
    assert chi2 < 103.0, chi2


def test_spec_policy_keeps_the_jax_lattice():
    from deeplearning4j_tpu_torch.observe import get_registry

    pol = kd.spec_decode_policy(record=False)
    assert (pol.kind, pol.k) == ("spec", 8)
    assert kd.spec_decode_policy(3, record=False).k == 4
    assert kd.spec_decode_policy(100, record=False).k == 16
    off = kd.spec_decode_policy(8, capable=False, record=False)
    assert (off.kind, off.k) == ("plain", 0)
    c = get_registry().counter("kernel_dispatch_total", op="spec_decode",
                               impl="plain")
    before = c.value
    kd.spec_decode_policy(capable=False)
    assert c.value == before + 1


def test_acceptance_streams_are_salted_apart():
    keys = torch.tensor([[0, 7], [3, 9]])
    ctr = torch.tensor([4, 4])
    base = sampling.lane_uniforms(keys, ctr)
    salted = sampling.lane_uniforms(keys, ctr, 0x5EC0DE)
    assert not torch.equal(base, salted)
    assert torch.equal(salted, sampling.lane_uniforms(keys, ctr, 0x5EC0DE))


# ------------------------------------------- propose / verify windows
def _prefill(net, prompts, torch_side):
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
    return c


def _positions(carries):
    return [np.asarray(leaf["attn"]["pos"] if "attn" in leaf
                       else leaf["pos"]) for _, leaf in sorted(
                           carries.items())]


def _spec_drive(tnet, dnet, prompts, k, n_tokens, torch_side, *,
                active=None, eos=-1):
    """Drive propose + verify windows as the manager does (rewind and
    catch-up bookkeeping per lane) until every lane has `n_tokens` or
    met `eos`. Returns the streams and, per window, the packed rows, the
    draft tokens and probabilities and both nets' positions."""
    S = len(prompts)
    tc, dc = _prefill(tnet, prompts, torch_side), \
        _prefill(dnet, prompts, torch_side)
    live = np.ones(S, bool) if active is None else np.asarray(active)
    tok0 = np.array([p[-1] for p in prompts], np.int64)
    rew = np.zeros(S, np.int32)
    ptk = np.zeros(S, np.int32)
    pvl = np.zeros(S, bool)
    streams = [[] for _ in range(S)]
    trace = []
    while live.any():
        offs = np.array([len(s) for s in streams], np.int32)
        knobs = dict(temperature=np.ones(S, np.float32),
                     top_k=np.full(S, V, np.int32),
                     top_p=np.ones(S, np.float32),
                     greedy=np.ones(S, bool),
                     keys=np.zeros((S, 2), np.uint32), offsets=offs)
        d_t, d_p, dc = dnet.session_propose_window(
            tok0, dc, active=live, k=k, rewind=rew, pre_tokens=ptk,
            pre_valid=pvl, **knobs)
        packed, tc = tnet.session_verify_window(
            tok0, tc, active=live, k=k, draft_tokens=d_t, draft_probs=d_p,
            budgets=n_tokens - offs, eos_ids=np.full(S, eos, np.int32),
            **knobs)
        packed = np.asarray(packed)
        trace.append((packed, np.asarray(d_t), np.asarray(d_p),
                      _positions(tc), _positions(dc)))
        for s in range(S):
            if not live[s]:
                continue
            n = int(packed[s, 0])
            new = packed[s, 3:3 + n].tolist()
            streams[s] += new
            rew[s] = max(k - n, 0)
            pvl[s] = n == k + 1
            ptk[s] = packed[s, 2]
            if new:
                tok0[s] = new[-1]
            if len(streams[s]) >= n_tokens or eos in new:
                live[s] = False
    return streams, trace


@pytest.mark.parametrize("draft", ["other", "self"])
def test_windows_match_jax(draft):
    """Several windows, lanes of different prompt lengths, one lane
    inactive: an independent draft (rejections and rewinds) and the
    target as its own draft (full acceptance: bonus and catch-up)."""
    jt, pt = _pair(1)
    jd, pd = _pair(2, blocks=1) if draft == "other" else (jt, pt)
    prompts = _prompts(3, [5, 11, 3])
    act = [True, True, False]
    ws, wtrace = _spec_drive(jt, jd, prompts, 4, 14, False, active=act)
    gs, gtrace = _spec_drive(pt, pd, prompts, 4, 14, True, active=act)
    assert gs == ws and gs[2] == [] and len(gs[0]) == 14
    assert len(gtrace) == len(wtrace)
    for (gp, gt, gq, gpos, gdpos), (wp, wt, wq, wpos, wdpos) in zip(
            gtrace, wtrace):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gt[:2], wt[:2])
        np.testing.assert_allclose(gq[:2], wq[:2], atol=1e-5)
        for a, b in zip(gpos + gdpos, wpos + wdpos):
            np.testing.assert_array_equal(a, b)
    accepted = sum(int(p[:2, 1].sum()) for p, *_ in gtrace)
    if draft == "self":
        assert all((p[:2, 1] == 4).all() for p, *_ in gtrace[:-1])
    else:
        assert accepted < 4 * 2 * len(gtrace)


def test_windows_are_k_invariant_and_equal_the_plain_window():
    _, pt = _pair(1)
    _, pd = _pair(2, blocks=1)
    prompts = _prompts(4, [7, 4])
    a, _ = _spec_drive(pt, pd, prompts, 4, 12, True)
    b, _ = _spec_drive(pt, pd, prompts, 8, 12, True)
    assert a == b
    from test_torch_sessions import _drive
    assert a == _drive(pt, None, prompts, 8, 12, True)


def test_windows_through_the_graph_buffers_equal_the_eager_calls():
    """`cuda_graphs` on (the static buffers of `NetGraphs`, called
    directly on the CPU) and off give the same rows and positions."""
    _, pt = _pair(1)
    _, pd = _pair(2, blocks=1)
    prompts = _prompts(5, [6, 9, 3])
    try:
        graphed = _spec_drive(pt, pd, prompts, 4, 10, True)
        pt.cuda_graphs = pd.cuda_graphs = False
        eager = _spec_drive(pt, pd, prompts, 4, 10, True)
    finally:
        pt.cuda_graphs = pd.cuda_graphs = True
    assert graphed[0] == eager[0]
    for g, e in zip(graphed[1], eager[1]):
        np.testing.assert_array_equal(g[0], e[0])
        np.testing.assert_array_equal(g[3][0], e[3][0])
    assert pt._graphs.stats["verify_window"]["eager"] >= len(graphed[1])
    assert pd._graphs.stats["propose_window"]["eager"] >= len(graphed[1])


def test_verify_stops_a_lane_at_its_eos_inside_a_window():
    _, pt = _pair(1)
    prompts = _prompts(6, [5])
    free, _ = _spec_drive(pt, pt, prompts, 8, 8, True)
    i = next(j for j in range(1, len(free[0]) - 1)
             if free[0][j] not in free[0][:j])
    got, trace = _spec_drive(pt, pt, prompts, 8, 8, True, eos=free[0][i])
    assert got[0] == free[0][:i + 1]
    # one self-draft window of 8 covered it: the EOS cut fell inside it
    assert len(trace) == 1 and int(trace[0][0][0, 0]) == i + 1


# ---------------------------------------------------- the session manager
def _plane(pkg, net, *, draft=None, spec_k=None, fused_k=None, slots=4,
           kv_dtype=None):
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
    mgr = DecodeSessionManager(registry, sched, "default", slots=slots,
                               prefill_chunk=8, fused_k=fused_k,
                               draft_net=draft, spec_k=spec_k,
                               kv_dtype=kv_dtype, metrics=stats.registry)
    return registry, sched, mgr


def _serve(pkg, net, prompts, *, max_tokens=10, eos_id=None, **kw):
    registry, sched, mgr = _plane(pkg, net, **kw)
    try:
        sessions = [mgr.open_session(p, max_tokens=max_tokens, greedy=True,
                                     eos_id=eos_id) for p in prompts]
        return [s.result(timeout=TIMEOUT) for s in sessions], \
            mgr.snapshot()
    finally:
        sched.shutdown()
        registry.close()


def test_manager_with_a_draft_serves_like_jax():
    jt, pt = _pair(1)
    jd, pd = _pair(2, blocks=1)
    prompts = _prompts(7, [5, 11, 17, 3])
    want, jsnap = _serve("jax", jt, prompts, draft=jd, spec_k=4)
    got, psnap = _serve("torch", pt, prompts, draft=pd, spec_k=4)
    assert got == want
    assert psnap["spec_decode"] == jsnap["spec_decode"]
    assert sorted(psnap) == sorted(jsnap)
    assert not psnap["prefix_cache"]["enabled"]
    # the target's slot pool and the draft's: B5 for both
    assert {(r["net"], r["kernel"]) for r in psnap["kernel_policy"]} == {
        ("target", "banded_decode_attention"),
        ("draft", "banded_decode_attention")}
    plain, _ = _serve("torch", pt, prompts, fused_k=8)
    assert got == plain


def test_self_draft_accepts_everything_and_counts_it():
    _, pt = _pair(1)
    prompts = _prompts(8, [4])
    got, snap = _serve("torch", pt, prompts, draft=pt, spec_k=4,
                       max_tokens=10)
    plain, _ = _serve("torch", pt, prompts, fused_k=8)
    assert got == plain
    sp = snap["spec_decode"]
    assert sp["accepted_tokens"] == sp["draft_tokens"] == 8
    assert sp["acceptance_rate"] == 1.0
    assert snap["dispatches"]["windows"] == 2


def test_budget_truncated_window_counts_only_emitted_drafts():
    _, pt = _pair(1)
    got, snap = _serve("torch", pt, _prompts(9, [3]), draft=pt, spec_k=4,
                       max_tokens=2)
    assert len(got[0]) == 2
    sp = snap["spec_decode"]
    assert (sp["draft_tokens"], sp["accepted_tokens"]) == (4, 2)
    assert sp["acceptance_rate"] == 0.5


def test_manager_stops_at_eos_inside_a_spec_window():
    _, pt = _pair(1)
    _, pd = _pair(2, blocks=1)
    prompts = _prompts(10, [6])
    (free,), _ = _serve("torch", pt, prompts, draft=pd, spec_k=8,
                        max_tokens=8)
    i = next(j for j in range(1, 7) if free[j] not in free[:j])
    (got,), snap = _serve("torch", pt, prompts, draft=pd, spec_k=8,
                          max_tokens=8, eos_id=free[i])
    assert got == free[:i + 1]
    assert snap["sessions"]["completed"] == 1


def test_budget_headroom_and_registry_entries():
    _, pt = _pair(1)
    _, pd = _pair(2, blocks=1)
    registry, sched, mgr = _plane("torch", pt, draft=pd, spec_k=8)
    try:
        assert "default@draft" in registry.names()
        limit = pt.decode_limit()
        with pytest.raises(ValueError, match="spec headroom"):
            mgr.open_session([1] * 4, max_tokens=limit - 4)
        mgr.open_session([1] * 4, max_tokens=limit - 4 - 9).cancel()
    finally:
        sched.shutdown()
        registry.close()


def test_cancel_frees_both_pools():
    _, pt = _pair(1)
    _, pd = _pair(2, blocks=1)
    registry, sched, mgr = _plane("torch", pt, draft=pd, spec_k=4)
    try:
        sess = mgr.open_session([1, 2, 3], max_tokens=20)
        deadline = time.monotonic() + TIMEOUT
        while not sess.generated and time.monotonic() < deadline:
            time.sleep(0.002)
        assert sess.generated, "no window landed"
        slot = sess.slot
        sess.cancel()
        assert sess.done.wait(TIMEOUT)
        assert sess.outcome == "cancelled"
        assert mgr.pool.describe()["in_use"] == 0
        for pool in (mgr.pool, mgr.draft_pool):
            for layer in pool.carries.values():
                for leaf in (layer.get("attn", layer)).values():
                    if leaf.ndim and leaf.shape[0] == pool.slots:
                        assert not leaf[slot].any()
    finally:
        sched.shutdown()
        registry.close()


def test_rolling_target_degrades_to_plain():
    _, rolling = _pair(3, pos_encoding="rope", window=6,
                       rolling_cache=True)
    _, pd = _pair(2, blocks=1)
    registry, sched, mgr = _plane("torch", rolling, draft=pd, spec_k=4)
    try:
        assert not mgr.spec_enabled and mgr.draft_pool is None
        assert mgr.snapshot()["spec_decode"]["enabled"] is False
        sess = mgr.open_session([1, 2, 3], max_tokens=6, greedy=True)
        assert len(sess.result(timeout=TIMEOUT)) == 6
    finally:
        sched.shutdown()
        registry.close()


def test_int8_spec_streams_equal_int8_plain():
    _, pt = _pair(1)
    _, pd = _pair(2, blocks=1)
    prompts = _prompts(11, [5, 9])
    got, snap = _serve("torch", pt, prompts, draft=pd, spec_k=4,
                       kv_dtype="int8")
    plain, _ = _serve("torch", pt, prompts, fused_k=8, kv_dtype="int8")
    assert got == plain
    assert snap["slots"]["kv_dtype"] == "int8"
