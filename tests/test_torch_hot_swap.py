"""Hot-swap of the PyTorch port's serving (`ModelRegistry.deploy` with
the decode-session manager's deploy hooks and `KVSlotPool.rebind`)
against the JAX package, on the CPU: a 2-block TextGenerationTransformer
(d_model 32, vocabulary 64), weights carried from JAX.

Live sessions survive a deploy and finish; sessions opened after it
decode with the new weights, token for token as the JAX package's; a
candidate the live sessions cannot move onto rolls back with the
sessions untouched, as JAX's `test_hot_swap_refuses_unrewindable_
candidate` pins. Every wait has a timeout; every plane is shut down in a
`finally`."""

import functools
import time

import numpy as np
import pytest

import jax

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration

V = 64
TIMEOUT = 60


@functools.lru_cache(maxsize=None)
def _pair(seed, **kw):
    jconf = JaxTGT(num_classes=V, input_shape=(64, 1), d_model=32,
                   num_heads=4, num_blocks=2, seed=seed, **kw).conf()
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return jnet, pnet


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
                               prefill_chunk=8, metrics=stats.registry,
                               **kw)
    return registry, sched, mgr


def _close(registry, sched):
    sched.shutdown()
    registry.close()


def _alone(pkg, net, prompt, n, **kw):
    registry, sched, mgr = _plane(pkg, net, **kw)
    try:
        return mgr.open_session(prompt, max_tokens=n, greedy=True).result(
            timeout=TIMEOUT)
    finally:
        _close(registry, sched)


def _wait_tokens(sessions, n=1):
    deadline = time.monotonic() + TIMEOUT
    while any(len(s.generated) < n for s in sessions):
        assert time.monotonic() < deadline, "no window landed"
        time.sleep(0.002)


PROMPTS = ([3, 14, 15, 9, 2], [6, 5, 35])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("kw", [dict(), dict(page_len=8),
                                dict(kv_dtype="int8")],
                         ids=["slots", "paged", "int8"])
def test_deploy_mid_stream_keeps_sessions_and_serves_v2(pkg, kw):
    """Two sessions mid-stream survive the flip and complete; a session
    opened after `deploy()` returns equals v2's stream served alone, and
    that stream is the same in both packages."""
    j1, p1 = _pair(1)
    j2, p2 = _pair(4)
    v1, v2 = (j1, j2) if pkg == "jax" else (p1, p2)
    registry, sched, mgr = _plane(pkg, v1, **kw)
    try:
        live = [mgr.open_session(p, max_tokens=40, greedy=True)
                for p in PROMPTS]
        _wait_tokens(live)
        registry.deploy("default", 2, v2, feat_shape=(64, 1))
        after = mgr.open_session(PROMPTS[0], max_tokens=12, greedy=True)
        got = after.result(timeout=TIMEOUT)
        for s in live:
            assert len(s.result(timeout=TIMEOUT)) == 40
            assert s.outcome == "completed"
        assert registry.get("default").version == 2
        assert mgr.entry.version == 2 and mgr.pool.net is v2
    finally:
        _close(registry, sched)
    assert got == _alone(pkg, v2, PROMPTS[0], 12, **kw)
    if pkg == "torch":
        assert got == _alone("jax", j2, PROMPTS[0], 12, **kw)
        assert got != _alone("torch", p1, PROMPTS[0], 12, **kw)


def test_rebind_keeps_the_live_caches_where_they_lie():
    _, p1 = _pair(1)
    _, p2 = _pair(4)
    registry, sched, mgr = _plane("torch", p1)
    try:
        before = {id(a): a.data_ptr() for layer in mgr.pool.carries.values()
                  for a in layer.get("attn", {}).values()}
        registry.deploy("default", 2, p2, feat_shape=(64, 1))
        after = {id(a): a.data_ptr() for layer in mgr.pool.carries.values()
                 for a in layer.get("attn", {}).values()}
        assert after == before
        n0 = p2._graphs.stats["decode_window"]["eager"]
        mgr.open_session([1, 2, 3], max_tokens=8, greedy=True).result(
            timeout=TIMEOUT)
        # the windows after the flip ran the new net's (graphed) call
        assert p2._graphs.stats["decode_window"]["eager"] >= n0 + 2
    finally:
        _close(registry, sched)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_incompatible_candidate_rolls_back_with_sessions_untouched(pkg):
    """A candidate with 2 KV heads under 4 cannot host the live caches:
    deploy raises DeployRolledBackError, version 1 keeps serving, and the
    live sessions finish with v1's stream."""
    j1, p1 = _pair(1)
    jg, pg = _pair(5, num_kv_heads=2)
    v1, bad = (j1, jg) if pkg == "jax" else (p1, pg)
    if pkg == "jax":
        from deeplearning4j_tpu.serving.registry import (
            DeployRolledBackError,
        )
    else:
        from deeplearning4j_tpu_torch.serving import DeployRolledBackError
    want = _alone(pkg, v1, PROMPTS[1], 30)
    registry, sched, mgr = _plane(pkg, v1)
    try:
        live = mgr.open_session(PROMPTS[1], max_tokens=30, greedy=True)
        _wait_tokens([live])
        with pytest.raises(DeployRolledBackError):
            registry.deploy("default", 2, bad, feat_shape=(64, 1))
        assert live.result(timeout=TIMEOUT) == want
        assert registry.get("default").version == 1
        assert mgr.pool.net is v1
        assert mgr.open_session(PROMPTS[1], max_tokens=30,
                                greedy=True).result(timeout=TIMEOUT) == want
    finally:
        _close(registry, sched)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_hot_swap_refuses_unrewindable_candidate(pkg):
    """JAX's own case: a rolling-ring candidate onto a speculating
    manager rolls back; the manager keeps serving."""
    j1, p1 = _pair(1)
    jr, pr = _pair(6, pos_encoding="rope", window=6, rolling_cache=True)
    v1, rolling = (j1, jr) if pkg == "jax" else (p1, pr)
    if pkg == "jax":
        from deeplearning4j_tpu.serving.registry import (
            DeployRolledBackError,
        )
    else:
        from deeplearning4j_tpu_torch.serving import DeployRolledBackError
    registry, sched, mgr = _plane(pkg, v1, draft_net=v1, spec_k=4)
    try:
        with pytest.raises(DeployRolledBackError):
            registry.deploy("default", 2, rolling, feat_shape=(64, 1))
        sess = mgr.open_session([1, 2], max_tokens=4, greedy=True)
        assert len(sess.result(timeout=TIMEOUT)) == 4
    finally:
        _close(registry, sched)


def test_spec_manager_migrates_to_v2():
    """A speculating manager (the target as its own draft's source of
    truth): after the flip the verify runs v2 and the stream equals v2's
    plain stream; the draft is not part of the deploy."""
    _, p1 = _pair(1)
    _, p2 = _pair(4)
    registry, sched, mgr = _plane("torch", p1, draft_net=p1, spec_k=4)
    try:
        registry.deploy("default", 2, p2, feat_shape=(64, 1))
        got = mgr.open_session(PROMPTS[0], max_tokens=12,
                               greedy=True).result(timeout=TIMEOUT)
        assert mgr.draft_pool.net is p1
    finally:
        _close(registry, sched)
    assert got == _alone("torch", p2, PROMPTS[0], 12)


def test_failing_hook_or_warm_up_rolls_back_and_counts():
    from deeplearning4j_tpu_torch.observe import get_registry
    from deeplearning4j_tpu_torch.serving import DeployRolledBackError

    _, p1 = _pair(1)
    _, p2 = _pair(4)
    registry, sched, mgr = _plane("torch", p1)
    c = get_registry().counter("serving_deploy_rollbacks_total",
                               model="default")
    before = c.value
    calls = []

    def hook(phase, name, version, net):
        calls.append(phase)
        if phase == "warm":
            raise RuntimeError("canary says no")

    try:
        registry.add_deploy_hook("default", hook)
        with pytest.raises(DeployRolledBackError, match="canary"):
            registry.deploy("default", 2, p2, feat_shape=(64, 1))
        registry.remove_deploy_hook("default", hook)
        with pytest.raises(DeployRolledBackError):
            registry.deploy("default", 3, p2, feat_shape=(7, 5))
        assert c.value == before + 2 and calls == ["warm"]
        assert registry.get("default").version == 1
        assert mgr.open_session([4, 5], max_tokens=3, greedy=True).result(
            timeout=TIMEOUT)
        registry.deploy("default", 4, p2, feat_shape=(64, 1))
        assert registry.summary()["default"]["deployments"] == 2
    finally:
        _close(registry, sched)


def test_flip_flushes_the_prefix_cache():
    _, p1 = _pair(1)
    _, p2 = _pair(4)
    stem = list(range(1, 20))
    registry, sched, mgr = _plane("torch", p1, page_len=8)
    try:
        mgr.open_session(stem, max_tokens=3, greedy=True).result(
            timeout=TIMEOUT)
        assert mgr.snapshot()["prefix_cache"]["cached_pages"] > 0
        registry.deploy("default", 2, p2, feat_shape=(64, 1))
        snap = mgr.snapshot()["prefix_cache"]
        assert snap["cached_pages"] == 0
        got = mgr.open_session(stem, max_tokens=6, greedy=True).result(
            timeout=TIMEOUT)
        assert mgr.snapshot()["prefix_cache"]["hits"] == snap["hits"]
    finally:
        _close(registry, sched)
    assert got == _alone("torch", p2, stem, 6, page_len=8)


def test_pool_rebind_refuses_another_kv_dtype():
    from deeplearning4j_tpu_torch.observe import MetricsRegistry
    from deeplearning4j_tpu_torch.serving import (
        IncompatibleSessionSwapError, KVSlotPool,
    )

    _, p1 = _pair(1)
    _, p2 = _pair(4)
    pool = KVSlotPool(p1, 2, metrics=MetricsRegistry(), kv_dtype="int8")
    pool.rebind(p2)
    assert pool.net is p2
    with pytest.raises(IncompatibleSessionSwapError):
        pool.rebind(p1, kv_dtype="native")
    slot = pool.alloc()
    attn = next(c["attn"] for c in pool.carries.values() if "attn" in c)
    attn["pos"][slot] = 5
    attn["scale_k"][slot].fill_(1.0)
    pool.reset(slot)
    assert int(attn["pos"][slot]) == 0 and not attn["scale_k"][slot].any()
    assert pool.describe()["in_use"] == 1
