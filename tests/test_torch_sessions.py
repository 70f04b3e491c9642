"""Decode serving of the PyTorch port against the JAX package, on the
CPU: the slot-indexed `session_step` / `session_decode_window` seam and
the `DecodeSessionManager` over the continuous-batching scheduler, with
the prefix cache on (paged pool) and off (rolling ring).

Greedy streams must equal the JAX package's token for token (the
carried weights, first-occurrence argmax). Stochastic streams come from
the port's own counter-based generator, so they are compared with
themselves: seed-deterministic and invariant to the window length K.
EOS follows the documented contract: a lane stops AT its EOS token."""

import functools

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.ops import kernel_defaults as kd
from deeplearning4j_tpu_torch.utils import sampling

V = 256
VARIANTS = {
    # learned positions, layer norm, GELU: prefix cache on (paged pool)
    "paged": (dict(), 8),
    # RoPE, RMSNorm, SwiGLU, GQA 4:2, window 6 on a rolling ring: the
    # prefix cache cannot page it (slot pool)
    "rolling": (dict(pos_encoding="rope", norm="rms",
                     ffn_activation="swiglu", num_kv_heads=2, window=6,
                     rolling_cache=True), None),
}


@functools.lru_cache(maxsize=None)
def _build(name):
    kw, page_len = VARIANTS[name]
    jconf = JaxTGT(input_shape=(32, 1), d_model=32, num_heads=4,
                   num_blocks=2, **kw).conf()
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return name, page_len, jnet, pnet


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def nets(request):
    return _build(request.param)


def _carries(net, S, page_len, torch_side):
    if page_len is None:
        return net.session_carries(S)
    c = net.session_carries(S, page_len=page_len)
    npg = 32 // page_len
    table = np.arange(S * npg, dtype=np.int32).reshape(S, npg)[::-1].copy()
    if torch_side:
        for layer in c.values():
            if "attn" in layer:
                layer["attn"]["page_table"].copy_(torch.from_numpy(table))
        return c
    import jax.numpy as jnp
    return {n: ({"attn": dict(layer["attn"],
                              page_table=jnp.asarray(table))}
                if "attn" in layer else layer)
            for n, layer in c.items()}


def _drive(net, page_len, prompts, k, n_tokens, torch_side, *,
           greedy=True, seeds=None, eos=None, active=None):
    """Prefill each lane's prompt stem in padded chunks of 8 through
    `session_step`, then decode through `session_decode_window` until
    every lane has `n_tokens` (or stopped). Returns per-lane streams."""
    S = len(prompts)
    c = _carries(net, S, page_len, torch_side)
    act = np.ones(S, bool) if active is None else np.asarray(active)
    stems = [p[:-1] for p in prompts]
    off = 0
    while any(off < len(s) for s in stems):
        tok = np.zeros((S, 8), np.float32)
        val = np.zeros((S, 8), np.float32)
        for i, s in enumerate(stems):
            part = s[off:off + 8]
            tok[i, :len(part)] = part
            val[i, :len(part)] = 1.0
        lane = act & (val.sum(1) > 0)
        _, c = net.session_step(tok[:, :, None], c, active=lane, valid=val)
        off += 8
    streams = [[] for _ in range(S)]
    first = np.array([p[-1] for p in prompts], np.int32)
    keys = np.zeros((S, 2), np.uint32)
    if seeds is not None:
        keys[:, 1] = seeds
    eos_ids = np.full(S, -1 if eos is None else eos, np.int32)
    live = act.copy()
    while live.any():
        offs = np.array([len(s) for s in streams], np.int32)
        toks, emits, c = net.session_decode_window(
            first, c, active=live, k=k,
            temperature=np.full(S, 0.9, np.float32),
            top_k=np.full(S, 50, np.int32), top_p=np.full(S, 0.95,
                                                        np.float32),
            greedy=np.full(S, greedy), keys=keys, offsets=offs,
            budgets=n_tokens - offs, eos_ids=eos_ids)
        toks, emits = np.asarray(toks), np.asarray(emits)
        for i in range(S):
            new = [int(t) for t, e in zip(toks[i], emits[i]) if e]
            streams[i] += new
            if new:
                first[i] = new[-1]
            if len(streams[i]) >= n_tokens or (
                    eos is not None and eos in new):
                live[i] = False
    return streams


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, n) for n in lengths]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_greedy_windows_match_jax(nets, k):
    """Several windows (20 tokens), lanes of different prompt lengths,
    one lane inactive throughout."""
    _, page_len, jnet, pnet = nets
    prompts = _prompts(3, [5, 13, 9])
    active = [True, True, False]
    want = _drive(jnet, page_len, prompts, k, 20, False, active=active)
    got = _drive(pnet, page_len, prompts, k, 20, True, active=active)
    assert got == want
    assert got[2] == [] and all(len(s) == 20 for s in got[:2])


def test_greedy_is_k_invariant(nets):
    _, page_len, _, pnet = nets
    prompts = _prompts(4, [7, 3])
    one = _drive(pnet, page_len, prompts, 1, 17, True)
    assert _drive(pnet, page_len, prompts, 8, 17, True) == one
    assert _drive(pnet, page_len, prompts, 4, 17, True) == one


def test_stochastic_streams_are_seeded_and_k_invariant(nets):
    _, page_len, _, pnet = nets
    a, b = _prompts(5, [6, 6])
    prompts = [a, b, a]
    seeds = np.array([11, 12, 11], np.uint32)
    k1 = _drive(pnet, page_len, prompts, 1, 16, True, greedy=False,
                seeds=seeds)
    k8 = _drive(pnet, page_len, prompts, 8, 16, True, greedy=False,
                seeds=seeds)
    assert k1 == k8
    # same prompt and seed -> same stream; another seed -> another stream
    assert k1[0] == k1[2]
    assert k1[0] != k1[1]
    assert k1 != _drive(pnet, page_len, prompts, 4, 16, True,
                        greedy=False, seeds=seeds + 100)


def test_eos_inside_a_window_stops_the_lane_at_the_eos(nets):
    _, page_len, _, pnet = nets
    prompts = _prompts(6, [4])
    free = _drive(pnet, page_len, prompts, 8, 8, True)[0]
    i = next(j for j in range(1, len(free)) if free[j] not in free[:j])
    assert i < len(free) - 1, "stream too repetitive for this net"
    got = _drive(pnet, page_len, prompts, 8, 8, True, eos=free[i])[0]
    assert got == free[:i + 1]


# ---------------------------------------------------- the session manager
def _serve(pkg, net, prompts, *, page_len=None, k=4, max_tokens=10,
           eos_id=None):
    if pkg == "jax":
        from deeplearning4j_tpu.serving import (
            ContinuousBatchingScheduler, DecodeSessionManager,
            ModelRegistry, ServingStats,
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
    mgr = DecodeSessionManager(registry, sched, "default", slots=4,
                               prefill_chunk=8, fused_k=k,
                               page_len=page_len, metrics=stats.registry)
    try:
        out = []
        for wave in prompts:
            sessions = [mgr.open_session(p, max_tokens=max_tokens,
                                         greedy=True, eos_id=eos_id)
                        for p in wave]
            out.append([s.result(timeout=120) for s in sessions])
        return out, mgr.snapshot()
    finally:
        sched.shutdown()
        registry.close()


def test_manager_serves_four_sessions_like_jax(nets):
    name, page_len, jnet, pnet = nets
    wave = _prompts(7, [5, 11, 17, 3])
    want, jsnap = _serve("jax", jnet, [wave], page_len=page_len)
    got, psnap = _serve("torch", pnet, [wave], page_len=page_len)
    assert got == want
    assert psnap["prefix_cache"]["enabled"] == (name == "paged")
    assert psnap["prefix_cache"]["enabled"] == \
        jsnap["prefix_cache"]["enabled"]
    kernel = ("paged_decode_attention" if name == "paged"
              else "banded_decode_attention")
    assert {r["kernel"] for r in psnap["kernel_policy"]} == {kernel}


def test_warm_prefix_session_equals_cold():
    _, page_len, _, pnet = _build("paged")
    stem = _prompts(8, [20])[0]
    waves = [[stem], [stem, np.concatenate([stem, [5, 6]])]]
    ((cold,),), _ = _serve("torch", pnet, waves[:1], page_len=page_len)
    ((w1,), (w2, _)), snap = _serve("torch", pnet, waves,
                                    page_len=page_len)
    assert w1 == cold and w2 == cold
    assert snap["prefix_cache"]["hits"] >= 2
    assert snap["prefix_cache"]["hit_tokens"] >= 2 * 16


def test_manager_stops_at_eos(nets):
    _, page_len, _, pnet = nets
    wave = _prompts(12, [6])
    (free,), _ = _serve("torch", pnet, [wave], page_len=page_len, k=8,
                        max_tokens=8)
    i = next(j for j in range(2, 7) if free[0][j] not in free[0][:j])
    (got,), snap = _serve("torch", pnet, [wave], page_len=page_len, k=8,
                          max_tokens=8, eos_id=free[0][i])
    assert got[0] == free[0][:i + 1]
    assert snap["sessions"]["completed"] == 1


# --------------------------------------------------- sampling and policy
def test_warp_matches_jax_and_greedy_takes_the_first_maximum():
    import jax.numpy as jnp
    from deeplearning4j_tpu.utils.sampling import (
        warp_probs_lanes as jax_warp,
    )

    rng = np.random.default_rng(0)
    p = rng.random((4, 12)).astype(np.float32)
    p[1, 3] = p[1, 7] = p[1].max() + 1.0      # a tie: first index wins
    p /= p.sum(1, keepdims=True)
    temp = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
    tk = np.array([12, 3, 5, 1], np.int32)
    tp = np.array([1.0, 0.9, 0.5, 1.0], np.float32)
    want = np.asarray(jax_warp(jnp.asarray(p), jnp.asarray(temp),
                               jnp.asarray(tk), jnp.asarray(tp)))
    got = sampling.warp_probs_lanes(torch.from_numpy(p),
                                    torch.from_numpy(temp),
                                    torch.from_numpy(tk).long(),
                                    torch.from_numpy(tp)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    keys = torch.zeros((4, 2), dtype=torch.int64)
    tok = sampling.sample_token_lanes(
        torch.from_numpy(p), torch.from_numpy(temp),
        torch.from_numpy(tk).long(), torch.from_numpy(tp),
        torch.ones(4, dtype=torch.bool), keys, torch.zeros(4).long())
    assert tok.tolist()[1] == 3


def test_lane_uniforms_are_a_pure_function_of_seed_and_counter():
    keys = torch.tensor([[0, 1], [0, 1], [7, 2 ** 32 - 1]])
    u = sampling.lane_uniforms(keys, torch.tensor([5, 5, 5]))
    assert u[0] == u[1] and u[0] != u[2]
    many = sampling.lane_uniforms(keys[:1].expand(4096, 2),
                                  torch.arange(4096))
    assert float(many.min()) >= 0.0 and float(many.max()) < 1.0
    assert abs(float(many.mean()) - 0.5) < 0.03


def test_policies_keep_the_jax_defaults():
    loop = kd.decode_loop_policy(record=False)
    assert (loop.kind, loop.k) == ("fused", 8)
    assert kd.decode_loop_policy(3, record=False).k == 4
    assert kd.decode_loop_policy(capable=False, record=False).k == 1
    assert kd.kv_dtype_policy(record=False).kind == "native"
    assert kd.kv_dtype_policy("int8", record=False).kind == "int8"
    pc = kd.prefix_cache_policy(max_cache=2048, record=False)
    assert (pc.kind, pc.page_len) == ("paged", 128)
    # any divisor is a legal page on the card: no 128-multiple rule
    assert kd.prefix_cache_policy(8, max_cache=32, record=False).page_len == 8
    assert kd.prefix_cache_policy(max_cache=2303, capable=False,
                                  record=False).kind == "off"
    for paged, kernel in ((True, "paged_decode_attention"),
                          (False, "banded_decode_attention")):
        assert kd.decode_attention_policy(8, 2, 64, paged=paged,
                                          record=False).kernel == kernel


# (DL4J_TPU_PREFIX_CACHE, DL4J_TPU_KV_PAGE, capable, page_len, max_cache)
PREFIX_ENV_CASES = [
    (None, None, True, None, 2048), ("off", None, True, None, 2048),
    ("on", None, True, None, 2048), ("on", None, False, None, 2048),
    (None, None, False, None, 2048), ("auto", None, True, 64, 2048),
    (None, "8", True, None, 32), ("on", "12", True, 4, 32),
    ("off", "8", True, 8, 32)]


@pytest.mark.parametrize("force,page,capable,page_len,max_cache",
                         PREFIX_ENV_CASES)
def test_prefix_cache_policy_reads_the_environment_as_jax(
        monkeypatch, force, page, capable, page_len, max_cache):
    """C20: both packages choose the same mode, page length and reason
    under each `DL4J_TPU_PREFIX_CACHE` / `DL4J_TPU_KV_PAGE` setting."""
    from deeplearning4j_tpu.ops import kernel_defaults as jkd

    for name, value in (("DL4J_TPU_PREFIX_CACHE", force),
                        ("DL4J_TPU_KV_PAGE", page)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    kw = dict(max_cache=max_cache, capable=capable, record=False)
    got = kd.prefix_cache_policy(page_len, **kw)
    want = jkd.prefix_cache_policy(page_len, **kw)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("h,hkv,dh", [(16, 1, 64), (8, 8, 256), (8, 8, 63)])
def test_decode_kernels_refuse_shapes_past_their_register_tiles(h, hkv, dh):
    """There is no dense decode path on the card: a shape the CUDA
    kernels cannot take is refused by the policy (before a session runs)
    and by the wrappers' checks; on the CPU the plain version serves."""
    with pytest.raises(ValueError):
        kd.decode_attention_policy(h, hkv, dh, paged=True, device="cuda",
                                   record=False)
    assert kd.decode_attention_policy(h, hkv, dh, paged=True, device="cpu",
                                      record=False).kernel == \
        "paged_decode_attention"
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    q = torch.zeros(2, h, dh)
    ck = torch.zeros(2, 8, hkv, dh)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        ba._check_cuda(dict(q=q, cache_k=ck, cache_v=ck, qpos=pos, end=pos),
                       torch.float32)


def test_quantized_kv_is_refused_until_its_scale_rows_are_ported(nets):
    """The scale rows are ported: an int8 request builds int8 caches with
    float32 [N, L, Hkv] scale rows beside them, in every attention
    layer, slot and paged pools alike."""
    _, page_len, _, pnet = nets
    carries = pnet.session_carries(2, kv_dtype="int8", page_len=page_len)
    blocks = [c["attn"] for c in carries.values() if "attn" in c]
    assert blocks
    for attn in blocks:
        assert attn["cache_k"].dtype == attn["cache_v"].dtype == torch.int8
        assert attn["scale_k"].dtype == torch.float32
        assert attn["scale_v"].shape == attn["cache_k"].shape[:3]


def test_pool_free_resets_the_slot_and_pages_follow_their_refcounts():
    from deeplearning4j_tpu_torch.serving import (
        KVSlotPool, SlotPoolExhaustedError,
    )
    from deeplearning4j_tpu_torch.observe import MetricsRegistry

    _, page_len, _, pnet = _build("paged")
    pool = KVSlotPool(pnet, 2, metrics=MetricsRegistry(),
                      page_len=page_len)
    a, b = pool.alloc(), pool.alloc()
    with pytest.raises(SlotPoolExhaustedError):
        pool.alloc()
    with pool.lock():
        pages = pool.page_alloc_locked(3)
        pool.install_pages_locked(a, pages, 5)
        pool.page_ref_locked(pages[0])            # a second holder
    attn = next(c["attn"] for c in pool.carries.values() if "attn" in c)
    assert attn["page_table"][a, :3].tolist() == pages
    assert int(attn["pos"][a]) == 5
    pool.free(a)
    assert int(attn["pos"][a]) == 0
    assert attn["page_table"][a].tolist() == [0] * attn["page_table"].shape[1]
    with pool.lock():
        free_before = pool.pages_free_locked()
        for p in pages:
            pool.page_unref_locked(p)
        # the shared page survives its first release
        assert pool.pages_free_locked() == free_before + 2
        pool.page_unref_locked(pages[0])
        assert pool.pages_free_locked() == free_before + 3
        with pytest.raises(ValueError):
            pool.page_unref_locked(pages[0])
    assert pool.alloc() == a
    pool.free(b)


def test_concurrent_sessions_over_several_workers_keep_their_streams():
    """12 sessions through 4 slots (admission waits for a free slot) and
    3 scheduler workers, with a short thread switch interval: every
    greedy stream equals the same prompt served alone."""
    import sys
    import threading

    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, DecodeSessionManager, ModelRegistry,
        ServingStats,
    )

    _, page_len, _, pnet = _build("paged")
    prompts = _prompts(13, [3, 9, 17, 5, 12, 7, 20, 4, 11, 6, 15, 8])
    alone = [_serve("torch", pnet, [[p]], page_len=page_len)[0][0][0]
             for p in prompts[:3]]
    registry = ModelRegistry()
    registry.deploy("default", 1, pnet, warm=False)
    stats = ServingStats()
    sched = ContinuousBatchingScheduler(registry, stats, max_batch_size=8,
                                        slots=3)
    mgr = DecodeSessionManager(registry, sched, "default", slots=4,
                               prefill_chunk=8, fused_k=4,
                               page_len=page_len, metrics=stats.registry)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    results = [None] * len(prompts)
    try:
        def client(i):
            s = mgr.open_session(prompts[i], max_tokens=10, greedy=True,
                                 alloc_timeout_s=60)
            results[i] = s.result(timeout=120)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        sched.shutdown()
        registry.close()
    assert results[:3] == alone
    assert all(r is not None and len(r) == 10 for r in results)
    # the same prompt twice in a row gives the same stream
    again = _serve("torch", pnet, [[prompts[6]]], page_len=page_len)[0][0][0]
    assert results[6] == again


def test_session_teardown_returns_its_pages_before_its_slot():
    """An admission blocked on a free slot counts free pages as soon as
    it gets the slot, so a finishing session gives its pages back first,
    in the same critical section: no page may come free after the slot
    has. (With the slot freed first, 12 sessions through 4 slots could
    find 'need 4 KV pages, 3 free'.)"""
    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, DecodeSessionManager, ModelRegistry,
        ServingStats,
    )

    _, page_len, _, pnet = _build("paged")
    registry = ModelRegistry()
    registry.deploy("default", 1, pnet, warm=False)
    stats = ServingStats()
    sched = ContinuousBatchingScheduler(registry, stats, max_batch_size=8)
    mgr = DecodeSessionManager(registry, sched, "default", slots=2,
                               prefill_chunk=8, fused_k=4,
                               page_len=page_len, metrics=stats.registry)
    pool = mgr.pool
    at_free = []
    free_locked = pool.free_locked

    def spy(slot):
        at_free.append(pool.pages_free_locked())
        free_locked(slot)

    pool.free_locked = spy
    try:
        for p in _prompts(21, [9, 14]):
            mgr.open_session(p, max_tokens=10, greedy=True).result(
                timeout=120)
            with pool.lock():
                after = pool.pages_free_locked()
            assert at_free[-1] == after
    finally:
        sched.shutdown()
        registry.close()
