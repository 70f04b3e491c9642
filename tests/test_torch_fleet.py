"""The serving fleet of the PyTorch port against the JAX package, on the
CPU: the "kv-handoff-v1" wire format, KV pages handed between the two
packages' paged pools, prefill-only sessions, the router over in-process
replicas on 127.0.0.1, and replica processes from the launcher.

What these pin:
  * the wire format: float32, int8 with scale rows, float8_e4m3fn and
    bfloat16 leaves round-trip bit-exactly; the port writes the very
    entries JAX's `_leaves_to_wire` writes for the same arrays, and each
    package decodes the other's to the same bytes
  * across packages: a warm stem exported from a JAX paged plane (two
    full pages and a partial tail, float32 and int8) installs into a
    port plane on JAX's weights, re-exports byte for byte, and the
    port's greedy stream equals JAX's uninterrupted one; and the other
    way round
  * within the port, JAX's `TestKVPageRoundTrip` / `TestPrefillOnly`
    cases: a copy-on-write-forked page exports, a duplicate install
    leaks no page, a dtype mismatch and bad payloads are refused,
    prefill-only indexes the stem and needs a paged pool; an import
    writes the live page tensors in place
  * the router (JAX's `TestFleetRouter`, `TestRouterEdge`, `TestSLODrain`,
    `TestFleetDeploy`), every replica on JAX's weights through a builder
    registered here: disaggregated streams equal JAX's single-plane
    reference with every handoff counted, none failed, and the decode
    replica's radix hit for the whole stem; one causal trace tree, also
    stitched; sticky sessions; drain migrates and a draining replica
    refuses; `/healthz`; an empty fleet answers 503; an SLO breach
    drains and reroutes; a fleet deploy flips, then rolls back
    everywhere; a bad spec fails without flipping
  * the launcher: a `bench_lm` replica process on the CPU
    (`FLEET_REPLICA_PLATFORM=cpu`) streams what an in-process replica of
    the same spec streams; SIGKILL of a replica mid-stream (slow, chaos)
"""

import functools
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.serving.fleet import handoff as jax_handoff
from deeplearning4j_tpu.serving.fleet.replica_main import (
    build_bench_lm as jax_build_bench_lm,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.observe import reqtrace
from deeplearning4j_tpu_torch.serving.fleet import client, handoff
from deeplearning4j_tpu_torch.serving.fleet.handoff import (
    HandoffError, export_prefix, install_prefix, payload_bytes,
)
from deeplearning4j_tpu_torch.serving.fleet.replica import (
    register_model_builder,
)
from deeplearning4j_tpu_torch.serving.fleet.replica_main import (
    build_bench_lm, make_server,
)
from deeplearning4j_tpu_torch.serving.fleet.router import (
    FleetRouter, ReplicaHandle,
)
from deeplearning4j_tpu_torch.serving.kv_pool import (
    IncompatibleSessionSwapError,
)

V, T = 13, 6
LP = 4              # page length for every paged plane in this file


@pytest.fixture(autouse=True)
def _replicas_on_the_cpu(monkeypatch):
    # the port's replicas run on the card unless asked for the CPU
    monkeypatch.setenv("FLEET_REPLICA_PLATFORM", "cpu")


def _make_jax_net(seed=0, emb=12, max_len=64, window=8, max_cache=16,
                  rolling=False):
    """JAX's `tests/test_fleet.py` geometry: a non-rolling decode stack
    (rolling rings cannot page)."""
    from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.attention import (
        PositionEmbeddingLayer, TransformerEncoderBlock,
    )
    from deeplearning4j_tpu.nn.layers.feedforward import (
        EmbeddingSequenceLayer,
    )
    from deeplearning4j_tpu.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu.optim.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-3))
            .activation("identity")
            .list(EmbeddingSequenceLayer(n_in=V, n_out=emb),
                  PositionEmbeddingLayer(max_length=max_len),
                  TransformerEncoderBlock(num_heads=2, causal=True,
                                          window=window,
                                          rolling_cache=rolling,
                                          max_cache=max_cache),
                  RnnOutputLayer(n_out=V, activation="softmax"))
            .set_input_type(InputType.recurrent(1, T)).build())
    return JaxNet(conf).init()


def _twin(jnet):
    """The port's net on JAX's conf and weights, on the CPU."""
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return pnet


@functools.lru_cache(maxsize=None)
def _nets():
    jnet = _make_jax_net()
    return jnet, _twin(jnet)


def _plane(net, *, slots=2, chunk=4, page_len=LP, kv_dtype=None):
    """A paged decode plane of the package `net` belongs to."""
    if isinstance(net, MultiLayerNetwork):
        from deeplearning4j_tpu_torch.serving import (
            ContinuousBatchingScheduler, ModelRegistry, ServingStats,
        )
        from deeplearning4j_tpu_torch.serving.sessions import (
            DecodeSessionManager,
        )
    else:
        from deeplearning4j_tpu.serving import (
            ContinuousBatchingScheduler, ModelRegistry, ServingStats,
        )
        from deeplearning4j_tpu.serving.sessions import (
            DecodeSessionManager,
        )
    registry = ModelRegistry()
    registry.deploy("default", 1, net, warm=False)
    stats = ServingStats()
    sched = ContinuousBatchingScheduler(registry, stats, max_batch_size=8)
    mgr = DecodeSessionManager(registry, sched, "default", slots=slots,
                               prefill_chunk=chunk, page_len=page_len,
                               kv_dtype=kv_dtype, metrics=stats.registry)
    return registry, sched, mgr


def _close(*planes):
    for registry, sched, _ in planes:
        sched.shutdown()
        registry.close()


def _run(mgr, prompt, max_tokens=4, **kw):
    sess = mgr.open_session(np.asarray(prompt), max_tokens=max_tokens,
                            greedy=True, **kw)
    return [int(t) for t in sess.result(timeout=60)]


def _page_bytes(payload):
    """The raw per-page wire bytes, for bit-exactness comparisons."""
    return [{k: spec["data"] for k, spec in page.items()}
            for page in payload["pages"]]


# ------------------------------------------------------------ wire format
def _leaf_sets():
    """{name: {leaf key: (numpy array, torch tensor)}} with equal bytes:
    float32, int8 codes with float32 scale rows, e4m3 with scale rows,
    bfloat16 (numpy through JAX's `ml_dtypes`)."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((LP, 2, 8), dtype=np.float32)
    i8 = rng.integers(-128, 128, (LP, 2, 8), dtype=np.int8)
    sc = rng.standard_normal((LP, 2)).astype(np.float32)
    e4 = rng.standard_normal((LP, 2, 8)).astype(np.float32).astype(
        ml_dtypes.float8_e4m3fn)
    bf = rng.standard_normal((LP, 2, 8)).astype(np.float32).astype(
        ml_dtypes.bfloat16)

    def pair(a, dt):
        raw = bytearray(np.ascontiguousarray(a).tobytes())
        return a, torch.frombuffer(raw, dtype=torch.uint8).view(
            dt).reshape(a.shape)

    return {
        "float32": {"blk/cache_k": pair(f32, torch.float32),
                    "blk/cache_v": pair(-f32, torch.float32)},
        "int8": {"blk/cache_k": pair(i8, torch.int8),
                 "blk/scale_k": pair(sc, torch.float32),
                 "blk/cache_v": pair(i8[::-1].copy(), torch.int8),
                 "blk/scale_v": pair(sc * 2, torch.float32)},
        "float8_e4m3fn": {"blk/cache_k": pair(e4, torch.float8_e4m3fn),
                          "blk/scale_k": pair(np.ones((LP, 2), np.float32),
                                              torch.float32)},
        "bfloat16": {"blk/cache_k": pair(bf, torch.bfloat16)},
    }


class TestWireFormat:
    """kv-handoff-v1 leaf serialization, no pools involved."""

    @pytest.mark.parametrize("kind", ["float32", "int8", "float8_e4m3fn",
                                      "bfloat16"])
    def test_roundtrip_bit_exact(self, kind):
        leaves = {k: t for k, (_, t) in _leaf_sets()[kind].items()}
        wire = handoff._leaves_to_wire(leaves)
        # through real JSON: the payload crosses an HTTP hop
        back = handoff._wire_to_leaves(json.loads(json.dumps(wire)))
        assert set(back) == set(leaves)
        for key, t in leaves.items():
            got = back[key]
            assert got.dtype == t.dtype and got.shape == t.shape
            assert torch.equal(got.view(torch.uint8), t.view(torch.uint8))
        names = {k: w["dtype"] for k, w in wire.items()}
        assert kind in names.values()

    @pytest.mark.parametrize("kind", ["float32", "int8", "float8_e4m3fn",
                                      "bfloat16"])
    def test_wire_equals_jax_both_ways(self, kind):
        pairs = _leaf_sets()[kind]
        mine = handoff._leaves_to_wire({k: t for k, (_, t) in pairs.items()})
        theirs = jax_handoff._leaves_to_wire(
            {k: a for k, (a, _) in pairs.items()})
        # the same entries, letter for letter: dtype names, shapes, bytes
        assert mine == theirs
        from_jax = handoff._wire_to_leaves(json.loads(json.dumps(theirs)))
        from_port = jax_handoff._wire_to_leaves(json.loads(json.dumps(mine)))
        for key, (a, t) in pairs.items():
            assert from_jax[key].reshape(-1).view(torch.uint8).numpy(
            ).tobytes() == a.tobytes()
            assert str(from_port[key].dtype) == str(a.dtype)
            assert from_port[key].tobytes() == t.reshape(-1).view(
                torch.uint8).numpy().tobytes()

    def test_unknown_dtype_refused(self):
        with pytest.raises(HandoffError, match="unknown dtype"):
            handoff._wire_to_leaves(
                {"blk/cache_k": {"shape": [1], "dtype": "not_a_dtype",
                                 "data": "AA=="}})

    def test_short_data_refused(self):
        with pytest.raises(HandoffError, match="bytes for shape"):
            handoff._wire_to_leaves(
                {"blk/cache_k": {"shape": [2], "dtype": "float32",
                                 "data": "AAAAAA=="}})

    def test_payload_bytes_counts_decoded_bytes(self):
        t = torch.arange(24, dtype=torch.float32).reshape(2, 12)
        payload = {"pages": [handoff._leaves_to_wire({"k": t})]}
        assert payload_bytes(payload) == t.numel() * 4
        assert payload_bytes(payload) == jax_handoff.payload_bytes(payload)


# ------------------------------------------------- across the two packages
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]   # stem 10 = 2 full pages + 2


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["native", "int8"])
@pytest.mark.parametrize("donor", ["jax", "port"])
def test_handoff_across_packages(donor, kv_dtype):
    """A warm stem from one package's paged plane installs into the
    other's: the recipient re-exports the same bytes, its radix hits the
    whole stem, and its greedy stream equals the donor package's
    uninterrupted one."""
    jnet, pnet = _nets()
    jax_side = _plane(jnet, kv_dtype=kv_dtype)
    port_side = _plane(pnet, kv_dtype=kv_dtype)
    d, r = (jax_side, port_side) if donor == "jax" else \
        (port_side, jax_side)
    d_exp, r_inst = ((jax_handoff.export_prefix, install_prefix)
                     if donor == "jax" else
                     (export_prefix, jax_handoff.install_prefix))
    r_exp = export_prefix if donor == "jax" else jax_handoff.export_prefix
    try:
        d_mgr, r_mgr = d[2], r[2]
        donor_out = _run(d_mgr, PROMPT, max_tokens=4)
        stem = PROMPT[:-1]
        payload = d_exp(d_mgr.pool, d_mgr.prefix_cache, stem)
        assert payload["format"] == "kv-handoff-v1"
        assert (payload["cached_len"], payload["full_pages"],
                payload["partial_tokens"]) == (len(stem), 2, 2)
        if kv_dtype == "int8":
            specs = payload["pages"][0]
            assert {s["dtype"] for s in specs.values()} == {"int8",
                                                            "float32"}
            assert any(k.endswith("/scale_k") for k in specs)
        assert payload_bytes(payload) == jax_handoff.payload_bytes(payload)
        assert r_inst(r_mgr.pool, r_mgr.prefix_cache,
                      json.loads(json.dumps(payload))) == len(stem)
        back = r_exp(r_mgr.pool, r_mgr.prefix_cache, stem)
        assert back["tokens"] == payload["tokens"]
        assert _page_bytes(back) == _page_bytes(payload)
        before = r_mgr.prefix_cache.stats()
        warm = _run(r_mgr, PROMPT, max_tokens=4)
        assert warm == donor_out
        stats = r_mgr.prefix_cache.stats()
        assert stats["hits"] == before["hits"] + 1
        assert stats["hit_tokens"] == before["hit_tokens"] + len(stem)
    finally:
        _close(jax_side, port_side)


# ---------------------------------------------- page round trips, port only
class TestKVPageRoundTrip:
    """export_prefix -> install_prefix between two of the port's paged
    pools."""

    @pytest.fixture(params=[None, "int8"], ids=["native", "int8"])
    def planes(self, request):
        _, pnet = _nets()
        donor = _plane(pnet, kv_dtype=request.param)
        recip = _plane(pnet, kv_dtype=request.param)
        yield donor[2], recip[2]
        _close(donor, recip)

    def test_cow_forked_page_exports(self, planes):
        d_mgr, r_mgr = planes
        base = [1, 2, 3, 4, 5, 6, 7, 8]
        fork = base[:6] + [9, 10, 11]       # diverges mid-page 2
        _run(d_mgr, base, max_tokens=2)
        donor_out = _run(d_mgr, fork, max_tokens=4)
        assert d_mgr.prefix_cache.stats()["cow_forks"] >= 1
        payload = export_prefix(d_mgr.pool, d_mgr.prefix_cache, fork[:-1])
        assert payload["cached_len"] == len(fork) - 1
        install_prefix(r_mgr.pool, r_mgr.prefix_cache, payload)
        assert _run(r_mgr, fork, max_tokens=4) == donor_out

    def test_duplicate_install_leaks_nothing(self, planes):
        d_mgr, r_mgr = planes
        _run(d_mgr, PROMPT, max_tokens=4)
        payload = export_prefix(d_mgr.pool, d_mgr.prefix_cache, PROMPT[:-1])
        install_prefix(r_mgr.pool, r_mgr.prefix_cache, payload)
        with r_mgr.pool.lock():
            free_before = r_mgr.pool.pages_free_locked()
        cached_before = r_mgr.prefix_cache.stats()["cached_pages"]
        # second install: the radix declines every chunk (cached already)
        # and each fresh page must return to the free list
        install_prefix(r_mgr.pool, r_mgr.prefix_cache, payload)
        with r_mgr.pool.lock():
            assert r_mgr.pool.pages_free_locked() == free_before
        assert r_mgr.prefix_cache.stats()["cached_pages"] == cached_before

    def test_import_writes_the_live_pages_in_place(self, planes):
        """Decode-window graphs are captured over the caches' addresses:
        an import must write into the existing page tensors."""
        d_mgr, r_mgr = planes
        _run(d_mgr, PROMPT, max_tokens=2)
        payload = export_prefix(d_mgr.pool, d_mgr.prefix_cache, PROMPT[:-1])
        before = {k: a.data_ptr() for k, a in r_mgr.pool._cache_leaves()}
        install_prefix(r_mgr.pool, r_mgr.prefix_cache, payload)
        after = {k: a.data_ptr() for k, a in r_mgr.pool._cache_leaves()}
        assert before == after
        assert set(r_mgr.pool.cache_leaf_meta()) == set(payload["pages"][0])


def test_dtype_mismatch_refused():
    _, pnet = _nets()
    donor = _plane(pnet, kv_dtype="int8")
    recip = _plane(pnet, kv_dtype=None)
    try:
        d_mgr, r_mgr = donor[2], recip[2]
        _run(d_mgr, PROMPT, max_tokens=2)
        payload = export_prefix(d_mgr.pool, d_mgr.prefix_cache, PROMPT[:-1])
        with pytest.raises(HandoffError, match="kv_dtype mismatch"):
            install_prefix(r_mgr.pool, r_mgr.prefix_cache, payload)
        # below the payload check, the pool refuses the leaves with
        # JAX's text (leaf set, then shape/dtype)
        leaves = handoff._wire_to_leaves(payload["pages"][0])
        with r_mgr.pool.lock():
            with pytest.raises(IncompatibleSessionSwapError,
                               match="do not match this pool's cache"):
                r_mgr.pool.import_page_locked(0, leaves)
            native = {k: v for k, v in leaves.items() if "scale" not in k}
            with pytest.raises(IncompatibleSessionSwapError,
                               match="dtype-preserving install refused"):
                r_mgr.pool.import_page_locked(0, native)
    finally:
        _close(donor, recip)


def test_bad_payloads_refused():
    _, pnet = _nets()
    plane = _plane(pnet)
    mgr = plane[2]
    try:
        with pytest.raises(HandoffError, match="unknown handoff"):
            install_prefix(mgr.pool, mgr.prefix_cache,
                           {"format": "kv-handoff-v0"})
        good = {"format": "kv-handoff-v1", "page_len": LP,
                "kv_dtype": mgr.pool.kv_dtype, "cached_len": 0,
                "tokens": [], "full_pages": 0, "partial_tokens": 0,
                "pages": []}
        with pytest.raises(HandoffError, match="page_len mismatch"):
            install_prefix(mgr.pool, mgr.prefix_cache,
                           dict(good, page_len=LP + 1))
        with pytest.raises(HandoffError, match="payload carries"):
            install_prefix(mgr.pool, mgr.prefix_cache,
                           dict(good, tokens=[1]))
        with pytest.raises(HandoffError, match="page accounting"):
            install_prefix(mgr.pool, mgr.prefix_cache,
                           dict(good, tokens=[1, 2], cached_len=2,
                                partial_tokens=2))
    finally:
        _close(plane)


# ------------------------------------------------- prefill-only admission
class TestPrefillOnly:
    PROMPT = [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]

    def test_prefill_only_indexes_stem(self, monkeypatch):
        from deeplearning4j_tpu_torch import observe

        monkeypatch.setenv("DL4J_TPU_TRACE_SAMPLE", "1")
        prev = observe.set_trace_store(observe.TraceStore())
        _, pnet = _nets()
        plane = _plane(pnet)
        mgr = plane[2]
        try:
            rt = reqtrace.new_trace("fleet.prefill")
            sess = mgr.open_prefill(np.asarray(self.PROMPT), trace=rt)
            assert sess.result(timeout=60) == []    # no token generated
            assert sess.outcome == "completed"
            assert mgr.snapshot()["dispatches"]["windows"] == 0
            payload = export_prefix(mgr.pool, mgr.prefix_cache,
                                    self.PROMPT[:-1])
            assert payload["cached_len"] == len(self.PROMPT) - 1
            names = {s["name"] for s in
                     observe.get_trace_store().spans(rt.trace_id)}
            assert {"session.window", "session.close"} <= names
            kinds = [e["kind"] for e in observe.get_flight().events()
                     if e["data"].get("session") == sess.id]
            assert kinds[0] == "session_open" and kinds[-1] == \
                "session_close"
        finally:
            _close(plane)
            observe.set_trace_store(prev)

    def test_prefill_only_requires_paged_pool(self):
        # a rolling ring cannot page, so its pool has no prefix cache
        # (JAX's form, paging turned off on a capable net, follows)
        pnet = _twin(_make_jax_net(rolling=True))
        plane = _plane(pnet, page_len=None)
        assert not plane[2].prefix_enabled
        try:
            with pytest.raises(ValueError, match="prefill-only"):
                plane[2].open_prefill(np.asarray(self.PROMPT))
        finally:
            _close(plane)

    def test_prefill_only_requires_paged_pool_with_paging_off(
            self, monkeypatch):
        # JAX's case: the policy would otherwise page this capable net
        monkeypatch.setenv("DL4J_TPU_PREFIX_CACHE", "off")
        pnet = _twin(_make_jax_net())
        plane = _plane(pnet, page_len=None)
        assert not plane[2].prefix_enabled
        try:
            with pytest.raises(ValueError, match="prefill-only"):
                plane[2].open_prefill(np.asarray(self.PROMPT))
        finally:
            _close(plane)


# ---------------------------------------------------- router end-to-end
SPEC = {"kind": "jax_bench_lm", "seed": 0, "vocab": 17, "chunk": 4,
        "max_cache": 32, "blocks": 1}
ROUTER_PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]


@functools.lru_cache(maxsize=None)
def _jax_bench(items):
    return jax_build_bench_lm(dict(items, kind="bench_lm"))


def _jax_weights(spec):
    """A builder: the port's bench_lm on JAX's weights for `spec`."""
    return _twin(_jax_bench(tuple(sorted(spec.items()))))


register_model_builder("jax_bench_lm", _jax_weights)


def _replica_cfg(name, role, **kw):
    cfg = {"name": name, "role": role, "model": dict(SPEC),
           "decode_slots": 3, "prefill_chunk": 4, "page_len": LP}
    cfg.update(kw)
    return cfg


def _start_fleet(cfgs, **router_kw):
    """In-process replicas + a router, over real localhost HTTP."""
    servers = [make_server(c) for c in cfgs]
    handles = []
    for srv in servers:
        port = srv.start()
        handles.append((srv.replica_name, f"http://127.0.0.1:{port}",
                        srv.role))
    router_kw.setdefault("poll_interval", None)   # tests drive poll_once
    router = FleetRouter(handles, **router_kw)
    rport = router.start()
    return {"servers": {s.replica_name: s for s in servers},
            "router": router, "url": f"http://127.0.0.1:{rport}",
            "urls": {name: url for name, url, _ in handles}}


def _stop_fleet(fleet):
    fleet["router"].stop()
    for srv in fleet["servers"].values():
        srv.stop()


@functools.lru_cache(maxsize=None)
def _jax_ref(spec_items, prompt, max_tokens):
    """Greedy reference from a fresh single JAX plane of the spec."""
    plane = _plane(_jax_bench(spec_items), slots=3, chunk=4)
    try:
        return tuple(_run(plane[2], prompt, max_tokens=max_tokens))
    finally:
        _close(plane)


def _ref_tokens(spec, prompt, max_tokens):
    return list(_jax_ref(tuple(sorted(spec.items())), tuple(prompt),
                         max_tokens))


def _stream(url, body):
    """Consume one router SSE stream: (first_frame, tokens, terminal)."""
    first, tokens, terminal = None, [], None
    for ev in client.sse_events(url, "/generate", dict(body),
                                timeout=120.0):
        if first is None and "replica" in ev and "token" not in ev:
            first = ev
        if "token" in ev:
            tokens.append(int(ev["token"]))
        if "done" in ev or "error" in ev:
            terminal = ev
    return first, tokens, terminal


class TestFleetRouter:
    """One prefill + two decode replicas behind the router."""

    @pytest.fixture(scope="class")
    def fleet(self):
        mp = pytest.MonkeyPatch()
        mp.setenv("FLEET_REPLICA_PLATFORM", "cpu")
        fl = _start_fleet([_replica_cfg("pf0", "prefill"),
                           _replica_cfg("dc0", "decode"),
                           _replica_cfg("dc1", "decode")])
        yield fl
        _stop_fleet(fl)
        mp.undo()

    def test_disaggregated_parity_and_metrics(self, fleet, monkeypatch):
        monkeypatch.setenv("DL4J_TPU_TRACE_SAMPLE", "1")
        router = fleet["router"]
        ref16 = _ref_tokens(SPEC, ROUTER_PROMPT, 16)
        out = client.post_json(
            fleet["url"], "/generate",
            {"prompt_ids": ROUTER_PROMPT, "max_tokens": 8, "greedy": True,
             "stream": False})
        assert out["outcome"] == "completed"
        assert out["tokens"] == ref16[:8]
        # a best-effort handoff that failed would leave the decode
        # replica to prefill for itself with the same tokens: count it
        assert router._c_requests.value == 1
        assert router._c_handoffs.value == 1
        assert router._c_handoff_fail.value == 0
        assert router._c_handoff_bytes.value > 0
        assert router._c_failed.value == 0
        spans = reqtrace.get_trace_store().spans(out["trace_id"])
        (hand,) = [s for s in spans if s["name"] == "handoff"]
        assert hand["attrs"]["cached_len"] == len(ROUTER_PROMPT) - 1
        # the decode home's radix matched the handed-off stem: its
        # admission never re-prefilled the warm pages
        info = client.get_json(fleet["url"], "/fleet?refresh=1")
        prefix = info["info"][hand["attrs"]["dst"]]["decode"]["default"][
            "prefix"]
        assert prefix["hits"] == 1
        assert prefix["hit_tokens"] == len(ROUTER_PROMPT) - 1
        assert info["info"]["pf0"]["role"] == "prefill"
        windows = {n: s._decode["default"].snapshot()["dispatches"][
            "windows"] for n, s in fleet["servers"].items()}
        assert windows["pf0"] == 0 and windows[hand["attrs"]["dst"]] > 0

    def test_trace_spans_one_causal_tree(self, fleet, monkeypatch):
        monkeypatch.setenv("DL4J_TPU_TRACE_SAMPLE", "1")
        store = reqtrace.TraceStore()
        prev = reqtrace.set_trace_store(store)
        try:
            prompt = [2, 4, 6, 8, 10, 12, 1, 3, 5, 7, 9, 11]
            out = client.post_json(
                fleet["url"], "/generate",
                {"prompt_ids": prompt, "max_tokens": 4, "greedy": True,
                 "stream": False})
            spans = store.spans(out["trace_id"])
            stitched = client.get_json(fleet["url"],
                                       f"/trace/{out['trace_id']}")
            hops = [s["attrs"]["replica_trace"] for s in spans
                    if s["name"] in ("prefill.hop", "decode.hop")]
            remote = sum(len(store.spans(t)) for t in hops)
        finally:
            reqtrace.set_trace_store(prev)
        names = {s["name"] for s in spans}
        assert {"fleet.generate", "route", "prefill.hop", "handoff",
                "decode.hop"} <= names
        roots = [s for s in spans if s["name"] == "fleet.generate"]
        assert len(roots) == 1 and roots[0]["parent_id"] is None
        for s in spans:
            if s is not roots[0]:
                assert s["parent_id"] == roots[0]["span_id"]
        hop = next(s for s in spans if s["name"] == "decode.hop")
        assert hop["attrs"].get("replica", "").startswith("dc")
        pre = next(s for s in spans if s["name"] == "prefill.hop")
        assert pre["attrs"]["replica"] == "pf0"
        # the router's tree with both replicas' subtrees grafted in
        assert stitched["stitched"] is True
        assert len(hops) == 2 and remote > 0
        assert stitched["grafted_spans"] == remote
        assert stitched["spans"] == len(spans) + remote
        assert stitched["processes"] == 1           # one process here
        (root,) = stitched["tree"]
        grafted = [c for c in root["children"]
                   if c["name"] in ("prefill.hop", "decode.hop")]
        assert {g["children"][0]["attrs"]["boundary"]
                for g in grafted} == {"process"}

    def test_sticky_session_repeats_home(self, fleet):
        body = {"prompt_ids": [5, 5, 7, 7, 5, 5, 7, 7, 2],
                "max_tokens": 3, "greedy": True,
                "fleet_session": "sticky-1"}
        first_a, _, _ = _stream(fleet["url"], body)
        first_b, _, _ = _stream(fleet["url"], body)
        assert first_a["replica"] == first_b["replica"]
        assert first_a["fleet_session"] == "sticky-1"

    def test_drain_migrates_and_draining_refuses(self, fleet):
        router = fleet["router"]
        ref16 = _ref_tokens(SPEC, ROUTER_PROMPT, 16)
        body = {"prompt_ids": ROUTER_PROMPT, "max_tokens": 8,
                "greedy": True, "fleet_session": "mig-1"}
        first, tokens, _ = _stream(fleet["url"], body)
        assert tokens == ref16[:8]
        home = first["replica"]
        other = {"dc0": "dc1", "dc1": "dc0"}[home]

        res = client.post_json(fleet["url"], "/fleet/drain",
                               {"replica": home})
        assert res["draining"] is True and res["migrated"] >= 1
        assert router._c_migrations.value >= 1
        with router._lock:
            assert router._sessions["mig-1"] == other
        info = client.get_json(fleet["url"], "/fleet")
        by = {r["name"]: r for r in info["replicas"]}
        assert by[home]["draining"] is True

        # the drained replica refuses NEW admissions itself (503)
        with pytest.raises(client.ReplicaHTTPError) as ei:
            client.post_json(fleet["urls"][home], "/generate",
                             {"prompt_ids": ROUTER_PROMPT, "max_tokens": 1})
        assert ei.value.status == 503

        # the sticky follow-up continues the SAME greedy sequence on the
        # new home: migrated KV + prompt-extension resume
        follow = {"prompt_ids": ROUTER_PROMPT + ref16[:8], "max_tokens": 8,
                  "greedy": True, "fleet_session": "mig-1"}
        first2, tokens2, _ = _stream(fleet["url"], follow)
        assert first2["replica"] == other
        assert tokens2 == ref16[8:]
        assert router._c_failed.value == 0

        res = client.post_json(fleet["url"], "/fleet/drain",
                               {"replica": home, "draining": False})
        assert res["draining"] is False

    def test_router_healthz(self, fleet):
        hz = client.get_json(fleet["url"], "/healthz")
        assert hz["status"] == "ok"
        assert hz["tier"] == "router"
        assert hz["routable"] >= 2


class TestRouterEdge:
    def test_empty_fleet_is_503(self):
        router = FleetRouter([], poll_interval=None)
        port = router.start()
        try:
            with pytest.raises(client.ReplicaHTTPError) as ei:
                client.post_json(f"http://127.0.0.1:{port}", "/generate",
                                 {"prompt_ids": [1, 2, 3],
                                  "stream": False})
            assert ei.value.status == 503
            hz = client.get_json(f"http://127.0.0.1:{port}", "/healthz")
            assert hz["status"] == "degraded"
            assert "no healthy replica" in hz["reasons"]
        finally:
            router.stop()


class TestSLODrain:
    """A replica whose burn-rate SLO fires is drained by the control
    loop; traffic reroutes with zero failed in-flight requests."""

    @pytest.fixture(scope="class")
    def fleet(self):
        mp = pytest.MonkeyPatch()
        mp.setenv("FLEET_REPLICA_PLATFORM", "cpu")
        # an SLO that always fires once any request lands: ttft p99 > 0
        slo_cfg = {"interval": 0.1, "objectives": [
            {"name": "always-breached", "series": "serving_ttft_ms:p99",
             "threshold": 0.0, "budget": 1.0, "fast_s": 30.0,
             "slow_s": 60.0, "burn_threshold": 0.5}]}
        fl = _start_fleet([_replica_cfg("slo0", "mixed", slo=slo_cfg),
                           _replica_cfg("ok0", "mixed")],
                          auto_drain_on_slo=True)
        yield fl
        _stop_fleet(fl)
        mp.undo()

    def test_slo_breach_drains_and_reroutes(self, fleet):
        router = fleet["router"]
        client.post_json(fleet["urls"]["slo0"], "/generate",
                         {"prompt_ids": ROUTER_PROMPT, "max_tokens": 2,
                          "greedy": True, "stream": False})
        deadline = time.monotonic() + 30.0
        firing = []
        while time.monotonic() < deadline:
            hz = client.get_json(fleet["urls"]["slo0"], "/healthz")
            firing = [r for r in hz.get("reasons", ())
                      if r.startswith("slo firing")]
            if firing:
                break
            time.sleep(0.1)
        assert firing, "SLO never fired on the breached replica"

        verdicts = router.poll_once()
        assert "slo firing" in verdicts["slo0"]
        with router._lock:
            r = router._replicas["slo0"]
            assert r.draining and r.slo_drained
        assert router._c_slo_drains.value == 1

        out = client.post_json(
            fleet["url"], "/generate",
            {"prompt_ids": ROUTER_PROMPT, "max_tokens": 4, "greedy": True,
             "stream": False})
        assert out["outcome"] == "completed"
        first, _, _ = _stream(fleet["url"],
                              {"prompt_ids": ROUTER_PROMPT, "max_tokens": 2,
                               "greedy": True})
        assert first["replica"] == "ok0"
        assert router._c_failed.value == 0
        # the scrape rode the same poll: both replicas federated
        fm = client.get_json(fleet["url"], "/fleet/metrics")
        assert fm["scrapes"] == 1 and set(fm["replicas"]) == {"slo0", "ok0"}


class TestFleetDeploy:
    """Coordinated hot-swap: every replica flips or every flipped replica
    rolls back."""

    @pytest.fixture(scope="class")
    def fleet(self):
        mp = pytest.MonkeyPatch()
        mp.setenv("FLEET_REPLICA_PLATFORM", "cpu")
        fl = _start_fleet([_replica_cfg("da", "mixed"),
                           _replica_cfg("db", "mixed")])
        yield fl
        _stop_fleet(fl)
        mp.undo()

    def test_deploy_flips_fleet_then_rolls_back_on_failure(self, fleet):
        router = fleet["router"]
        v2_spec = dict(SPEC, seed=1)
        res = client.post_json(
            fleet["url"], "/fleet/deploy",
            {"name": "default", "version": 2, "spec": v2_spec},
            timeout=120.0)
        assert res["ok"] is True
        assert sorted(res["replicas"]) == ["da", "db"]
        ref_v2 = _ref_tokens(v2_spec, ROUTER_PROMPT, 6)
        out = client.post_json(
            fleet["url"], "/generate",
            {"prompt_ids": ROUTER_PROMPT, "max_tokens": 6, "greedy": True,
             "stream": False})
        assert out["tokens"] == ref_v2

        # a replica that cannot take the deploy (unreachable here) rolls
        # every already-flipped replica back to the v2 fleet spec
        router.add_replica(ReplicaHandle("ghost", "http://127.0.0.1:9",
                                         "mixed"))
        res = client.post_json(
            fleet["url"], "/fleet/deploy",
            {"name": "default", "version": 3,
             "spec": dict(SPEC, seed=2)}, timeout=120.0)
        assert res["ok"] is False
        assert res["failure"]["replica"] == "ghost"
        assert {r["replica"] for r in res["rolled_back"]} == {"da", "db"}
        assert router._c_rollbacks.value == 1
        with router._lock:
            assert router._specs["default"]["version"] == 2
        # the fleet still serves the v2 weights everywhere
        for name in ("da", "db"):
            out = client.post_json(
                fleet["urls"][name], "/generate",
                {"prompt_ids": ROUTER_PROMPT, "max_tokens": 6,
                 "greedy": True, "stream": False})
            assert out["tokens"] == ref_v2

    def test_bad_spec_fails_without_flipping(self, fleet):
        router = fleet["router"]
        res = client.post_json(
            fleet["url"], "/fleet/deploy",
            {"name": "default", "version": 9,
             "spec": {"kind": "no_such_builder"}}, timeout=120.0)
        assert res["ok"] is False
        assert "bad model spec" in res["failure"]["error"]
        assert res["rolled_back"] == []     # nothing flipped first
        with router._lock:
            assert router._specs["default"]["version"] == 2


# ------------------------------------------------------- replica processes
def test_replica_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """C19: unset, FLEET_REPLICA_PLATFORM puts a replica on `cuda` and a
    machine without a card refuses to start one (JAX's default is the
    CPU); "cpu" is how a caller asks for the CPU."""
    from deeplearning4j_tpu_torch.serving.fleet import replica_main

    monkeypatch.delenv("FLEET_REPLICA_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="FLEET_REPLICA_PLATFORM=cpu"):
        replica_main.replica_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica_main.main(["--config", json.dumps({"model": BENCH})])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert replica_main.replica_device() == "cuda"
    monkeypatch.setenv("FLEET_REPLICA_PLATFORM", "cpu")
    assert replica_main.replica_device() == "cpu"
    assert build_bench_lm(BENCH).device.type == "cpu"


BENCH = {"kind": "bench_lm", "seed": 0, "vocab": 17, "chunk": 4,
         "max_cache": 32, "blocks": 1}
CPU_ENV = {"FLEET_REPLICA_PLATFORM": "cpu"}


def _bench_cfg(name, role):
    return dict(_replica_cfg(name, role), model=dict(BENCH))


def _port_ref(prompt, max_tokens):
    """The port's own bench_lm (its seeded init) in one in-process plane."""
    plane = _plane(build_bench_lm(BENCH), slots=3, chunk=4)
    try:
        return _run(plane[2], prompt, max_tokens=max_tokens)
    finally:
        _close(plane)


def test_launched_replica_streams_through_the_router(tmp_path):
    from deeplearning4j_tpu_torch.serving.fleet.launcher import (
        launch_replica,
    )

    proc = launch_replica(_bench_cfg("lp0", "mixed"), env=CPU_ENV,
                          log_dir=str(tmp_path))
    router = FleetRouter([proc.handle()], poll_interval=None)
    url = f"http://127.0.0.1:{router.start()}"
    try:
        assert proc.alive() and proc.pid != os.getpid()
        first, tokens, terminal = _stream(
            url, {"prompt_ids": ROUTER_PROMPT, "max_tokens": 6,
                  "greedy": True})
        assert first["replica"] == "lp0"
        assert terminal.get("outcome") == "completed"
        assert tokens == _port_ref(ROUTER_PROMPT, 6)
        info = client.get_json(proc.url, "/fleet/info")
        assert info["name"] == "lp0" and info["role"] == "mixed"
    finally:
        router.stop()
        proc.terminate()
    assert not proc.alive()


@pytest.mark.chaos
@pytest.mark.slow
def test_replica_kill_midstream_stream_continues(tmp_path):
    """SIGKILL one replica PROCESS mid-stream: the router fails the stream
    over and the client's token sequence is byte-equal to an
    uninterrupted run (greedy resume from prompt + emitted)."""
    from deeplearning4j_tpu_torch.serving.fleet.launcher import (
        launch_replica,
    )

    procs = [launch_replica(_bench_cfg(n, "mixed"), env=CPU_ENV,
                            log_dir=str(tmp_path)) for n in ("ka", "kb")]
    router = FleetRouter([(p.name, p.url, p.role) for p in procs],
                         poll_interval=None)
    url = f"http://127.0.0.1:{router.start()}"
    try:
        ref = _port_ref(ROUTER_PROMPT, 12)
        _, tokens, _ = _stream(url, {"prompt_ids": ROUTER_PROMPT,
                                     "max_tokens": 12, "greedy": True})
        assert tokens == ref
        by_name = {p.name: p for p in procs}
        victim, tokens = None, []
        for ev in client.sse_events(
                url, "/generate", {"prompt_ids": ROUTER_PROMPT,
                                   "max_tokens": 12, "greedy": True},
                timeout=120.0):
            if victim is None and "replica" in ev and "token" not in ev:
                victim = by_name[ev["replica"]]
            if "token" in ev:
                tokens.append(int(ev["token"]))
                if len(tokens) == 1:
                    os.kill(victim.pid, signal.SIGKILL)
            if "error" in ev:
                pytest.fail(f"stream errored: {ev}")
        assert victim is not None and not victim.alive()
        assert tokens == ref
        assert router._c_reroutes.value >= 1
        assert router._c_failed.value == 0
    finally:
        router.stop()
        for p in procs:
            p.terminate()
