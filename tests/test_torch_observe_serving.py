"""The observe plane on the serving path, the port against the JAX package
on the CPU: both `InferenceServer`s on 127.0.0.1 run a 2-block
TextGenerationTransformer (d_model 32, vocabulary 64) on the same
weights (`params_from_numpy`), with every request traced, `slo=True` and
the series sampler ticked by hand at injected times. Three `/generate`
requests, one of them shed; then the same tokens, the same trace trees
(span names and parentage) under each `trace_id`, `trace_id` on every
SSE frame of the port and on the shed request's error body, every
observe route answering with JAX's status and JSON keys, the same SLO
objective names, and the same `/healthz` reasons after a forced
watchdog trip. Then the registry's deploy gate: a warm-up that trips a
threshold-1 watchdog rolls the second deploy back in both packages
(JAX's `test_serving_failover.py` cases, on buckets [1, 4, 8]). Every
HTTP call has a timeout and every server is stopped in a `finally`; no
test sleeps."""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

import deeplearning4j_tpu.observe as J
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.serving import (
    DeployRolledBackError as JaxRolledBack, ModelRegistry as JaxRegistry,
)
from deeplearning4j_tpu.serving.inference_server import (
    InferenceServer as JaxServer,
)
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
import deeplearning4j_tpu_torch.observe as P
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.serving import (
    DeployRolledBackError, InferenceServer, ModelRegistry,
)

V = 64
T = 32
TIMEOUT = 60
PKGS = {"jax": J, "torch": P}


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """Every request traced; a fresh trace store, flight recorder,
    registry and threshold-1 watchdog in both packages."""
    monkeypatch.setenv("DL4J_TPU_TRACE_SAMPLE", "1")
    prev, made = [], {}
    for name, m in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        objs = dict(store=m.TraceStore(),
                    flight=m.FlightRecorder(dump_dir=str(d)),
                    watchdog=m.RecompileWatchdog(threshold=1),
                    registry=m.MetricsRegistry())
        prev.append((m, m.set_trace_store(objs["store"]),
                     m.set_flight(objs["flight"]),
                     m.set_watchdog(objs["watchdog"]),
                     m.set_registry(objs["registry"])))
        made[name] = objs
    yield made
    for m, store, fl, wd, reg in prev:
        m.set_trace_store(store)
        m.set_flight(fl)
        m.set_watchdog(wd)
        m.set_registry(reg)


def _pair():
    jconf = JaxTGT(num_classes=V, input_shape=(T, 1), d_model=32,
                   num_heads=4, num_blocks=2, seed=3).conf()
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return jnet, pnet


def _call(srv, path, body=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _json(srv, path, body=None):
    status, _, raw = _call(srv, path, body)
    return status, json.loads(raw)


def _sse(srv, body):
    status, ctype, raw = _call(srv, "/generate", body)
    assert status == 200 and ctype == "text/event-stream", (status, raw)
    return [json.loads(line[len("data: "):])
            for line in raw.decode().split("\n\n") if line]


def _shape(node):
    """A trace tree's span names and parentage, in time order."""
    return (node["name"], [_shape(c) for c in node["children"]])


_TAG = re.compile(r"@0x[0-9a-f]+")


def test_serving_observe_plane_equals_jax(fresh):
    jnet, pnet = _pair()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, n).tolist() for n in (5, 12)]
    srvs = {}
    try:
        for name, cls, net in (("jax", JaxServer, jnet),
                               ("torch", InferenceServer, pnet)):
            srvs[name] = cls(net, decode_slots=2, decode_fused_k=4,
                             decode_page_len=8, admission="shed",
                             slo=True, series_interval=3600.0)
            srvs[name].start()
        streams, shed, trees = {}, {}, {}
        for name, srv in srvs.items():
            streams[name] = [_sse(srv, {"prompt_ids": p, "max_tokens": 6,
                                        "greedy": True})
                             for p in prompts]
            # a full admission queue sheds the third request
            cap, srv.scheduler.capacity = srv.scheduler.capacity, 0
            shed[name] = _json(srv, "/generate",
                               {"prompt_ids": prompts[0], "max_tokens": 3,
                                "stream": False})
            srv.scheduler.capacity = cap
            ids = [fr[0]["trace_id"] for fr in streams[name]] + \
                [shed[name][1]["trace_id"]]
            trees[name] = [_json(srv, f"/trace/{t}") for t in ids]
        # the same tokens; a trace id on every frame of the port's
        # streams (JAX names it in the first frame)
        for j, p in zip(streams["jax"], streams["torch"]):
            assert [f.get("token") for f in p] == \
                [f.get("token") for f in j]
            assert p[-1]["outcome"] == j[-1]["outcome"] == "completed"
            assert all("trace_id" in f for f in p)
            assert len({f["trace_id"] for f in p}) == 1
            assert j[0]["trace_id"]
        for name in srvs:
            status, body = shed[name]
            assert status == 503 and body["trace_id"], (name, body)
        # the same span names and parentage under each trace id
        for (js, jt), (ps, pt) in zip(trees["jax"], trees["torch"]):
            assert js == ps == 200
            assert [_shape(r) for r in pt["tree"]] == \
                [_shape(r) for r in jt["tree"]]
            assert (pt["spans"], pt["depth"]) == (jt["spans"], jt["depth"])
        names = {n for r in trees["torch"][0][1]["tree"]
                 for n in json.dumps(_shape(r)).split('"')}
        assert {"http.generate", "queue.wait", "dispatch",
                "session.window", "session.close"} <= names
        assert "request.shed" in json.dumps(trees["torch"][2][1])

        # healthz before any SLO evaluation: the trip of each server's
        # runner, forced by /output's first bucket (threshold 1)
        for srv in srvs.values():
            x = np.zeros((2, T, 1), np.float32).tolist()
            assert _json(srv, "/output", {"ndarray": x})[0] == 200
        health = {k: _json(s, "/healthz") for k, s in srvs.items()}
        assert health["torch"][1]["status"] == "degraded"
        assert [_TAG.sub("@", r) for r in health["torch"][1]["reasons"]] \
            == [_TAG.sub("@", r) for r in health["jax"][1]["reasons"]] == \
            ["recompile watchdog tripped: ParallelInference@"]
        assert set(health["jax"][1]) <= set(health["torch"][1])

        # the series sampler at injected times, then /series and /slo
        for srv in srvs.values():
            for i in range(3):
                srv._sampler.sample_once(now=1_000_000.0 + i)
        series = {k: _json(s, "/series?prefix=serving_")
                  for k, s in srvs.items()}
        for name, (status, body) in series.items():
            assert status == 200 and body["enabled"] and body["ticks"] == 3
            assert any(k.startswith("serving_requests_total")
                       for k in body["series"]), name
        assert set(series["jax"][1]) <= set(series["torch"][1])
        slo = {k: _json(s, "/slo") for k, s in srvs.items()}
        assert [s["name"] for s in slo["torch"][1]["slos"]] == \
            [s["name"] for s in slo["jax"][1]["slos"]]
        assert slo["torch"][1]["evaluations"] == \
            slo["jax"][1]["evaluations"] == 3
        assert set(slo["jax"][1]) <= set(slo["torch"][1])

        # every observe route answers with JAX's status and keys
        for name, srv in srvs.items():
            got = _json(srv, "/flight/dump", {"reason": "probe"})
            assert got[0] == 200 and got[1]["ok"], (name, got)
        for path in ("/devices", "/flight", "/trace", "/trace/",
                     "/flight/latest", "/trace/nope", "/flight/nope"):
            got = {k: _json(s, path) for k, s in srvs.items()}
            assert got["torch"][0] == got["jax"][0], (path, got)
            if got["jax"][0] == 200:
                assert set(got["jax"][1]) <= set(got["torch"][1]), path
        flight = _json(srvs["torch"], "/flight")[1]
        kinds = {e["kind"] for e in flight["events"]}
        assert {"session_open", "session_close", "jit_compile",
                "flight_dump"} <= kinds
        assert _json(srvs["torch"], "/flight/latest")[1]["reason"] == \
            "probe"
    finally:
        for s in srvs.values():
            s.stop()
    assert not srvs["torch"]._sampler.running


# ------------------------------------------------------ the deploy gate
def _jax_mlp(seed):
    return JaxNet(
        JaxNNC.builder().seed(seed)
        .list(jlayers.DenseLayer(n_out=8, activation="relu"),
              jlayers.OutputLayer(n_out=2, activation="softmax"))
        .set_input_type(JaxInputType.feed_forward(4)).build()).init()


def _port_mlp(seed):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jax_mlp(seed).conf.to_json()), device="cpu").init()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_watchdog_trip_rolls_back_to_serving_version(pkg, fresh):
    """The warm-up is the canary: v2's bucketed warm-up trips a threshold-1 watchdog, the flip never happens, v1 keeps
    serving, and the rollback is counted and flight-recorded; the FIRST
    deploy trips too but goes live (degraded beats dark)."""
    m = PKGS[pkg]
    make, reg_cls, err = ((_jax_mlp, JaxRegistry, JaxRolledBack)
                          if pkg == "jax" else
                          (_port_mlp, ModelRegistry, DeployRolledBackError))
    reg = reg_cls(max_batch_size=8, batch_buckets=[1, 4, 8])
    try:
        reg.deploy("m", 1, make(0), feat_shape=(4,))
        assert reg.get("m").version == 1
        tag = reg.get("m").runner._jit_cache.owner_tag if pkg == "jax" \
            else reg.get("m").runner.owner_tag
        assert m.get_watchdog().warned(tag)
        # JAX on the tests' 8 CPU devices rounds every bucket up to 8:
        # one program; the port on one card: one first forward a bucket
        assert m.get_watchdog().compiles(tag) == (1 if pkg == "jax" else 3)
        with pytest.raises(err, match="watchdog"):
            reg.deploy("m", 2, make(1), feat_shape=(4,))
        entry = reg.get("m")
        assert entry.version == 1 and not entry._retired
        out = entry.run_batch(np.ones((2, 4), np.float32))
        assert np.asarray(out).shape == (2, 2)
        assert m.get_registry().counter("serving_deploy_rollbacks_total",
                                        model="m").value == 1
        events = fresh[pkg]["flight"].events()
        rb = [e["data"] for e in events if e["kind"] == "deploy_rollback"]
        assert len(rb) == 1 and rb[0]["watchdog_tripped"]
        assert rb[0]["previous_kept"] and rb[0]["version"] == 2
    finally:
        reg.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_warmup_exception_rolls_back_even_first_deploy(pkg, fresh):
    m = PKGS[pkg]
    make, reg_cls, err = ((_jax_mlp, JaxRegistry, JaxRolledBack)
                          if pkg == "jax" else
                          (_port_mlp, ModelRegistry, DeployRolledBackError))
    m.set_watchdog(m.RecompileWatchdog(threshold=10))
    reg = reg_cls(max_batch_size=8, batch_buckets=[1, 4, 8])
    try:
        with pytest.raises(err, match="raised"):
            reg.deploy("m", 1, make(0), feat_shape=(999,))
        assert reg.names() == []
        reg.deploy("m", 1, make(0), warm=False)
        with pytest.raises(err, match="raised"):
            reg.deploy("m", 2, make(1), feat_shape=(999,))
        assert reg.get("m").version == 1
        rb = [e["data"] for e in fresh[pkg]["flight"].events()
              if e["kind"] == "deploy_rollback"]
        assert [r["watchdog_tripped"] for r in rb] == [False, False]
        assert [r["previous_kept"] for r in rb] == [False, True]
    finally:
        reg.close()
