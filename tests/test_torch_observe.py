"""The observe modules of the PyTorch port against the JAX package's, on
the CPU: the same scripted events with injected clocks (`now=`) go
through both, and the records must be equal once ids and wall-clock
stamps are normalised — span records, request-trace trees and
`error_extra`, flight snapshots and dump JSON, series snapshots, SLO
burn rates and firing state, `AnomalyWatch` verdicts, attribution's
segments. Exact values are asserted exactly (both are the same stdlib
arithmetic). The rebuilt modules: the watchdog's per-owner counts of a
`NetGraphs` key churn, `HostSyncMonitor` on the same `fit` in both
packages (JAX's dispatch-depth contract: at most one sync an epoch, one
more a step for a listener that reads the score), the device monitor on
the CPU, and the fit loop's spans. No test sleeps."""

import json

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.observe as J
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.optim.listeners import TrainingListener as JaxListener
from deeplearning4j_tpu.optim.updaters import Sgd as JaxSgd
import deeplearning4j_tpu_torch.observe as P
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.optim.listeners import TrainingListener
from deeplearning4j_tpu_torch.utils.cuda_graphs import NetGraphs

PKGS = {"jax": J, "torch": P}


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """Fresh process-wide registry, trace store, flight recorder and
    watchdog in both packages (restored after), and every request
    sampled."""
    monkeypatch.setenv("DL4J_TPU_TRACE_SAMPLE", "1")
    prev = []
    made = {}
    for name, m in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        objs = dict(registry=m.MetricsRegistry(), store=m.TraceStore(),
                    flight=m.FlightRecorder(dump_dir=str(d)),
                    watchdog=m.RecompileWatchdog(threshold=3), dir=d)
        prev.append((m, m.set_registry(objs["registry"]),
                     m.set_trace_store(objs["store"]),
                     m.set_flight(objs["flight"]),
                     m.set_watchdog(objs["watchdog"])))
        made[name] = objs
    yield made
    for m, reg, store, fl, wd in prev:
        m.set_registry(reg)
        m.set_trace_store(store)
        m.set_flight(fl)
        m.set_watchdog(wd)


def _norm_ids(records, keys=("span_id", "parent_id")):
    """Span ids (and trace ids) renumbered by first appearance."""
    ids, tids = {}, {}

    def nid(v):
        return None if v is None else ids.setdefault(v, len(ids))

    def walk(r):
        r = dict(r)
        for k in keys:
            if k in r:
                r[k] = nid(r[k])
        if "trace_id" in r and r["trace_id"] is not None:
            r["trace_id"] = tids.setdefault(r["trace_id"], len(tids))
        r.pop("ts", None)
        r.pop("dur_ms", None)
        if "attrs" in r:
            r["attrs"] = {k: v for k, v in r["attrs"].items()
                          if k != "co_traces"}
        if "children" in r:
            r["children"] = [walk(c) for c in r["children"]]
        return r

    return [walk(r) for r in records]


# ------------------------------------------------------------------ trace
def test_span_records_equal_jax(tmp_path):
    got = {}
    for name, m in PKGS.items():
        path = str(tmp_path / f"{name}.jsonl")
        m.install_span_log(path)
        try:
            with m.span("fit", epochs=2, k=4) as a:
                a["found"] = "x"
                with m.span("fit.epoch", epoch=0, obj=object()):
                    m.emit_manual_span("window", 1.0, 1.5, steps=3)
            with m.span("after", ok=True, none=None, f=0.25):
                pass
        finally:
            m.uninstall_span_log()
        assert not m.tracing_enabled()
        with m.span("untraced") as a:
            assert a is None
        got[name] = _norm_ids(m.read_spans(path))
    assert got["torch"] == got["jax"]
    assert [r["name"] for r in got["jax"]] == ["window", "fit.epoch",
                                               "fit", "after"]
    assert got["jax"][1]["attrs"]["obj"] == "object"


# --------------------------------------------------------------- reqtrace
def _script_traces(m):
    rt = m.reqtrace
    ctx = m.new_trace("http.generate")
    ctx2 = m.new_trace("http.generate")
    m.record_span(ctx.trace_id, "queue.wait", parent_id=ctx.span_id,
                  ts=10.0, dur_ms=2.0, model="default")
    dt = m.begin_dispatch([ctx, ctx2])
    assert m.active_dispatch() is dt
    m.record_span(ctx.trace_id, "session.window",
                  parent_id=dt.span_ids[ctx.trace_id], dur_ms=1.5,
                  phase="prefill", win=8, tokens=0, lst=[1, 2, object()])
    m.end_dispatch(dt, model="default@decode", rows=2, requests=2)
    assert m.active_dispatch() is None
    m.finish_root(ctx, route="/generate", tokens=9)
    m.finish_root(ctx2, route="/generate", tokens=1)
    err = RuntimeError("shed")
    err.trace_id = m.error_trace("request.shed", model="default",
                                 queue_depth=4, capacity=4)
    joined = m.error_trace("request.expired", ctx=ctx2, where="queue")
    assert joined == ctx2.trace_id
    store = m.get_trace_store()
    trees = [store.tree(t) for t in store.ids()]
    return (trees, m.error_extra(err), m.error_extra(ValueError()),
            rt.sample_rate())


def test_reqtrace_trees_and_error_extra_equal_jax(fresh):
    got = {k: _script_traces(m) for k, m in PKGS.items()}
    jt, pt = got["jax"], got["torch"]
    assert [(t["spans"], t["depth"]) for t in pt[0]] == \
        [(t["spans"], t["depth"]) for t in jt[0]] == [(4, 3), (3, 2),
                                                      (1, 1)]
    assert _norm_ids([t for tr in pt[0] for t in tr["tree"]]) == \
        _norm_ids([t for tr in jt[0] for t in tr["tree"]])
    assert set(pt[1]) == set(jt[1]) == {"trace_id"}
    assert pt[2] == jt[2] == {}
    assert pt[3] == jt[3] == 1.0


def test_sampled_off_allocates_nothing(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_TRACE_SAMPLE", "0")
    for m in PKGS.values():
        assert m.new_trace("http.output") is None
        m.finish_root(None)
        m.end_dispatch(None)


# ----------------------------------------------------------------- flight
def _script_flight(m, objs):
    reg = objs["registry"]
    reg.counter("serving_requests_total", model="m", outcome="shed").inc(2)
    reg.gauge("g").set(1.5)
    fr = objs["flight"]
    small = m.FlightRecorder(capacity=3, dump_dir=str(objs["dir"]))
    for i in range(5):
        small.record("ev", i=i, nested={"a": [1, 2, {"b": object()}]})
    ctx = m.new_trace("http.output")
    m.finish_root(ctx, status=200)
    with m.span("fit", epochs=1):
        pass
    fr.record("session_open", model="m", session="s000001", slot=0)
    try:
        raise ValueError("boom")
    except ValueError as e:
        path = fr.dump("training_exception", exc=e)
    snap = fr.snapshot()
    return small.snapshot(), snap, m.read_dump(path), path


def _norm_events(events):
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k != "ts"}
        if e["kind"] == "span":
            e["data"] = _norm_ids([e["data"]])[0]
        if e["kind"] == "flight_dump":
            e["data"] = {"reason": e["data"]["reason"]}
        if e["kind"] == "device_memory":
            # the CPU samples differ by design (devicemon's docstring)
            e["data"] = len(e["data"]["devices"]) > 0
        out.append(e)
    return out


def test_flight_snapshots_and_dumps_equal_jax(fresh):
    got = {k: _script_flight(m, fresh[k]) for k, m in PKGS.items()}
    (js, jsnap, jdump, jpath), (ps, psnap, pdump, ppath) = \
        got["jax"], got["torch"]
    assert _norm_events(ps["events"]) == _norm_events(js["events"])
    assert ps["recorded_total"] == js["recorded_total"] == 5
    assert [e["seq"] for e in ps["events"]] == [3, 4, 5]
    assert _norm_events(psnap["events"]) == _norm_events(jsnap["events"])
    assert set(pdump) == set(jdump)
    for key in ("reason", "exception"):
        pe, je = pdump[key], jdump[key]
        if key == "exception":
            pe = {k: v for k, v in pe.items() if k != "traceback"}
            je = {k: v for k, v in je.items() if k != "traceback"}
        assert pe == je
    assert _norm_events(pdump["events"]) == _norm_events(jdump["events"])
    assert pdump["registry"]["series"] == jdump["registry"]["series"]
    assert [(d["spans"], d["depth"], _norm_ids(d["tree"]))
            for d in pdump["traces"]] == \
        [(d["spans"], d["depth"], _norm_ids(d["tree"]))
         for d in jdump["traces"]]
    assert pdump["syncmon"] is jdump["syncmon"] is None
    assert pdump["commsmon"] == jdump["commsmon"] == \
        {"comm_totals": {}, "reshard": None}
    assert pdump["watchdog"]["total_compiles"] == 0
    assert P.latest_dump(str(fresh["torch"]["dir"])) == ppath
    # the dump CLI reads a flight dump back as its registry table
    from deeplearning4j_tpu_torch.observe.dump import dump_file

    table = dump_file(ppath)
    assert "serving_requests_total" in table and "outcome=shed" in table


# ----------------------------------------------------------------- series
def _feed(reg, step):
    reg.counter("serving_requests_total", model="m",
                outcome="admitted").inc(10)
    reg.counter("serving_requests_total", model="m",
                outcome="shed").inc(step % 3)
    reg.gauge("serving_worker_restart_streak").set(step % 5)
    h = reg.histogram("serving_ttft_ms", model="m")
    for v in (5.0 * step, 900.0 + step, 2000.0 * (step % 2)):
        h.observe(v)
    reg.counter("jit_compiles", owner="NetGraphs").inc(
        0 if step < 6 else 2)
    reg.gauge("train_host_syncs_per_step").set(1.0 if step < 7 else 3.0)


T0 = 1_000_000.0


def _script_series(m):
    reg = m.MetricsRegistry()
    store = m.SeriesStore(capacity=16)
    sampler = m.SeriesSampler(store, registry=reg, interval=10.0)
    slos = [s for s in m.default_slos()]
    slos.append(m.SLO("ttft-fast", series="serving_ttft_ms:p99",
                      threshold=1000.0, fast_s=30.0, slow_s=60.0,
                      burn_threshold=2.0))
    engine = m.SLOEngine(store, registry=reg, slos=slos,
                         flight=m.FlightRecorder(enabled=False))
    watch = m.AnomalyWatch(store, registry=reg, recent_s=25.0)
    evals, wrote = [], []
    for step in range(10):
        _feed(reg, step)
        now = T0 + 10.0 * step
        wrote.append(sampler.sample_once(now=now))
        evals.append(engine.evaluate(now=now))
        watch.check(now=now)
    return (wrote, store.snapshot()["series"], evals, watch.warnings,
            store.rate("serving_requests_total", 60.0, T0 + 90.0,
                       outcome="shed"),
            store.delta("serving_requests_total", 60.0, T0 + 90.0),
            engine.firing(), engine.breaches(), reg.snapshot())


def test_series_slo_and_anomaly_watch_equal_jax(fresh):
    got = {k: _script_series(m) for k, m in PKGS.items()}
    j, p = got["jax"], got["torch"]
    assert p[0] == j[0]
    assert p[1] == j[1]
    assert "serving_ttft_ms:p99{model=m}" in p[1]

    def strip(ev):
        return {**ev, "ts": None,
                "slos": [{**s, "trace_id": bool(s["trace_id"])}
                         for s in ev["slos"]]}
    assert [strip(e) for e in p[2]] == [strip(e) for e in j[2]]
    last = {s["name"]: s for s in p[2][-1]["slos"]}
    assert last["ttft-fast"]["firing"] and last["ttft-fast"]["breaches"] == 1
    assert last["ttft-fast"]["burn_fast"] == \
        {s["name"]: s for s in j[2][-1]["slos"]}["ttft-fast"]["burn_fast"]
    assert [{k: v for k, v in w.items() if k != "ts"} for w in p[3]] == \
        [{k: v for k, v in w.items() if k != "ts"} for w in j[3]]
    assert {w["kind"] for w in p[3]} == {"recompile_storm",
                                        "sync_regression"}
    assert p[4:8] == j[4:8]
    assert p[8]["series"]["slo_breaches_total"] == \
        j[8]["series"]["slo_breaches_total"]


# ------------------------------------------------------------ attribution
def test_attribution_segments_equal_jax(fresh, tmp_path):
    got = {}
    for name, m in PKGS.items():
        reg = fresh[name]["registry"]
        path = str(tmp_path / f"attr_{name}.jsonl")
        m.install_span_log(path)
        try:
            a = m.StepAttribution(reg)
            for i in range(4):
                a.record_iteration(0.0, 100.0 + i, 50.0)
            a.on_device_block(40.0)
            a.on_device_block(7.0)     # a re-read: no window
        finally:
            m.uninstall_span_log()
        hists = {s["labels"]["segment"]: (s["count"], s["sum"])
                 for s in reg.snapshot()["series"][
                     "train_step_attribution_ms"]}
        spans = [{k: v for k, v in e["attrs"].items()}
                 for e in m.read_spans(path)]
        got[name] = (a.snapshot(), hists, spans,
                     reg.gauge("train_device_step_ms").value)
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["last_device_step_ms"] == 10.0
    assert set(got["torch"][1]) == {"etl", "dispatch", "host", "device"}


# --------------------------------------------------------------- watchdog
def test_watchdog_counts_net_graph_keys_per_owner(fresh):
    wd = fresh["torch"]["watchdog"]
    g, h = NetGraphs("cpu"), NetGraphs("cpu")

    def fn(x):
        return x * 2
    for n in (1, 2, 1, 3, 2):
        g.run(("out",), fn, [torch.ones(n)], addresses=(0,))
    # an address change drops the entry and captures anew
    g.run(("out",), fn, [torch.ones(1)], addresses=(7,))
    h.run(("out",), fn, [torch.ones(1)])
    assert wd.compiles(g.owner_tag) == 4 and wd.compiles(h.owner_tag) == 1
    snap = wd.snapshot()["per_owner"]
    assert len(snap[g.owner_tag]["signatures"]) == 4
    assert snap[g.owner_tag]["warned"] and not snap[h.owner_tag]["warned"]
    assert wd.warned(g.owner_tag) and not wd.warned(h.owner_tag)
    reg = fresh["torch"]["registry"]
    assert reg.counter("jit_compiles", owner="NetGraphs").value == 5
    kinds = [e["kind"] for e in fresh["torch"]["flight"].events()]
    assert kinds.count("jit_compile") == 5
    assert "recompile_threshold_trip" in kinds
    assert fresh["torch"]["flight"].dumps        # the trip dumped
    assert wd.owner_comm_totals(g.owner_tag) is None


def test_net_owner_tags_and_fit_shape_churn(fresh):
    net = _port_net(_jax_net())
    wd = fresh["torch"]["watchdog"]
    assert net._graphs.owner_tag.startswith("MultiLayerNetwork@0x")
    x, y = _data(48)
    for bs in (8, 12):
        net.fit(x, y, batch_size=bs, steps_per_dispatch=2)
    assert wd.compiles(net._graphs.owner_tag) == 2
    assert fresh["torch"]["registry"].counter(
        "jit_compiles", owner="MultiLayerNetwork").value == 2


# ------------------------------------------------------- syncmon and fit
def _jax_net():
    conf = (JaxNNC.builder().seed(1).updater(JaxSgd(0.1))
            .list(jlayers.DenseLayer(n_out=8, activation="relu"),
                  jlayers.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(5)).build())
    return JaxNet(conf).init()


def _port_net(jnet):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(net, jax.tree_util.tree_map(np.asarray,
                                                  jnet.params_tree))
    return net


def _data(n=40):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


class _ReadsJax(JaxListener):
    def iteration_done(self, model, iteration, epoch, score):
        float(score)


class _ReadsPort(TrainingListener):
    def iteration_done(self, model, iteration, epoch, score):
        float(score)


@pytest.mark.parametrize("read_score", [False, True],
                         ids=["silent", "float_every_step"])
def test_host_sync_monitor_counts_equal_jax_on_the_same_fit(read_score):
    jnet = _jax_net()
    pnet = _port_net(jnet)
    x, y = _data()
    if read_score:
        jnet.set_listeners(_ReadsJax())
        pnet.set_listeners(_ReadsPort())
    # an unmonitored epoch first in both (JAX compiles there)
    jnet.fit(x, y, batch_size=8)
    pnet.fit(x, y, batch_size=8)
    with J.HostSyncMonitor() as jm:
        jnet.fit(x, y, epochs=2, batch_size=8)
    with P.HostSyncMonitor(device="cpu") as pm:
        pnet.fit(x, y, epochs=2, batch_size=8)
    assert P.current_monitor() is None
    steps = 2 * 5
    want = 2 + (steps if read_score else 0)
    assert pm.syncs == jm.syncs == want
    assert pm.snapshot()["by_seam"] == {"__float__": want}
    np.testing.assert_allclose(pnet.score_, jnet.score_, rtol=1e-5)


def test_host_sync_monitor_seams_and_nesting():
    t = torch.arange(4.0)
    with P.HostSyncMonitor(device="cpu") as outer:
        with P.HostSyncMonitor(device="cpu") as inner:
            t.sum().item()
            t.tolist()
            t.numpy()
            int(t[0])
            bool(t[1])
            t.cpu()                       # a CPU tensor: no copy
            t.to(torch.float64)           # not a transfer
        assert inner.syncs == 5 and outer.syncs == 5
        with P.HostSyncMonitor(device="cuda:0") as card:
            t[0].item()
        assert card.syncs == 0 and outer.syncs == 6
    assert outer.snapshot()["by_seam"] == {
        "item": 2, "tolist": 1, "numpy": 1, "__int__": 1, "__bool__": 1}
    # uninstalled: the seams are the inherited methods again
    assert "item" not in torch.Tensor.__dict__
    t[0].item()
    assert outer.syncs == 6


def test_fit_spans_and_attribution_equal_jax(tmp_path, fresh):
    jnet = _jax_net()
    pnet = _port_net(jnet)
    x, y = _data()
    got = {}
    for name, net, m in (("jax", jnet, J), ("torch", pnet, P)):
        path = str(tmp_path / f"fit_{name}.jsonl")
        m.install_span_log(path)
        try:
            net.fit(x, y, epochs=2, batch_size=8)
        finally:
            m.uninstall_span_log()
        spans = m.read_spans(path)
        got[name] = spans
        assert net._attribution.windows == 2
        assert net._attribution.last_device_step_ms() > 0
    names = {k: [s["name"] for s in v] for k, v in got.items()}
    assert names["torch"] == names["jax"]
    assert names["torch"].count("train.dispatch") == 10
    assert names["torch"].count("fit.attribution_window") == 2
    by_name = {k: {s["name"]: s for s in v} for k, v in got.items()}
    assert by_name["torch"]["fit.attribution_window"]["attrs"].keys() == \
        by_name["jax"]["fit.attribution_window"]["attrs"].keys()
    hist = fresh["torch"]["registry"].snapshot()["series"][
        "train_step_attribution_ms"]
    assert {h["labels"]["segment"]: h["count"] for h in hist} == \
        {"etl": 10, "dispatch": 10, "host": 10, "device": 2}


def test_training_exception_dumps_the_flight_recorder(fresh):
    pnet = _port_net(_jax_net())

    class Boom(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            raise RuntimeError("listener failed")
    pnet.set_listeners(Boom())
    x, y = _data(16)
    with pytest.raises(RuntimeError, match="listener failed"):
        pnet.fit(x, y, batch_size=8)
    fr = fresh["torch"]["flight"]
    doc = json.load(open(fr.dumps[-1]))
    assert doc["reason"] == "training_exception"
    assert doc["exception"]["message"] == "listener failed"
    assert pnet._loss_tracker.on_block is None


# -------------------------------------------------------------- devicemon
def test_device_monitor_on_the_cpu(fresh):
    reg = fresh["torch"]["registry"]
    mon = P.DeviceMonitor(registry=reg)
    samples = mon.sample_once()
    assert samples == [{"device": "cpu:0", "kind": "cpu",
                        "live_arrays": None, "memory_stats": None}]
    assert reg.snapshot()["series"] == {}
    assert mon.snapshot()["polls"] == 1
    assert [e["kind"] for e in fresh["torch"]["flight"].events()] == \
        ["device_memory"]
    # JAX's CPU backend: memory_stats None as well (it counts live arrays)
    jsample = J.DeviceMonitor(registry=J.MetricsRegistry(),
                              record_flight=False).sample_once()[0]
    assert jsample["memory_stats"] is None and "live_arrays" in jsample
    assert P.device_memory_summary()[0]["memory_stats"] is None
    assert not P.maybe_start_monitor()
