"""The port's federated metrics (`deeplearning4j_tpu_torch/observe/
fedmon.py`) and cross-process trace graft (`observe/reqtrace.py`): the
JAX package's cases of `tests/test_fedmon.py` run against the port's
copies, then the same registry snapshots and trace documents go through
both packages and must give equal results. All host-side: synthetic
registry snapshots in, merged views out; no servers, no network."""

import copy
import os

import pytest

from deeplearning4j_tpu.observe import fedmon as jax_fedmon
from deeplearning4j_tpu.observe import reqtrace as jax_reqtrace
from deeplearning4j_tpu_torch.observe import fedmon, reqtrace
from deeplearning4j_tpu_torch.observe.fedmon import (
    FleetFederation, quantile_from_buckets,
)
from deeplearning4j_tpu_torch.observe.registry import (
    BUCKET_EDGES, MetricsRegistry,
)

NBINS = len(BUCKET_EDGES) + 1


def snap_of(*, counters=(), gauges=(), hists=()):
    """Build a registry.snapshot()-shaped doc from real registry
    primitives so the test exercises the actual wire shape."""
    reg = MetricsRegistry()
    for name, labels, v in counters:
        reg.counter(name, **labels).inc(v)
    for name, labels, v in gauges:
        reg.gauge(name, **labels).set(v)
    for name, labels, values in hists:
        h = reg.histogram(name, **labels)
        for v in values:
            h.observe(v)
    return reg.snapshot()


# ---------------------------------------------------------------- counters

def test_counter_federation_sums_across_replicas():
    fed = FleetFederation(stale_after_s=60.0)
    fed.ingest("a", snap_of(counters=[("toks", {"model": "m"}, 10)]))
    fed.ingest("b", snap_of(counters=[("toks", {"model": "m"}, 32)]))
    assert fed.total("toks") == 42.0
    assert fed.total("toks", {"model": "m"}) == 42.0
    assert fed.total("toks", {"model": "other"}) == 0.0


def test_counter_restart_resumes_at_zero_never_negative():
    """The pinned restart rule: raw going backwards re-bases the delta
    at 0 — pre-restart total is kept, post-restart raw counts as fresh
    increments, the fleet total never decreases."""
    fed = FleetFederation(stale_after_s=60.0)
    fed.ingest("a", snap_of(counters=[("toks", {}, 100)]))
    assert fed.total("toks") == 100.0
    # replica restarts: raw drops 100 -> 0, then counts 7 more
    fed.ingest("a", snap_of(counters=[("toks", {}, 7)]))
    assert fed.total("toks") == 107.0
    fed.ingest("a", snap_of(counters=[("toks", {}, 9)]))
    assert fed.total("toks") == 109.0
    # monotone throughout — never negative, never below a prior reading
    assert fed.total("toks") >= 100.0


def test_counter_unchanged_scrape_is_idempotent():
    fed = FleetFederation(stale_after_s=60.0)
    doc = snap_of(counters=[("toks", {}, 5)])
    for _ in range(3):
        fed.ingest("a", doc)
    assert fed.total("toks") == 5.0


# --------------------------------------------------------------- histograms

def test_histogram_merge_equals_union_of_observations():
    """Bucket-wise fleet merge == one histogram fed every replica's
    observations (count, sum, min, max, and every bin loss-free)."""
    obs_a = [0.4, 3.0, 12.0, 180.0]
    obs_b = [0.9, 45.0, 4500.0]
    fed = FleetFederation(stale_after_s=60.0)
    fed.ingest("a", snap_of(hists=[("lat", {}, obs_a)]))
    fed.ingest("b", snap_of(hists=[("lat", {}, obs_b)]))
    merged = fed.merged("lat")

    union = MetricsRegistry().histogram("union_lat")
    for v in obs_a + obs_b:
        union.observe(v)
    want = union.buckets()
    assert merged["buckets"] == want
    assert merged["count"] == len(obs_a) + len(obs_b)
    assert merged["sum"] == pytest.approx(sum(obs_a) + sum(obs_b))
    assert merged["min"] == min(obs_a + obs_b)
    assert merged["max"] == max(obs_a + obs_b)


def test_histogram_merge_survives_replica_restart():
    fed = FleetFederation(stale_after_s=60.0)
    fed.ingest("a", snap_of(hists=[("lat", {}, [10.0, 20.0])]))
    # restart: count drops 2 -> 1; the 2 pre-restart observations stay
    fed.ingest("a", snap_of(hists=[("lat", {}, [30.0])]))
    merged = fed.merged("lat")
    assert merged["count"] == 3
    assert merged["sum"] == pytest.approx(60.0)
    assert sum(merged["buckets"]) == 3


def test_quantile_from_buckets_interpolates():
    h = MetricsRegistry().histogram("q")
    for v in [1.0] * 50 + [100.0] * 50:
        h.observe(v)
    b = h.buckets()
    assert quantile_from_buckets(b, 0.25) <= 1.0
    assert quantile_from_buckets(b, 0.99) <= 100.0
    assert quantile_from_buckets(b, 0.99) > 50.0
    assert quantile_from_buckets([0] * NBINS, 0.5) is None


# ------------------------------------------------------------------- gauges

def test_gauge_fans_out_per_replica_not_summed():
    fed = FleetFederation(stale_after_s=60.0)
    fed.ingest("a", snap_of(gauges=[("inflight", {}, 3)]))
    fed.ingest("b", snap_of(gauges=[("inflight", {}, 5)]))
    entries = fed.snapshot()["series"]["inflight"]
    by_rep = {e["labels"]["replica"]: e["value"] for e in entries}
    assert by_rep == {"a": 3.0, "b": 5.0}
    # no aggregate (replica-less) gauge entry: a gauge is a per-process
    # point-in-time reading, summing it would be a lie
    assert all("replica" in e["labels"] for e in entries)


# ---------------------------------------------------------------- staleness

def test_unreachable_replica_marked_stale():
    fed = FleetFederation(stale_after_s=60.0)
    fed.ingest("a", snap_of(counters=[("toks", {}, 4)]), now=1000.0)
    fed.mark_unreachable("a")
    reps = fed.replicas(now=1001.0)
    assert reps["a"]["stale"] is True
    assert reps["a"]["failures"] == 1
    # last-known series survive the failed scrape
    assert fed.total("toks") == 4.0
    doc = fed.snapshot(now=1001.0)
    stale = {e["labels"]["replica"]: e["value"]
             for e in doc["series"]["fleet_scrape_stale"]}
    assert stale["a"] == 1.0


def test_scrape_age_ttl_marks_stale():
    fed = FleetFederation(stale_after_s=10.0)
    fed.ingest("a", snap_of(), now=1000.0)
    assert fed.replicas(now=1005.0)["a"]["stale"] is False
    assert fed.replicas(now=1011.0)["a"]["stale"] is True


def test_stale_after_env_knob(monkeypatch):
    monkeypatch.setenv(fedmon.ENV_STALE_S, "2.5")
    assert FleetFederation().stale_after_s == 2.5


# -------------------------------------------------------------- series rows

def test_series_points_follow_sampler_convention():
    fed = FleetFederation(stale_after_s=60.0)
    fed.ingest("a", snap_of(counters=[("toks", {}, 4)],
                            hists=[("lat", {}, [5.0, 9.0])]))
    rows = {(n, tuple(sorted(lab.items())), kind)
            for n, lab, kind, _ in fed.series_points()}
    assert ("toks", (("replica", "a"),), "counter") in rows
    assert ("lat:count", (), "counter") in rows
    assert ("lat:p99", (), "quantile") in rows


# -------------------------------------------------------- trace graft (pid)

def test_pid_of_trace_id_roundtrip():
    tid = f"t{os.getpid():x}-00002a"
    assert reqtrace.pid_of_trace_id(tid) == os.getpid()
    assert reqtrace.pid_of_trace_id("not-a-trace") is None


def make_node(name, ts, dur_ms, trace_id, span_id="s1",
              parent_id=None, **attrs):
    return {"name": name, "ts": ts, "dur_ms": dur_ms,
            "span_id": span_id, "parent_id": parent_id,
            "trace_id": trace_id, "thread": "t", "attrs": attrs,
            "children": []}


def test_graft_subtree_stitches_and_corrects_skew():
    hop = make_node("decode.hop", 100.0, 50.0, "taaa-000001")
    # the replica's clock runs 2s ahead of the router's
    sub = {"trace_id": "tbbb-000001",
           "tree": [make_node("session.step", 102.01, 30.0,
                              "tbbb-000001")]}
    n = reqtrace.graft_subtree(hop, sub, skew_s=2.0,
                               replica="r0", pid=0xbbb)
    assert n == 1
    child = hop["children"][0]
    assert child["name"] == "session.step"
    assert child["ts"] == pytest.approx(100.01)       # skew removed
    assert child["attrs"]["boundary"] == "process"
    assert child["attrs"]["replica"] == "r0"

    doc = {"trace_id": "taaa-000001", "tree": [hop]}
    reqtrace.tree_stats(doc)
    assert doc["depth"] == 2
    assert doc["spans"] == 2
    assert doc["processes"] == 2                      # taaa + tbbb


# ------------------------------------------------- against the JAX package

SNAPS = [
    ("a", 1000.0, dict(counters=[("toks", {"model": "m"}, 10),
                                 ("reqs", {}, 3)],
                       gauges=[("inflight", {}, 2)],
                       hists=[("lat", {"model": "m"}, [0.4, 3.0, 12.0])])),
    ("b", 1000.5, dict(counters=[("toks", {"model": "m"}, 32)],
                       gauges=[("inflight", {}, 5)],
                       hists=[("lat", {"model": "m"}, [0.9, 4500.0])])),
    # a's restart: every raw count goes backwards
    ("a", 1001.0, dict(counters=[("toks", {"model": "m"}, 4),
                                 ("reqs", {}, 1)],
                       gauges=[("inflight", {}, 0)],
                       hists=[("lat", {"model": "m"}, [180.0])])),
    ("b", 1001.5, dict(counters=[("toks", {"model": "m"}, 40)],
                       gauges=[("inflight", {}, 1)],
                       hists=[("lat", {"model": "m"},
                               [0.9, 4500.0, 45.0, 7.5])])),
]


def _fed_both():
    feds = (FleetFederation(stale_after_s=5.0),
            jax_fedmon.FleetFederation(stale_after_s=5.0))
    for rep, now, kw in SNAPS:
        doc = snap_of(**kw)
        for fed in feds:
            fed.ingest(rep, copy.deepcopy(doc), now=now)
    for fed in feds:
        fed.mark_unreachable("b", now=1002.0)
    return feds


def test_federation_snapshot_equals_jax_on_the_same_scrapes():
    port, jax_ = _fed_both()
    for now in (1002.0, 1010.0):
        assert port.snapshot(now) == jax_.snapshot(now)
        assert port.replicas(now) == jax_.replicas(now)
    assert port.total("toks", {"model": "m"}) == \
        jax_.total("toks", {"model": "m"}) == 4.0 + 40.0 + 10.0
    assert port.merged("lat") == jax_.merged("lat")
    assert sorted(port.series_points(), key=repr) == \
        sorted(jax_.series_points(), key=repr)


def test_quantile_from_buckets_equals_jax():
    reg = MetricsRegistry()
    for i, obs in enumerate(([1.0] * 50 + [100.0] * 50,
                             [0.3, 7.0, 7.0, 9000.0], [])):
        h = reg.histogram(f"q{i}")
        for v in obs:
            h.observe(v)
        for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
            assert quantile_from_buckets(h.buckets(), q) == \
                jax_fedmon.quantile_from_buckets(h.buckets(), q)


def test_default_fleet_slos_equal_jax(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLEET_SLO_TTFT_MS", "750")
    mine, theirs = fedmon.default_fleet_slos(), \
        jax_fedmon.default_fleet_slos()

    def fields(slo):
        return {k: getattr(slo, k) for k in type(slo).__slots__}
    assert [fields(s) for s in mine] == [fields(s) for s in theirs]
    assert mine[0].threshold == 750.0


def _trace_docs():
    hop = make_node("decode.hop", 100.0, 50.0, "taaa-000001", span_id="h",
                    replica_trace="tbbb-000001")
    pre = make_node("prefill.hop", 99.0, 5.0, "taaa-000001", span_id="p")
    root = make_node("fleet.generate", 98.5, 60.0, "taaa-000001",
                     span_id="r")
    root["children"] = [pre, hop]
    sub = {"trace_id": "tbbb-000001", "tree": [
        make_node("http.generate", 102.01, 30.0, "tbbb-000001",
                  span_id="g")]}
    sub["tree"][0]["children"] = [
        make_node("session.window", 102.5, 1.0, "tbbb-000001",
                  span_id="w", parent_id="g"),
        make_node("session.close", 103.0, 0.0, "tbbb-000001",
                  span_id="c", parent_id="g")]
    return {"trace_id": "taaa-000001", "tree": [root]}, sub


def test_graft_subtree_and_tree_stats_equal_jax():
    outs = []
    for mod in (reqtrace, jax_reqtrace):
        doc, sub = _trace_docs()
        hop = doc["tree"][0]["children"][1]
        n = mod.graft_subtree(hop, sub, skew_s=2.0, replica="r0",
                              pid=mod.pid_of_trace_id("tbbb-000001"),
                              clock_skew_ms=2000.0)
        mod.tree_stats(doc)
        outs.append((n, doc))
    assert outs[0] == outs[1]
    n, doc = outs[0]
    assert n == 3 and doc["spans"] == 6 and doc["depth"] == 4
    assert doc["processes"] == 2
    for tid in ("t1f-000002", "x", "", "tzz-1"):
        assert reqtrace.pid_of_trace_id(tid) == \
            jax_reqtrace.pid_of_trace_id(tid)
