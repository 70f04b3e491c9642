"""Fleet observability plane — the router-side half of the cross-process
spine (port of `deeplearning4j_tpu/serving/fleet/obsplane.py`;
`observe/fedmon.py` is the data model, this module does the I/O).

Three capabilities, all strictly PULL-based and entirely off every
replica's dispatch path (a scrape or a stitch costs a replica exactly
one HTTP GET served by its control-plane thread — never a host sync, a
lock on the decode path, or a graph capture):

1. **Trace stitching** — `stitched_trace(tid)` takes the router's own
   tree for a fleet request, and for every `prefill.hop` / `decode.hop`
   span carrying a `replica_trace` id pulls that replica's subtree via
   its existing `GET /trace/{id}` and grafts it underneath
   (reqtrace.graft_subtree), producing ONE causal waterfall across
   processes. Each graft root is stamped `boundary="process"` with the
   replica name, its pid (recovered from the trace-id scheme), and a
   clock-skew estimate from the hop's request/response wall bounds
   (NTP-style: ((t1-t0)+(t2-t3))/2). Dead replicas degrade to an
   `replica.unreachable` placeholder span — the waterfall never 500s
   because a process died; `failover` spans always mark their dead
   replica this way.

2. **Federated metrics + fleet SLOs** — `scrape_once()` runs on the
   router's poll loop: pulls every replica's registry snapshot
   (`/metrics?format=registry`), merges it through `FleetFederation`
   (restart-safe counter deltas, bucket-wise histograms, labeled
   gauges, staleness marks), records the merged view into a fleet
   SeriesStore (the scrape IS the fleet sampler) alongside the
   router's own registry, and evaluates fleet-scope burn-rate SLOs
   over that merged store. A newly-firing fleet SLO feeds the SAME
   auto-drain control loop: the worst-offending replica drains (warm
   migration included) and is undrained when the objective resolves.

3. **Incident bundles** — `trigger_incident()` (SLO breach, failover,
   deploy rollback, replica crash) collects the router's flight dump,
   stitched last-K traces, and — from every involved replica — a
   freshly-requested flight dump plus its last-K trace trees into one
   self-contained `incident-<ts>-<reason>/` directory with a
   manifest.json. Collection runs on a detached thread with bounded
   timeouts: an incident never slows the stream that tripped it.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observe import fedmon, reqtrace
from deeplearning4j_tpu_torch.observe.flight import get_flight
from deeplearning4j_tpu_torch.observe.series import SeriesSampler, SeriesStore
from deeplearning4j_tpu_torch.observe.slo import SLOEngine
from deeplearning4j_tpu_torch.serving.fleet import client

logger = logging.getLogger(__name__)

ENV_INCIDENT_DIR = "DL4J_TPU_INCIDENT_DIR"
ENV_INCIDENT_KEEP = "DL4J_TPU_INCIDENT_KEEP"
ENV_INCIDENT_MIN_S = "DL4J_TPU_INCIDENT_MIN_S"
DEFAULT_INCIDENT_KEEP = 8
DEFAULT_INCIDENT_MIN_S = 30.0
SCRAPE_TIMEOUT_S = 5.0
TRACE_LAST_K = 4

_HOP_SPANS = ("prefill.hop", "decode.hop")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class FleetObsPlane:
    """Owned by a FleetRouter; duck-types against it (`replica_urls()`,
    `registry`, `auto_drain_on_slo`, `drain_replica`/`undrain_replica`,
    `_c_slo_drains`)."""

    def __init__(self, router, *, slos=None,
                 incident_dir: Optional[str] = None,
                 incident_min_interval_s: Optional[float] = None,
                 stale_after_s: Optional[float] = None,
                 trace_last_k: int = TRACE_LAST_K):
        self.router = router
        self.federation = fedmon.FleetFederation(
            stale_after_s=stale_after_s)
        self.store = SeriesStore()
        # manual ticks only (scrape_once drives it); never start()ed
        self._sampler = SeriesSampler(self.store,
                                      registry=router.registry,
                                      interval=3600.0)
        self.slo_engine = SLOEngine(
            self.store, registry=router.registry,
            slos=slos if slos is not None else
            fedmon.default_fleet_slos())
        self.incident_dir = (incident_dir
                             or os.environ.get(ENV_INCIDENT_DIR)
                             or get_flight().dump_dir)
        self.incident_min_interval_s = (
            incident_min_interval_s if incident_min_interval_s is not None
            else _env_float(ENV_INCIDENT_MIN_S, DEFAULT_INCIDENT_MIN_S))
        self.trace_last_k = max(1, int(trace_last_k))
        self._lock = threading.Lock()
        # guarded by _lock
        self._prev_firing: set = set()
        # fleet SLO name -> replica it auto-drained (undrain on resolve)
        # guarded by _lock
        self._fleet_drained: Dict[str, str] = {}
        # guarded by _lock
        self._last_incident_ts = 0.0
        # guarded by _lock
        self._incident_seq = 0
        # guarded by _lock
        self._threads: List[threading.Thread] = []
        # manifest paths of recent bundles (newest last)
        # guarded by _lock
        self.recent: deque = deque(maxlen=32)
        self.scrapes = 0

    # ---------------------------------------------------------- scraping
    def scrape_once(self, now: Optional[float] = None) -> dict:
        """One federation tick, called from the router's poll loop (or
        synchronously by tests): scrape replicas → merge → record the
        merged series → evaluate fleet SLOs → feed the drain loop.
        Never raises; a dead replica is a staleness mark, not an error."""
        now = time.time() if now is None else now
        urls = self.router.replica_urls()
        for name, url in urls.items():
            try:
                snap = client.get_json(url, "/metrics?format=registry",
                                       timeout=SCRAPE_TIMEOUT_S)
                self.federation.ingest(name, snap, now)
            except (client.ReplicaUnreachable,
                    client.ReplicaHTTPError) as e:
                logger.debug("fleet scrape of %s failed: %s", name, e)
                self.federation.mark_unreachable(name, now)
        for name, labels, kind, value in self.federation.series_points():
            self.store.record(name, labels, now, value, kind=kind)
        # the router's own counters join the same store so fleet SLOs
        # can ratio over them (failed handoffs / handoffs)
        self._sampler.sample_once(now)
        payload = self.slo_engine.evaluate(now)
        # single writer — scrape_once runs on the
        # poll thread only (tests call it synchronously)
        self.scrapes += 1
        self._apply_slo_transitions(payload, urls)
        return payload

    def _apply_slo_transitions(self, payload: dict, urls: dict) -> None:
        firing = set(payload.get("firing") or ())
        with self._lock:
            fired = firing - self._prev_firing
            resolved = self._prev_firing - firing
            self._prev_firing = firing
            undrain = [(n, self._fleet_drained.pop(n))
                       for n in list(self._fleet_drained)
                       if n in resolved]
        for name in fired:
            slo = next((s for s in self.slo_engine.slos
                        if s.name == name), None)
            worst = self._worst_replica(slo) if slo is not None else None
            self.trigger_incident(f"slo_breach_{name}",
                                  sorted(urls),
                                  {"slo": name, "worst_replica": worst})
            if worst is not None and \
                    getattr(self.router, "auto_drain_on_slo", False):
                logger.warning("fleet SLO %s firing: draining %s",
                               name, worst)
                self.router._c_slo_drains.inc()
                try:
                    self.router.drain_replica(
                        worst, reason=f"fleet slo: {name}")
                    with self._lock:
                        self._fleet_drained[name] = worst
                # replica vanished between verdict
                # and drain — the poll loop will mark it unhealthy
                except Exception:
                    logger.exception("fleet SLO drain of %s failed",
                                     worst)
        for name, replica in undrain:
            try:
                self.router.undrain_replica(replica)
            # best-effort lift — the operator can
            # undrain manually; state is visible in /fleet
            except Exception:
                logger.exception("fleet SLO undrain of %s failed",
                                 replica)

    def _worst_replica(self, slo) -> Optional[str]:
        """Attribute a fleet-level breach to the worst single replica so
        the drain loop has a target: highest per-replica quantile for
        value objectives over `name:pNN`, highest per-replica failure
        total for ratio objectives."""
        try:
            doc = self.federation.snapshot()
        except Exception:                     # pragma: no cover
            return None
        series = doc.get("series") or {}
        worst, worst_v = None, None
        if slo.kind == "value" and ":" in slo.series:
            base, q = slo.series.rsplit(":", 1)
            for entry in series.get(base, ()):
                rep = (entry.get("labels") or {}).get("replica")
                v = entry.get(q)
                if rep is None or not isinstance(v, (int, float)):
                    continue
                bad = worst_v is None or (v > worst_v if slo.op == ">"
                                          else v < worst_v)
                if bad:
                    worst, worst_v = rep, v
        elif slo.kind == "ratio":
            names = [lab.get("__series__", slo.series)
                     for lab in (slo.num or [{}])]
            for nm in names:
                for entry in series.get(nm, ()):
                    rep = (entry.get("labels") or {}).get("replica")
                    v = entry.get("value")
                    if rep is None or not isinstance(v, (int, float)):
                        continue
                    if worst_v is None or v > worst_v:
                        worst, worst_v = rep, v
        return worst

    # --------------------------------------------------------- stitching
    def stitched_trace(self, trace_id: str,
                       raw: bool = False) -> Optional[dict]:
        """The router's tree for `trace_id` with every hop's replica
        subtree grafted in. Fetches run with NO router lock held."""
        doc = reqtrace.get_trace_store().tree(trace_id)
        if doc is None or raw:
            return doc
        urls = self.router.replica_urls()
        grafted = [0]

        def visit(node):
            attrs = node.get("attrs") or {}
            name = node.get("name")
            if name in _HOP_SPANS and attrs.get("replica_trace"):
                self._graft_hop(node, attrs, urls, grafted)
            elif name == "failover" and attrs.get("dead"):
                self._graft_unreachable(
                    node, str(attrs["dead"]), None,
                    "replica died mid-stream (failover)", grafted)
            for c in list(node.get("children", ())):
                visit(c)

        for root in doc.get("tree", ()):
            visit(root)
        reqtrace.tree_stats(doc)
        doc["stitched"] = True
        doc["grafted_spans"] = grafted[0]
        return doc

    def _graft_hop(self, node: dict, attrs: dict, urls: dict,
                   grafted: list) -> None:
        rtid = str(attrs["replica_trace"])
        replica = attrs.get("replica")
        url = urls.get(replica)
        if url is None:
            self._graft_unreachable(node, replica, rtid,
                                    "replica no longer in the fleet",
                                    grafted)
            return
        try:
            sub = client.get_json(url, f"/trace/{rtid}",
                                  timeout=SCRAPE_TIMEOUT_S)
        except (client.ReplicaUnreachable,
                client.ReplicaHTTPError) as e:
            self._graft_unreachable(node, replica, rtid, str(e)[:200],
                                    grafted)
            return
        # clock skew from the hop's request/response wall bounds
        # (t0/t3 router clock) vs the replica roots' bounds (t1/t2):
        # offset = ((t1-t0)+(t2-t3))/2, positive = replica clock ahead
        roots = sub.get("tree") or []
        skew_s = 0.0
        t0 = node.get("ts")
        dur = node.get("dur_ms") or 0.0
        if roots and isinstance(t0, (int, float)):
            t3 = t0 + dur / 1e3
            t1 = min(r.get("ts", t0) for r in roots)
            t2 = max(r.get("ts", t0) + (r.get("dur_ms") or 0.0) / 1e3
                     for r in roots)
            skew_s = ((t1 - t0) + (t2 - t3)) / 2.0
        grafted[0] += reqtrace.graft_subtree(
            node, sub, skew_s=skew_s, replica=replica,
            pid=reqtrace.pid_of_trace_id(rtid),
            clock_skew_ms=round(skew_s * 1e3, 3))

    @staticmethod
    def _graft_unreachable(node: dict, replica, rtid, error: str,
                           grafted: list) -> None:
        ph = {"name": "replica.unreachable", "ts": node.get("ts"),
              "dur_ms": 0.0, "span_id": None,
              "parent_id": node.get("span_id"),
              "trace_id": rtid or node.get("trace_id"),
              "thread": "-",
              "attrs": {"boundary": "process", "unreachable": True,
                        "replica": replica,
                        "pid": reqtrace.pid_of_trace_id(rtid or ""),
                        "error": error}}
        node.setdefault("children", []).append(ph)
        grafted[0] += 1

    # --------------------------------------------------------- incidents
    def trigger_incident(self, reason: str, involved: List[str],
                         extra: Optional[dict] = None,
                         sync: bool = False) -> Optional[str]:
        """Rate-limited bundle collection on a detached thread (or
        inline with `sync=True`); returns the bundle dir for sync calls,
        else None. Never raises."""
        now = time.time()
        with self._lock:
            if now - self._last_incident_ts < \
                    self.incident_min_interval_s:
                return None
            self._last_incident_ts = now
            self._incident_seq += 1
            seq = self._incident_seq
        if sync:
            return self._collect(reason, list(involved), extra or {},
                                 seq)
        t = threading.Thread(
            target=self._collect,
            args=(reason, list(involved), extra or {}, seq),
            name=f"fleet-incident-{seq}", daemon=True)
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()
        return None

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Join outstanding incident collectors (tests/smoke)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return all(not t.is_alive() for t in threads)

    def _collect(self, reason: str, involved: List[str], extra: dict,
                 seq: int) -> Optional[str]:
        try:
            return self._collect_inner(reason, involved, extra, seq)
        # incident collection is best-effort by
        # contract — it must never take down the poll loop or a stream
        except Exception:
            logger.exception("incident collection failed (%s)", reason)
            return None

    def _collect_inner(self, reason: str, involved: List[str],
                       extra: dict, seq: int) -> str:
        slug = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:48] or "incident"
        bundle = os.path.join(
            self.incident_dir,
            f"incident-{int(time.time() * 1000)}-{os.getpid()}"
            f"-{seq:03d}-{slug}")
        os.makedirs(bundle, exist_ok=True)
        manifest: dict = {"reason": reason, "ts": round(time.time(), 3),
                          "router_pid": os.getpid(), "extra": extra,
                          "replicas": []}
        # 1. the router's own black box
        path = get_flight().dump(
            f"incident_{reason}",
            path=os.path.join(bundle, "router_flight.json"))
        manifest["router_flight"] = (os.path.basename(path)
                                     if path else None)
        # 2. stitched last-K traces (the cross-process waterfalls the
        #    flight dump alone cannot carry)
        stitched = []
        for tree in reqtrace.get_trace_store().last_trees(
                self.trace_last_k):
            try:
                stitched.append(self.stitched_trace(tree["trace_id"])
                                or tree)
            # a half-dead fleet still bundles —
            # fall back to the unstitched local tree
            except Exception:
                stitched.append(tree)
        with open(os.path.join(bundle, "stitched_traces.json"),
                  "w") as f:
            json.dump(stitched, f, indent=1, default=str)
        manifest["stitched_traces"] = "stitched_traces.json"
        manifest["stitched_count"] = len(stitched)
        # 3. every involved replica's dump + last-K traces
        urls = self.router.replica_urls()
        names = [n for n in involved if n in urls] or sorted(urls)
        for name in names:
            manifest["replicas"].append(
                self._collect_replica(name, urls[name], reason, bundle))
        mpath = os.path.join(bundle, "manifest.json")
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        os.replace(tmp, mpath)
        with self._lock:
            self.recent.append(mpath)
        self.router.registry.counter("fleet_incidents_total",
                                     reason=reason).inc()
        self._prune_bundles()
        logger.warning("fleet incident bundle written: %s (%s)",
                       bundle, reason)
        return bundle

    def _collect_replica(self, name: str, url: str, reason: str,
                         bundle: str) -> dict:
        row: dict = {"name": name, "url": url, "unreachable": False,
                     "error": None, "flight": None, "traces": None}
        try:
            # ask for a fresh dump so the bundle carries the replica's
            # state AT the incident, not whenever it last crashed;
            # fall back to whatever artifact already exists
            try:
                client.post_json(url, "/flight/dump",
                                 {"reason": f"incident_{reason}"},
                                 timeout=SCRAPE_TIMEOUT_S)
            # older replicas lack POST /flight/dump
            # — the /flight/latest fallback below still applies
            except client.ReplicaHTTPError:
                pass
            try:
                dump = client.get_json(url, "/flight/latest",
                                       timeout=SCRAPE_TIMEOUT_S)
                fname = f"replica_{name}_flight.json"
                with open(os.path.join(bundle, fname), "w") as f:
                    json.dump(dump, f, indent=1, default=str)
                row["flight"] = fname
            except client.ReplicaHTTPError as e:
                row["error"] = f"no flight dump: {e}"
            listing = client.get_json(url, "/trace",
                                      timeout=SCRAPE_TIMEOUT_S)
            trees = []
            for tid in (listing.get("traces") or [])[-self.trace_last_k:]:
                try:
                    trees.append(client.get_json(
                        url, f"/trace/{tid}",
                        timeout=SCRAPE_TIMEOUT_S))
                # trace evicted between list and
                # fetch — bundle the ones that survive
                except client.ReplicaHTTPError:
                    pass
            if trees:
                fname = f"replica_{name}_traces.json"
                with open(os.path.join(bundle, fname), "w") as f:
                    json.dump(trees, f, indent=1, default=str)
                row["traces"] = fname
            row["trace_count"] = len(trees)
        except (client.ReplicaUnreachable, OSError) as e:
            row["unreachable"] = True
            row["error"] = str(e)[:200]
        return row

    def _prune_bundles(self) -> None:
        """Keep the newest DL4J_TPU_INCIDENT_KEEP incident-* dirs."""
        try:
            keep = int(os.environ.get(ENV_INCIDENT_KEEP,
                                      str(DEFAULT_INCIDENT_KEEP)))
        except ValueError:
            keep = DEFAULT_INCIDENT_KEEP
        try:
            dirs = sorted(
                d for d in os.listdir(self.incident_dir)
                if d.startswith("incident-")
                and os.path.isdir(os.path.join(self.incident_dir, d)))
            for d in dirs[:-keep] if keep > 0 else dirs:
                shutil.rmtree(os.path.join(self.incident_dir, d),
                              ignore_errors=True)
        # hygiene only — a failed prune must not
        # fail the incident that triggered it
        except OSError:
            pass

    # ----------------------------------------------------------- payload
    def metrics_payload(self, now: Optional[float] = None) -> dict:
        """The `GET /fleet/metrics` body: the merged federation view,
        scrape health, and the fleet SLO verdicts."""
        doc = self.federation.snapshot(now)
        doc["scrapes"] = self.scrapes
        doc["slo"] = self.slo_engine.snapshot()
        with self._lock:
            doc["incidents"] = list(self.recent)
            doc["fleet_drained"] = dict(self._fleet_drained)
        return doc
