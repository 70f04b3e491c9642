"""Federated metrics — merge N replica registry snapshots into one
fleet-wide view (the data model behind the router's `/fleet/metrics`; a
copy of `deeplearning4j_tpu/observe/fedmon.py`, stdlib only).

This is the cross-PROCESS half of the observability spine: each replica
keeps its own `MetricsRegistry` (registry.py) and the router's poll loop
pulls `/metrics?format=registry` snapshots and feeds them here. The
merge rules are the whole point, and they are pinned by
tests/test_torch_fedmon.py:

- **Counters: summed with per-replica monotonic delta tracking.** A
  replica restart resets its raw counter to 0; the federation notices
  the raw value going backwards, re-bases the delta at 0, and keeps the
  pre-restart total — the fleet counter NEVER goes negative and never
  double-counts.
- **Histograms: merged bucket-wise.** Every process buckets on the same
  `registry.BUCKET_EDGES` ladder, so the fleet histogram over replicas
  is exactly the histogram of the union of observations (count / sum /
  min / max / per-bin counts all loss-free; quantiles estimated from
  the merged cumulative distribution). Restart-safe via the same
  delta scheme as counters.
- **Gauges: labeled, not summed.** A gauge is a point-in-time reading
  per process; the fleet view fans it out under a `replica=` label.
- **Staleness is explicit.** A replica that fails a scrape (or has not
  been scraped within the TTL) gets `fleet_scrape_stale{replica=} = 1`
  and keeps its last-known series — operators see "stale", never a
  silent gap or a phantom zero.

Strictly pull-based and host-side: stdlib only, no network (the scraper
in serving/fleet/obsplane.py does the fetching), no locks shared with
any replica, no device access — federation can never add a sync or a
graph capture to a dispatch path.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.observe.registry import (
    BUCKET_EDGES, BUCKET_VERSION,
)

# replica counted stale when its last successful scrape is older
ENV_STALE_S = "DL4J_TPU_FLEET_STALE_S"
DEFAULT_STALE_S = 15.0

_NBINS = len(BUCKET_EDGES) + 1


def quantile_from_buckets(buckets: List[int], q: float) -> Optional[float]:
    """Estimate the q-quantile from per-bin counts over BUCKET_EDGES
    (linear interpolation inside the covering bin; the +Inf overflow
    bin clamps to the last edge)."""
    total = sum(buckets)
    if total <= 0:
        return None
    rank = max(1, math.ceil(q * total))
    cum = 0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= rank and c > 0:
            lo = BUCKET_EDGES[i - 1] if i > 0 else 0.0
            hi = BUCKET_EDGES[i] if i < len(BUCKET_EDGES) \
                else BUCKET_EDGES[-1]
            frac = (rank - (cum - c)) / c
            return round(lo + frac * (hi - lo), 6)
    return float(BUCKET_EDGES[-1])


def _labels_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _CounterState:
    """Per-(series, replica) monotonic delta tracker."""

    __slots__ = ("raw", "total")

    def __init__(self):
        self.raw = 0.0
        self.total = 0.0

    def update(self, raw: float) -> None:
        raw = float(raw)
        # raw went backwards => the replica restarted: the new raw IS
        # the count since the reset, so the delta re-bases at 0 and the
        # pre-restart total is preserved (never negative).
        self.total += raw - self.raw if raw >= self.raw else raw
        self.raw = raw


class _HistState:
    """Per-(series, replica) bucket-wise delta tracker."""

    __slots__ = ("raw_count", "raw_sum", "raw_buckets",
                 "count", "sum", "buckets", "min", "max")

    def __init__(self):
        self.raw_count = 0
        self.raw_sum = 0.0
        self.raw_buckets = [0] * _NBINS
        self.count = 0
        self.sum = 0.0
        self.buckets = [0] * _NBINS
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def update(self, entry: dict) -> None:
        count = int(entry.get("count") or 0)
        total = float(entry.get("sum") or 0.0)
        buckets = entry.get("buckets")
        if not isinstance(buckets, list) or len(buckets) != _NBINS \
                or entry.get("bucket_v") != BUCKET_VERSION:
            buckets = [0] * _NBINS
        if count >= self.raw_count:
            self.count += count - self.raw_count
            self.sum += total - self.raw_sum
            self.buckets = [
                b + max(0, n - o) for b, n, o in
                zip(self.buckets, buckets, self.raw_buckets)]
        else:                                    # replica restarted
            self.count += count
            self.sum += total
            self.buckets = [b + n for b, n in zip(self.buckets, buckets)]
        self.raw_count, self.raw_sum = count, total
        self.raw_buckets = list(buckets)
        for bound, cur in ((entry.get("min"), "min"),
                           (entry.get("max"), "max")):
            if isinstance(bound, (int, float)):
                prev = getattr(self, cur)
                pick = min if cur == "min" else max
                setattr(self, cur,
                        bound if prev is None else pick(prev, bound))


class FleetFederation:
    """The merged fleet view. `ingest()` on the scrape thread,
    `snapshot()`/`total()`/`merged()` from any reader."""

    def __init__(self, *, stale_after_s: Optional[float] = None):
        self.stale_after_s = float(
            stale_after_s if stale_after_s is not None
            else os.environ.get(ENV_STALE_S, DEFAULT_STALE_S))
        self._lock = threading.Lock()
        # (name, labels) -> {replica: state}
        # guarded by _lock
        self._counters: Dict[tuple, Dict[str, _CounterState]] = {}
        # guarded by _lock
        self._gauges: Dict[tuple, Dict[str, float]] = {}
        # guarded by _lock
        self._hists: Dict[tuple, Dict[str, _HistState]] = {}
        # guarded by _lock
        self._replicas: Dict[str, dict] = {}

    # -------------------------------------------------------- ingestion
    def ingest(self, replica: str, snapshot: dict,
               now: Optional[float] = None) -> None:
        """Merge one replica's registry snapshot (registry.snapshot()
        shape: {"ts", "series": {name: [entry, ...]}})."""
        now = time.time() if now is None else now
        series = snapshot.get("series") or {}
        with self._lock:
            row = self._replicas.setdefault(
                replica, {"scrapes": 0, "failures": 0, "ok": False,
                          "last_scrape_ts": None})
            row["scrapes"] += 1
            row["ok"] = True
            row["last_scrape_ts"] = now
            for name, entries in series.items():
                for entry in entries:
                    labels = dict(entry.get("labels") or {})
                    labels.pop("replica", None)
                    key = (name, _labels_key(labels))
                    kind = entry.get("type")
                    if kind == "counter":
                        self._counters.setdefault(key, {}).setdefault(
                            replica, _CounterState()).update(
                                entry.get("value") or 0.0)
                    elif kind == "gauge":
                        self._gauges.setdefault(key, {})[replica] = \
                            float(entry.get("value") or 0.0)
                    elif kind == "histogram":
                        self._hists.setdefault(key, {}).setdefault(
                            replica, _HistState()).update(entry)

    def mark_unreachable(self, replica: str,
                         now: Optional[float] = None) -> None:
        """Record a failed scrape — the replica keeps its last-known
        series but is flagged stale immediately."""
        with self._lock:
            row = self._replicas.setdefault(
                replica, {"scrapes": 0, "failures": 0, "ok": False,
                          "last_scrape_ts": None})
            row["failures"] += 1
            row["ok"] = False

    def forget(self, replica: str) -> None:
        """Drop a removed replica's per-replica state (its contribution
        to counter/histogram totals is already banked and stays)."""
        with self._lock:
            self._replicas.pop(replica, None)
            for table in (self._counters, self._gauges, self._hists):
                for per_rep in table.values():
                    per_rep.pop(replica, None)

    # ---------------------------------------------------------- readers
    def replicas(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Scrape-health rows: age / staleness per replica."""
        now = time.time() if now is None else now
        out = {}
        with self._lock:
            for name, row in self._replicas.items():
                ts = row["last_scrape_ts"]
                age = None if ts is None else max(0.0, now - ts)
                out[name] = {
                    "last_scrape_ts": ts,
                    "age_s": None if age is None else round(age, 3),
                    "scrapes": row["scrapes"],
                    "failures": row["failures"],
                    "stale": (not row["ok"]) or age is None
                             or age > self.stale_after_s,
                }
        return out

    def total(self, name: str, labels: Optional[dict] = None) -> float:
        """Fleet-wide counter total (sum of restart-safe per-replica
        totals; `labels` subset-matches, None matches every label set)."""
        out = 0.0
        with self._lock:
            for (nm, lk), per_rep in self._counters.items():
                if nm != name:
                    continue
                if labels and not set(_labels_key(labels)) <= set(lk):
                    continue
                out += sum(st.total for st in per_rep.values())
        return out

    def merged(self, name: str,
               labels: Optional[dict] = None) -> Optional[dict]:
        """Bucket-wise merged fleet histogram for one series name —
        equal to a histogram of the union of every replica's
        observations."""
        count, total = 0, 0.0
        buckets = [0] * _NBINS
        lo: Optional[float] = None
        hi: Optional[float] = None
        found = False
        with self._lock:
            for (nm, lk), per_rep in self._hists.items():
                if nm != name:
                    continue
                if labels and not set(_labels_key(labels)) <= set(lk):
                    continue
                for st in per_rep.values():
                    found = True
                    count += st.count
                    total += st.sum
                    buckets = [a + b for a, b in zip(buckets, st.buckets)]
                    if st.min is not None:
                        lo = st.min if lo is None else min(lo, st.min)
                    if st.max is not None:
                        hi = st.max if hi is None else max(hi, st.max)
        if not found:
            return None
        return {"count": count, "sum": round(total, 6), "min": lo,
                "max": hi, "buckets": buckets,
                "p50": quantile_from_buckets(buckets, 0.5),
                "p95": quantile_from_buckets(buckets, 0.95),
                "p99": quantile_from_buckets(buckets, 0.99)}

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Registry-snapshot-shaped merged view: every series fanned out
        under a `replica=` label, plus scrape-health gauges
        (`fleet_scrape_stale{replica=}` / `fleet_scrape_age_seconds`)
        and per-name fleet aggregates (counter sums, bucket-merged
        histograms) under entries WITHOUT a replica label."""
        now = time.time() if now is None else now
        reps = self.replicas(now)
        out: Dict[str, list] = {}

        def add(name, entry):
            out.setdefault(name, []).append(entry)

        with self._lock:
            for (name, lk), per_rep in self._counters.items():
                agg = 0.0
                for rep, st in sorted(per_rep.items()):
                    agg += st.total
                    add(name, {"type": "counter",
                               "labels": dict(lk, replica=rep),
                               "value": round(st.total, 6)})
                add(name, {"type": "counter", "labels": dict(lk),
                           "value": round(agg, 6)})
            for (name, lk), per_rep in self._gauges.items():
                for rep, v in sorted(per_rep.items()):
                    add(name, {"type": "gauge",
                               "labels": dict(lk, replica=rep),
                               "value": v})
            for (name, lk), per_rep in self._hists.items():
                agg = _HistState()
                for rep, st in sorted(per_rep.items()):
                    add(name, {
                        "type": "histogram",
                        "labels": dict(lk, replica=rep),
                        "count": st.count, "sum": round(st.sum, 6),
                        "min": st.min, "max": st.max,
                        "p50": quantile_from_buckets(st.buckets, 0.5),
                        "p95": quantile_from_buckets(st.buckets, 0.95),
                        "p99": quantile_from_buckets(st.buckets, 0.99),
                    })
                    agg.count += st.count
                    agg.sum += st.sum
                    agg.buckets = [a + b for a, b in
                                   zip(agg.buckets, st.buckets)]
                    for v, cur, pick in ((st.min, "min", min),
                                         (st.max, "max", max)):
                        if v is not None:
                            prev = getattr(agg, cur)
                            setattr(agg, cur,
                                    v if prev is None else pick(prev, v))
                add(name, {
                    "type": "histogram", "labels": dict(lk),
                    "count": agg.count, "sum": round(agg.sum, 6),
                    "min": agg.min, "max": agg.max,
                    "buckets": agg.buckets,
                    "p50": quantile_from_buckets(agg.buckets, 0.5),
                    "p95": quantile_from_buckets(agg.buckets, 0.95),
                    "p99": quantile_from_buckets(agg.buckets, 0.99),
                })
        for rep, row in sorted(reps.items()):
            add("fleet_scrape_stale",
                {"type": "gauge", "labels": {"replica": rep},
                 "value": 1.0 if row["stale"] else 0.0})
            if row["age_s"] is not None:
                add("fleet_scrape_age_seconds",
                    {"type": "gauge", "labels": {"replica": rep},
                     "value": row["age_s"]})
        return {"ts": round(now, 3), "series": out, "replicas": reps}

    def series_points(self) -> List[Tuple[str, dict, str, float]]:
        """(name, labels, kind, value) rows for a SeriesStore recorder —
        the scrape tick IS the fleet sampler: per-replica counters and
        gauges as values, merged histograms as `:count` plus
        bucket-estimated quantile keys (the SeriesSampler convention, so
        SLOs written against `name:p99` work unchanged on the fleet
        store)."""
        rows: List[Tuple[str, dict, str, float]] = []
        with self._lock:
            counters = [(k, dict(v)) for k, v in self._counters.items()]
            gauges = [(k, dict(v)) for k, v in self._gauges.items()]
            hist_keys = list(self._hists)
        for (name, lk), per_rep in counters:
            for rep, st in per_rep.items():
                rows.append((name, dict(lk, replica=rep),
                             "counter", st.total))
        for (name, lk), per_rep in gauges:
            for rep, v in per_rep.items():
                rows.append((name, dict(lk, replica=rep), "gauge", v))
        for name, lk in hist_keys:
            doc = self.merged(name, dict(lk))
            if not doc:
                continue
            rows.append((f"{name}:count", dict(lk), "counter",
                         float(doc["count"])))
            for q in ("p50", "p95", "p99"):
                if doc[q] is not None:
                    rows.append((f"{name}:{q}", dict(lk), "quantile",
                                 float(doc[q])))
        return rows


# ------------------------------------------------------------- fleet SLOs

def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def default_fleet_slos() -> list:
    """Fleet-scope objective set, evaluated over the MERGED view (the
    obsplane series store), not any single process. Thresholds
    overridable via DL4J_TPU_FLEET_SLO_* env knobs."""
    from deeplearning4j_tpu_torch.observe.slo import SLO
    e = _env_float
    return [
        SLO("fleet-ttft-p99", series="serving_ttft_ms:p99",
            threshold=e("DL4J_TPU_FLEET_SLO_TTFT_MS", 2000.0),
            description="fleet-merged decode TTFT p99 within bound "
                        "(bucket-merged across every replica)"),
        SLO("fleet-handoff-failures",
            kind="ratio", series="fleet_handoffs_total",
            num=[{"__series__": "fleet_handoff_failures_total"}],
            den=[{}, {"__series__": "fleet_handoff_failures_total"}],
            budget=e("DL4J_TPU_FLEET_SLO_HANDOFF_BUDGET", 0.1),
            description="failed KV handoffs stay inside the budget "
                        "fleet-wide (attempts = handoffs + failures)"),
    ]
