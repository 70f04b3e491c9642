"""Sync-free telemetry time series: bounded history over the registry (a
copy of `deeplearning4j_tpu/observe/series.py`, stdlib only).

The `MetricsRegistry` answers "what is the value now"; nothing in the
process retained history, so windowed rates ("sheds per second over the
last 5 minutes") and windowed quantiles ("p99 TTFT over the last hour")
— the inputs every SLO decision needs — were uncomputable at runtime.
This module adds exactly that layer and nothing more:

- `SeriesRing` — fixed-capacity ring of (ts, value) pairs for ONE metric
  key, backed by two preallocated `array('d')` buffers: appending a
  sample writes two doubles in place, no allocation, no resize, ever.
- `SeriesStore` — the keyed collection of rings plus the derived views:
  sliding-window deltas/rates for counters and windowed value lists for
  quantile series. Label-aware matching (`match("serving_requests_total",
  outcome="shed")`) so consumers aggregate across models without string
  parsing.
- `SeriesSampler` — a daemon thread that walks the registry's
  instruments every `DL4J_TPU_SERIES_INTERVAL` seconds and appends one
  point per series: counters/gauges record their value; histograms
  record a cumulative `:count` plus derived `:p50/:p95/:p99` keys.

Contract: the sampler reads HOST-side registry state only — it never
touches a device tensor, and the per-sample hot path allocates nothing
(ring buffers are preallocated), so it adds no host sync to a step.
Like the rest of the observe package, this module imports only the
stdlib.
"""

from __future__ import annotations

import os
import threading
import time
from array import array
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_INTERVAL_S = 1.0
DEFAULT_CAPACITY = 512
_QUANTILES = (0.5, 0.95, 0.99)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def series_key(name: str, labels: Dict[str, str]) -> str:
    """Canonical key: `name{k=v,...}` with sorted labels, bare name when
    unlabeled. Matches the identity the registry uses, so one metric
    series maps to exactly one ring."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class SeriesRing:
    """Fixed-capacity (ts, value) ring for one metric key.

    Two parallel `array('d')` buffers are preallocated at construction;
    `append` overwrites in place and wraps, so the oldest point is
    evicted implicitly and steady-state sampling allocates nothing."""

    __slots__ = ("name", "labels", "kind", "capacity",
                 "_ts", "_vals", "_next", "_count")

    def __init__(self, name: str, labels: Dict[str, str], kind: str,
                 capacity: int = DEFAULT_CAPACITY):
        self.name = name
        self.labels = dict(labels)
        self.kind = kind
        self.capacity = max(2, int(capacity))
        self._ts = array("d", bytes(8 * self.capacity))
        self._vals = array("d", bytes(8 * self.capacity))
        self._next = 0          # write cursor
        self._count = 0         # total points ever appended

    @property
    def key(self) -> str:
        return series_key(self.name, self.labels)

    def __len__(self) -> int:
        return min(self._count, self.capacity)

    def append(self, ts: float, value: float) -> None:
        i = self._next
        self._ts[i] = ts
        self._vals[i] = value
        self._next = (i + 1) % self.capacity
        self._count += 1

    def points(self) -> List[Tuple[float, float]]:
        """Oldest→newest copy of the live window."""
        n = len(self)
        if n == 0:
            return []
        start = (self._next - n) % self.capacity
        ts, vals, cap = self._ts, self._vals, self.capacity
        return [(ts[(start + i) % cap], vals[(start + i) % cap])
                for i in range(n)]

    def window(self, window_s: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Points with ts >= now - window_s, oldest→newest."""
        pts = self.points()
        if not pts:
            return []
        cutoff = (now if now is not None else pts[-1][0]) - window_s
        return [p for p in pts if p[0] >= cutoff]

    def last(self) -> Optional[Tuple[float, float]]:
        n = len(self)
        if n == 0:
            return None
        i = (self._next - 1) % self.capacity
        return (self._ts[i], self._vals[i])


class SeriesStore:
    """Keyed collection of rings + the derived windowed views."""

    def __init__(self, *, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(_env_float("DL4J_TPU_SERIES_CAP",
                                      DEFAULT_CAPACITY))
        self.capacity = max(2, int(capacity))
        self._lock = threading.Lock()
        self._rings: Dict[str, SeriesRing] = {}

    # ---------------------------------------------------------- writing
    def ring(self, name: str, labels: Optional[Dict[str, str]] = None,
             kind: str = "gauge") -> SeriesRing:
        """The ring for (name, labels), created on first sight. Call
        sites cache the handle; appends after that are allocation-free."""
        labels = labels or {}
        key = series_key(name, labels)
        with self._lock:
            r = self._rings.get(key)
            if r is None:
                r = self._rings[key] = SeriesRing(
                    name, labels, kind, self.capacity)
            return r

    def record(self, name: str, labels: Optional[Dict[str, str]],
               ts: float, value: float, kind: str = "gauge") -> None:
        self.ring(name, labels, kind).append(ts, value)

    # ---------------------------------------------------------- reading
    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def get(self, key: str) -> Optional[SeriesRing]:
        with self._lock:
            return self._rings.get(key)

    def match(self, name: str, **labels) -> List[SeriesRing]:
        """Rings named `name` whose labels are a superset of `labels` —
        e.g. every model's shed counter via
        `match("serving_requests_total", outcome="shed")`."""
        with self._lock:
            rings = list(self._rings.values())
        out = []
        for r in rings:
            if r.name != name:
                continue
            if all(r.labels.get(k) == str(v) for k, v in labels.items()):
                out.append(r)
        return out

    def delta(self, name: str, window_s: float,
              now: Optional[float] = None, **labels) -> float:
        """Increase of a cumulative counter over the window, summed
        across matching rings (counter resets clamp to 0, never
        negative)."""
        total = 0.0
        for r in self.match(name, **labels):
            pts = r.window(window_s, now)
            if len(pts) >= 2:
                total += max(0.0, pts[-1][1] - pts[0][1])
        return total

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None, **labels) -> float:
        """Per-second sliding-window rate for cumulative counters,
        summed across matching rings. 0.0 until two points exist."""
        best_span = 0.0
        total = 0.0
        for r in self.match(name, **labels):
            pts = r.window(window_s, now)
            if len(pts) >= 2:
                total += max(0.0, pts[-1][1] - pts[0][1])
                best_span = max(best_span, pts[-1][0] - pts[0][0])
        return total / best_span if best_span > 0 else 0.0

    def snapshot(self, window_s: Optional[float] = None,
                 prefix: Optional[str] = None) -> dict:
        """The `GET /series` payload: every ring's live window as
        [[ts, value], ...] pairs (optionally time- and name-filtered)."""
        with self._lock:
            rings = list(self._rings.items())
        now = time.time()
        series = {}
        for key, r in sorted(rings):
            if prefix and not key.startswith(prefix):
                continue
            pts = (r.window(window_s, now) if window_s else r.points())
            if not pts:
                continue
            series[key] = {"kind": r.kind,
                           "points": [[round(t, 3), v] for t, v in pts]}
        return {"ts": round(now, 3), "capacity": self.capacity,
                "series": series}


class SeriesSampler:
    """Background thread appending one point per registry series per
    tick. Host-side only by construction: it reads instrument counters
    and reservoir copies — never a device tensor — so sampling can run
    during training/serving without adding a single device sync."""

    def __init__(self, store: SeriesStore, *, registry=None,
                 interval: Optional[float] = None):
        if registry is None:
            from deeplearning4j_tpu_torch.observe.registry import get_registry
            registry = get_registry()
        self.store = store
        self.registry = registry
        self.interval = (interval if interval is not None else
                         _env_float("DL4J_TPU_SERIES_INTERVAL",
                                    DEFAULT_INTERVAL_S))
        self.interval = max(0.01, float(self.interval))
        self.ticks = 0
        self._callbacks: List[Callable[[float], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -------------------------------------------------------- callbacks
    def add_callback(self, fn: Callable[[float], None]) -> None:
        """`fn(now)` runs on the sampler thread after each tick — the
        SLO engine and anomaly watch evaluate here, off every request
        and step path."""
        # registration happens before start(); the
        # tick loop reads a list() copy
        self._callbacks.append(fn)

    # --------------------------------------------------------- sampling
    def sample_once(self, now: Optional[float] = None) -> int:
        """One synchronous tick (the deterministic seam tests use);
        returns the number of points recorded."""
        now = now if now is not None else time.time()
        wrote = 0
        for inst in self.registry.series():
            labels = dict(inst.labels)
            kind = inst.kind
            if kind in ("counter", "gauge"):
                self.store.record(inst.name, labels, now, inst.value,
                                  kind=kind)
                wrote += 1
            elif kind == "histogram":
                self.store.record(f"{inst.name}:count", labels, now,
                                  inst.count, kind="counter")
                wrote += 1
                pcts = inst.percentiles(_QUANTILES)
                for q in _QUANTILES:
                    p = pcts[f"p{int(q * 100)}"]
                    if p is None:           # never observed: no point
                        continue
                    self.store.record(f"{inst.name}:p{int(q * 100)}",
                                      labels, now, p, kind="quantile")
                    wrote += 1
        # single writer — ticks only moves on the
        # sampler thread (or the test's synchronous sample_once caller)
        self.ticks += 1
        for fn in list(self._callbacks):
            try:
                fn(now)
            # a broken evaluator must not kill the
            # sampler thread; the next tick retries it
            except Exception:
                pass
        return wrote

    # -------------------------------------------------------- lifecycle
    def start(self) -> "SeriesSampler":
        """Idempotent: a running sampler is returned as-is."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="series-sampler")
            self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent: stopping a stopped sampler is a no-op."""
        with self._lock:
            t, self._thread = self._thread, None
            self._stop.set()
        if t is not None and t.is_alive():
            t.join(timeout=5)

    @property
    def running(self) -> bool:
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        # pin the Event once: the reference never changes after
        # __init__, and Event.wait/set are internally synchronized
        with self._lock:
            stop = self._stop
        while not stop.wait(self.interval):
            try:
                self.sample_once()
            # sampling races registry mutation in
            # pathological teardown orders; drop the tick, keep the
            # thread — telemetry must never take the process down
            except Exception:
                pass
