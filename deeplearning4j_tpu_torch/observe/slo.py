"""SLO engine: declarative objectives over the telemetry series, with
multi-window burn-rate alerting (SRE-workbook style) and a runtime
anomaly watch (a copy of `deeplearning4j_tpu/observe/slo.py`, stdlib
only).

An objective is "this series stays on the right side of a threshold"
(p99 TTFT ≤ 500 ms, shed+error ratio ≤ 1%, recompiles ≤ N/min, worker
restart streak ≤ 3). Evaluation runs on the series-sampler thread — one
pass over bounded windows of host-side floats, O(windows) work, never
on a request or step path and never touching a device value.

Burn rate follows the SRE workbook's multi-window form: the violating
fraction of the window divided by the error budget, evaluated over a
FAST window (default 5 min — is it bad *now*?) and a SLOW window
(default 1 h — has it been bad long enough to matter?). An SLO fires
only when BOTH exceed the burn threshold, which is what keeps a 30 s
blip from paging while a sustained breach fires within two evaluation
ticks (windows clamp to the samples that exist, so a fresh process
doesn't need an hour of history to alert).

Firing transitions close the loop into the existing machinery:
- a FlightRecorder dump tagged `slo_breach`, with the offending series
  windows embedded in the triggering ring event;
- a forced trace exemplar via `reqtrace.error_trace()` (sampling rate
  ignored), so the breach joins the trace store and /trace/{id};
- `slo_burn_rate{slo=...}` / `slo_firing{slo=...}` gauges and an
  `slo_breaches_total{slo=...}` counter published back into the
  registry (and therefore into /metrics and the next sampler tick);
- the serving `/healthz` handler folds `firing()` into its degraded
  verdict with the breach list in the body.

`AnomalyWatch`: a recompile-storm detector (`jit_compiles` — in the
port, new graph captures and first bucket forwards, `watchdog.py` —
climbing again after the process reached steady state, blamed on the
responsible owner) and a
sync-regression detector (host syncs/step trending up against the run's
own baseline). Stdlib-only, like the rest of the observe package.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observe.series import SeriesStore

logger = logging.getLogger("deeplearning4j_tpu_torch")

DEFAULT_FAST_WINDOW_S = 300.0      # "is it bad now"
DEFAULT_SLOW_WINDOW_S = 3600.0     # "has it been bad long enough"
DEFAULT_BURN_THRESHOLD = 14.4      # SRE workbook fast-burn page factor
DEFAULT_BUDGET = 0.01              # 99% objective


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class SLO:
    """One declarative objective.

    kind:
      "value"        — each sampled point of the matched series is
                       compared to `threshold` (`op` side is the
                       violation); burn = violating fraction / budget.
      "ratio"        — Δ(bad counters) / Δ(all counters) over the
                       window; burn = ratio / budget.
      "rate_per_min" — counter increase per minute over the window;
                       burn = rate / threshold (budget unused).
    `series` is the metric name; `labels` restricts the match (subset
    semantics, so unlabeled matches every model). For "ratio",
    `num`/`den` are lists of label-dicts summed over the same series
    name."""

    __slots__ = ("name", "kind", "series", "labels", "op", "threshold",
                 "budget", "fast_s", "slow_s", "burn_threshold", "num",
                 "den", "description")

    def __init__(self, name: str, *, kind: str = "value",
                 series: str = "", labels: Optional[dict] = None,
                 op: str = ">", threshold: float = 0.0,
                 budget: float = DEFAULT_BUDGET,
                 fast_s: Optional[float] = None,
                 slow_s: Optional[float] = None,
                 burn_threshold: Optional[float] = None,
                 num: Optional[List[dict]] = None,
                 den: Optional[List[dict]] = None,
                 description: str = ""):
        if kind not in ("value", "ratio", "rate_per_min"):
            raise ValueError(f"unknown SLO kind: {kind!r}")
        if op not in (">", "<"):
            raise ValueError("op must be '>' or '<'")
        self.name = name
        self.kind = kind
        self.series = series
        self.labels = dict(labels or {})
        self.op = op
        self.threshold = float(threshold)
        self.budget = max(1e-9, float(budget))
        self.fast_s = float(fast_s if fast_s is not None else
                            _env_float("DL4J_TPU_SLO_FAST_S",
                                       DEFAULT_FAST_WINDOW_S))
        self.slow_s = float(slow_s if slow_s is not None else
                            _env_float("DL4J_TPU_SLO_SLOW_S",
                                       DEFAULT_SLOW_WINDOW_S))
        if burn_threshold is None:
            burn_threshold = (1.0 if kind == "rate_per_min" else
                              _env_float("DL4J_TPU_SLO_BURN",
                                         DEFAULT_BURN_THRESHOLD))
        self.burn_threshold = float(burn_threshold)
        self.num = [dict(d) for d in (num or [])]
        self.den = [dict(d) for d in (den or [])]
        self.description = description

    # ------------------------------------------------------- evaluation
    def _violates(self, v: float) -> bool:
        return v > self.threshold if self.op == ">" else v < self.threshold

    def burn(self, store: SeriesStore, window_s: float,
             now: float) -> tuple:
        """(burn_rate, observed_value, worst_window_points) over one
        window. Missing series → (0, None, []) — absent telemetry never
        fires an alert."""
        if self.kind == "value":
            worst_frac, worst_val, worst_pts = 0.0, None, []
            for ring in store.match(self.series, **self.labels):
                pts = ring.window(window_s, now)
                if not pts:
                    continue
                bad = sum(1 for _, v in pts if self._violates(v))
                frac = bad / len(pts)
                if frac >= worst_frac:
                    worst_frac = frac
                    worst_val = pts[-1][1]
                    worst_pts = pts
            return worst_frac / self.budget, worst_val, worst_pts
        if self.kind == "ratio":
            # a num/den label-dict may carry the reserved "__series__"
            # key to draw from a DIFFERENT series name — fleet-scope
            # objectives ratio across counters (failed handoffs over
            # handoffs) that live in distinct series.
            def _delta(lab: dict) -> float:
                lab = dict(lab)
                name = lab.pop("__series__", self.series)
                return store.delta(name, window_s, now, **lab)

            num = sum(_delta(lab) for lab in self.num)
            den = sum(_delta(lab) for lab in self.den)
            ratio = (num / den) if den > 0 else 0.0
            return ratio / self.budget, ratio, []
        # rate_per_min
        rate = store.rate(self.series, window_s, now,
                          **self.labels) * 60.0
        if self.threshold <= 0:
            return 0.0, rate, []
        return rate / self.threshold, rate, []

    def describe(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "series": self.series, "labels": self.labels,
                "op": self.op, "threshold": self.threshold,
                "budget": self.budget,
                "windows_s": [self.fast_s, self.slow_s],
                "burn_threshold": self.burn_threshold,
                "description": self.description}


def default_slos() -> List[SLO]:
    """The serving objective set, thresholds overridable via
    DL4J_TPU_SLO_* env knobs (ms where named so)."""
    e = _env_float
    return [
        SLO("latency-p99", series="serving_latency_seconds:p99",
            threshold=e("DL4J_TPU_SLO_P99_MS", 500.0) / 1e3,
            description="end-to-end request p99 within bound"),
        SLO("ttft-p99", series="serving_ttft_ms:p99",
            threshold=e("DL4J_TPU_SLO_TTFT_MS", 1000.0),
            description="decode time-to-first-token p99 within bound"),
        SLO("itl-p99", series="serving_itl_ms:p99",
            threshold=e("DL4J_TPU_SLO_ITL_MS", 250.0),
            description="decode inter-token latency p99 within bound"),
        SLO("availability", kind="ratio", series="serving_requests_total",
            num=[{"outcome": "failed"}, {"outcome": "shed"},
                 {"outcome": "expired"}],
            den=[{"outcome": "admitted"}, {"outcome": "shed"}],
            budget=e("DL4J_TPU_SLO_ERROR_BUDGET", 0.01),
            description="failed+shed+expired stay inside the error "
                        "budget"),
        SLO("queue-wait-p99", series="serving_queue_wait_ms:p99",
            threshold=e("DL4J_TPU_SLO_QUEUE_MS", 250.0),
            description="admission-queue wait p99 within bound"),
        SLO("recompile-rate", kind="rate_per_min", series="jit_compiles",
            threshold=e("DL4J_TPU_SLO_RECOMPILES_PER_MIN", 12.0),
            description="jit compiles per minute at steady state"),
        SLO("worker-restart-streak",
            series="serving_worker_restart_streak",
            threshold=e("DL4J_TPU_SLO_RESTART_STREAK", 3.0),
            description="consecutive slot-worker crash streak bounded"),
    ]


class SLOEngine:
    """Evaluates the objective set against the series store; runs as a
    sampler callback. All state transitions happen here, on the sampler
    thread — `firing()`/`snapshot()` are cheap reads for /healthz and
    /slo."""

    def __init__(self, store: SeriesStore, *, registry=None,
                 slos: Optional[List[SLO]] = None, flight=None):
        if registry is None:
            from deeplearning4j_tpu_torch.observe.registry import get_registry
            registry = get_registry()
        self.store = store
        self.registry = registry
        self.slos = list(slos) if slos is not None else default_slos()
        self._flight = flight
        self._lock = threading.Lock()
        # guarded by _lock
        self._state: Dict[str, dict] = {
            s.name: {"firing": False, "since": None, "breaches": 0,
                     "trace_id": None} for s in self.slos}
        self._last: Optional[dict] = None
        self.evaluations = 0

    def _get_flight(self):
        if self._flight is not None:
            return self._flight
        from deeplearning4j_tpu_torch.observe.flight import get_flight
        return get_flight()

    # ------------------------------------------------------- evaluation
    def evaluate(self, now: Optional[float] = None) -> dict:
        """One pass over every objective; returns (and caches) the /slo
        payload. O(windows) host work: each objective reads two bounded
        windows of floats."""
        now = now if now is not None else time.time()
        # single writer — evaluate() runs on the
        # sampler thread only
        self.evaluations += 1
        results = []
        for slo in self.slos:
            burn_fast, value, fast_pts = slo.burn(
                self.store, slo.fast_s, now)
            burn_slow, _, _ = slo.burn(self.store, slo.slow_s, now)
            firing = (burn_fast >= slo.burn_threshold
                      and burn_slow >= slo.burn_threshold)
            transition = None
            with self._lock:
                st = self._state[slo.name]
                if firing and not st["firing"]:
                    st["firing"] = True
                    st["since"] = now
                    st["breaches"] += 1
                    transition = "fired"
                elif not firing and st["firing"]:
                    st["firing"] = False
                    st["since"] = None
                    transition = "resolved"
            self.registry.gauge("slo_burn_rate", slo=slo.name).set(
                round(burn_fast, 4))
            self.registry.gauge("slo_firing", slo=slo.name).set(
                1.0 if firing else 0.0)
            if transition == "fired":
                self._on_breach(slo, now, burn_fast, burn_slow, value,
                                fast_pts, st)
            elif transition == "resolved":
                self._on_resolve(slo, now)
            results.append({
                **slo.describe(),
                "firing": st["firing"],
                "since": st["since"],
                "breaches": st["breaches"],
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "value": value,
                "trace_id": st["trace_id"] if st["firing"] else None,
            })
        payload = {"ts": round(now, 3), "evaluations": self.evaluations,
                   "firing": [r["name"] for r in results if r["firing"]],
                   "slos": results}
        with self._lock:
            self._last = payload
        return payload

    # ------------------------------------------------------ transitions
    def _on_breach(self, slo: SLO, now: float, burn_fast: float,
                   burn_slow: float, value, fast_pts, st: dict) -> None:
        self.registry.counter("slo_breaches_total", slo=slo.name).inc()
        # forced trace exemplar: the breach joins the trace store even
        # with sampling off, so /trace/{id} can show breach context
        from deeplearning4j_tpu_torch.observe import reqtrace
        tid = reqtrace.error_trace(
            "slo.breach", slo=slo.name, value=value,
            threshold=slo.threshold, burn_fast=round(burn_fast, 3),
            burn_slow=round(burn_slow, 3))
        with self._lock:
            st["trace_id"] = tid
        try:
            fr = self._get_flight()
            # the offending windows ride the triggering ring event into
            # the dump (bounded: the recorder caps embedded lists)
            fr.record("slo_breach", slo=slo.name, value=value,
                      threshold=slo.threshold, op=slo.op,
                      burn_fast=round(burn_fast, 3),
                      burn_slow=round(burn_slow, 3), trace_id=tid,
                      windows={"fast_s": slo.fast_s,
                               "points": [[round(t, 3), v]
                                          for t, v in fast_pts[-24:]]})
            fr.dump(f"slo_breach_{slo.name}")
        # the black box is best-effort; the firing
        # state, gauges and trace above are the alert payload
        except Exception:
            pass
        logger.warning(
            "SLO %s FIRING: value=%s threshold=%s%s burn fast/slow="
            "%.1f/%.1f (trace %s)", slo.name, value, slo.op,
            slo.threshold, burn_fast, burn_slow, tid)

    def _on_resolve(self, slo: SLO, now: float) -> None:
        try:
            self._get_flight().record("slo_resolved", slo=slo.name)
        # resolution breadcrumb is best-effort
        except Exception:
            pass
        logger.info("SLO %s resolved", slo.name)

    # ----------------------------------------------------------- reads
    def firing(self) -> List[str]:
        with self._lock:
            return [n for n, st in self._state.items() if st["firing"]]

    def breaches(self) -> List[dict]:
        """Compact firing detail for the /healthz body."""
        with self._lock:
            last = self._last
        if not last:
            return []
        return [{"slo": r["name"], "value": r["value"],
                 "threshold": r["threshold"],
                 "burn_fast": r["burn_fast"]}
                for r in last["slos"] if r["firing"]]

    def snapshot(self) -> dict:
        with self._lock:
            last = self._last
        if last is not None:
            return last
        return self.evaluate()


class AnomalyWatch:
    """Runtime detectors over the series. Runs as a sampler callback;
    each detector warns once per (kind, owner) while the condition holds
    and re-arms when it clears.

    - recompile storm: a `jit_compiles{owner=...}` series climbing again
      AFTER the process reached steady state (a preceding quiet window),
      blamed on the responsible owner — shape churn.
    - sync regression: `train_host_syncs_per_step` trending above the
      run's own earlier baseline — a new accidental device→host sync on
      the step path."""

    def __init__(self, store: SeriesStore, *, registry=None,
                 recent_s: float = 60.0, storm_compiles: int = 3,
                 sync_margin: float = 0.75):
        if registry is None:
            from deeplearning4j_tpu_torch.observe.registry import get_registry
            registry = get_registry()
        self.store = store
        self.registry = registry
        self.recent_s = float(recent_s)
        self.storm_compiles = int(storm_compiles)
        self.sync_margin = float(sync_margin)
        self._active: Dict[tuple, bool] = {}
        self.warnings: List[dict] = []

    def _warn(self, key: tuple, message: str, **detail) -> None:
        if self._active.get(key):
            return                       # already warned; still active
        self._active[key] = True
        kind, owner = key
        self.registry.counter("anomaly_warnings_total", kind=kind).inc()
        self.warnings.append({"kind": kind, "owner": owner,
                              "ts": round(time.time(), 3), **detail})
        try:
            from deeplearning4j_tpu_torch.observe.flight import get_flight
            get_flight().record("anomaly", kind=kind, owner=owner,
                                **detail)
        # ring breadcrumb is best-effort
        except Exception:
            pass
        logger.warning("anomaly watch: %s", message)

    def _clear(self, key: tuple) -> None:
        if self._active.get(key):
            self._active[key] = False    # re-arm

    def check(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        self._check_recompile_storm(now)
        self._check_sync_regression(now)

    def _check_recompile_storm(self, now: float) -> None:
        for ring in self.store.match("jit_compiles"):
            owner = ring.labels.get("owner", "?")
            key = ("recompile_storm", owner)
            pts = ring.points()
            if len(pts) < 3 or pts[0][0] > now - 2 * self.recent_s:
                continue                 # not at steady state yet
            recent = [v for t, v in pts if t >= now - self.recent_s]
            earlier = [v for t, v in pts if t < now - self.recent_s]
            if not recent or not earlier:
                continue
            burst = recent[-1] - earlier[-1]
            if burst >= self.storm_compiles:
                self._warn(
                    key,
                    f"recompile storm: jit owner {owner!r} compiled "
                    f"{burst:.0f} new programs in the last "
                    f"{self.recent_s:.0f}s after steady state — likely "
                    f"shape churn; see the watchdog's per-owner "
                    f"signatures",
                    owner=owner, burst=burst)
            else:
                self._clear(key)

    def _check_sync_regression(self, now: float) -> None:
        for ring in self.store.match("train_host_syncs_per_step"):
            key = ("sync_regression", ring.key)
            pts = ring.points()
            recent = [v for t, v in pts if t >= now - self.recent_s]
            earlier = sorted(v for t, v in pts
                             if t < now - self.recent_s)
            if not recent or len(earlier) < 3:
                continue
            baseline = earlier[len(earlier) // 2]    # median
            if recent[-1] >= baseline + self.sync_margin:
                owner = self._likely_sync_owner()
                self._warn(
                    key,
                    f"sync regression: host syncs/step rose to "
                    f"{recent[-1]:.2f} from a {baseline:.2f} baseline — "
                    f"a new device→host materialization on the step "
                    f"path; most recently compiled owner: {owner}",
                    owner=owner, value=recent[-1], baseline=baseline)
            else:
                self._clear(key)

    @staticmethod
    def _likely_sync_owner() -> str:
        """Best-effort suspect: the jit owner with the most compiles in
        the watchdog — new dispatch paths usually compile first."""
        try:
            from deeplearning4j_tpu_torch.observe.watchdog import get_watchdog
            per = get_watchdog().snapshot().get("per_owner") or {}
            if not per:
                return "unknown"
            return max(per.items(), key=lambda kv: kv[1]["compiles"])[0]
        # attribution is advisory; the warning
        # itself is the payload
        except Exception:
            return "unknown"
