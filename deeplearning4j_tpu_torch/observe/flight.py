"""FlightRecorder — a crash-safe black box for training and serving (a
copy of `deeplearning4j_tpu/observe/flight.py`, stdlib only).

The observability spine (registry / spans / watchdog / syncmon) answers
"what is happening now?" through live surfaces that die with the
process. When a run crashes at 3am, what you actually need is the last
few seconds BEFORE the crash: the spans that were open, the compiles
and sync events that fired, and what device memory looked like. The
FlightRecorder keeps exactly that — a bounded ring of recent telemetry
events — and dumps it to a JSON artifact the moment something goes
wrong:

- unhandled exception escaping `TrainingExecutor.run` (training crash),
- a `ContinuousBatchingScheduler` worker thread dying (serving outage),
- the RecompileWatchdog crossing its churn threshold (the silent-10x
  signal, captured with full context instead of one log line).

Sources feeding the ring:
- every `span()` / `emit_manual_span()` event (wired through
  `trace._set_flight_sink`, so the ring fills even when no SpanLog is
  installed — recording costs one deque append);
- watchdog compile + cost + threshold events;
- device-memory samples from `observe.devicemon`;
- serving dispatch errors.

The dump is self-contained JSON: ring events, the triggering exception,
plus best-effort registry / watchdog / syncmon snapshots and a
crash-time device-memory sample. Render with `tools/flight_view.py`.

Env knobs:
  DL4J_TPU_FLIGHT=0           disable entirely (record/dump no-ops)
  DL4J_TPU_FLIGHT_CAP=256     ring capacity (events)
  DL4J_TPU_FLIGHT_DIR=<dir>   dump directory (default: tempdir)
  DL4J_TPU_FLIGHT_KEEP=20     retained dumps in the dir (newest N kept;
                              always-on crash dumps can't fill the disk)
  DL4J_TPU_FLIGHT_TRACES=8    sampled request traces embedded per dump

Stdlib-only at import time (the observe package contract); the
torch-touching enrichment (the device sample) is imported lazily inside
`dump()` and is best-effort.
"""

from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")

DEFAULT_CAPACITY = 256
DEFAULT_KEEP = 20        # retained dumps per directory (newest kept)
DEFAULT_TRACES = 8       # request-trace trees embedded in each dump
_PLAIN = (str, int, float, bool, type(None))
_MAX_DEPTH = 4          # payload sanitizer bounds: a flight event must
_MAX_ITEMS = 32         # stay cheap to record and safe to json.dumps
_SLUG_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


def _plain(v: Any, depth: int = 0) -> Any:
    """Recursive analogue of trace._sanitize: JSON scalars pass, small
    dict/list structure is kept (device-memory samples are nested),
    anything else — a CUDA tensor included — degrades to its type name so
    recording an event can never force a device sync."""
    if isinstance(v, _PLAIN):
        return v
    if depth >= _MAX_DEPTH:
        return type(v).__name__
    if isinstance(v, dict):
        return {str(k): _plain(x, depth + 1)
                for k, x in list(v.items())[:_MAX_ITEMS]}
    if isinstance(v, (list, tuple)):
        return [_plain(x, depth + 1) for x in list(v)[:_MAX_ITEMS]]
    return type(v).__name__


class FlightRecorder:
    """Bounded ring of recent telemetry events + crash-dump writer.

    `record()` is the hot path: sanitize + one lock + one deque append
    (the deque evicts the oldest event itself). `dump()` is the cold
    path and NEVER raises — it runs inside exception handlers where a
    secondary failure would mask the real crash.
    """

    def __init__(self, *, capacity: Optional[int] = None,
                 dump_dir: Optional[str] = None,
                 enabled: Optional[bool] = None):
        if capacity is None:
            capacity = int(os.environ.get("DL4J_TPU_FLIGHT_CAP",
                                          str(DEFAULT_CAPACITY)))
        if enabled is None:
            enabled = os.environ.get("DL4J_TPU_FLIGHT", "1") != "0"
        self.capacity = max(1, int(capacity))
        self.enabled = bool(enabled)
        self.dump_dir = (dump_dir
                         or os.environ.get("DL4J_TPU_FLIGHT_DIR")
                         or tempfile.gettempdir())
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._dump_seq = 0
        self.dumps: List[str] = []

    # ---------------------------------------------------------- recording
    def record(self, kind: str, **payload) -> None:
        """Append one event to the ring (sanitized payload)."""
        if not self.enabled:
            return
        self.record_event(kind, _plain(payload))

    def record_event(self, kind: str, data: Dict[str, Any]) -> None:
        """Fast path for pre-sanitized payloads (span events arrive here
        already scrubbed by trace._sanitize)."""
        if not self.enabled:
            return
        ev = {"kind": kind, "ts": round(time.time(), 6), "data": data}
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)

    # ---------------------------------------------------------- reporting
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def snapshot(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "capacity": self.capacity,
                    "recorded_total": self._seq,
                    "events": list(self._events),
                    "dumps": list(self.dumps)}

    # ------------------------------------------------------------ dumping
    def dump(self, reason: str, exc: Optional[BaseException] = None,
             path: Optional[str] = None) -> Optional[str]:
        """Write the black box to a JSON artifact; returns the path, or
        None when disabled or the write failed. Never raises."""
        if not self.enabled:
            return None
        try:
            doc: Dict[str, Any] = {
                "reason": reason,
                "ts": round(time.time(), 6),
                "pid": os.getpid(),
                "exception": None,
                "events": self.events(),
            }
            if exc is not None:
                doc["exception"] = {
                    "type": type(exc).__name__,
                    "message": str(exc)[:2000],
                    "traceback": "".join(traceback.format_exception(
                        type(exc), exc, exc.__traceback__))[-8000:],
                }
            for key, fn in (("registry", self._registry_snapshot),
                            ("watchdog", self._watchdog_snapshot),
                            ("syncmon", self._syncmon_snapshot),
                            ("commsmon", self._commsmon_snapshot),
                            ("devices", self._device_sample),
                            ("traces", self._traces_snapshot)):
                try:
                    doc[key] = fn()
                except Exception:
                    doc[key] = None
            if path is None:
                with self._lock:
                    self._dump_seq += 1
                    n = self._dump_seq
                slug = _SLUG_RE.sub("-", reason)[:48] or "dump"
                path = os.path.join(
                    self.dump_dir,
                    f"flight_{os.getpid()}_{n:03d}_{slug}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, default=str)
            os.replace(tmp, path)     # atomic: a reader never sees half
            with self._lock:
                self.dumps.append(path)
            self._prune_dumps()
            self.record("flight_dump", reason=reason, path=path)
            logger.info("FlightRecorder: wrote %d events to %s "
                        "(reason: %s)", len(doc["events"]), path, reason)
            return path
        except Exception:
            logger.debug("FlightRecorder: dump failed", exc_info=True)
            return None

    def _prune_dumps(self) -> None:
        """Dump-dir hygiene: keep the newest DL4J_TPU_FLIGHT_KEEP
        `flight_*.json` artifacts (any process), delete the rest. Runs
        after every successful dump; best-effort like dump() itself."""
        try:
            keep = int(os.environ.get("DL4J_TPU_FLIGHT_KEEP",
                                      str(DEFAULT_KEEP)))
        except ValueError:
            keep = DEFAULT_KEEP
        if keep <= 0:
            return
        try:
            names = os.listdir(self.dump_dir)
        except OSError:
            return
        cands = []
        for n in names:
            if not (n.startswith("flight_") and n.endswith(".json")):
                continue
            p = os.path.join(self.dump_dir, n)
            try:
                cands.append((os.path.getmtime(p), n, p))
            except OSError:
                continue   # raced with another pruner
        # name is the tiebreak for same-second dumps: the seq counter in
        # the filename sorts newer dumps later
        cands.sort(reverse=True)
        for _, _, p in cands[keep:]:
            try:
                os.remove(p)
            except OSError:
                continue   # raced with another pruner

    # dump enrichment — each is best-effort and individually guarded
    @staticmethod
    def _traces_snapshot():
        from deeplearning4j_tpu_torch.observe.reqtrace import get_trace_store
        try:
            k = int(os.environ.get("DL4J_TPU_FLIGHT_TRACES",
                                   str(DEFAULT_TRACES)))
        except ValueError:
            k = DEFAULT_TRACES
        trees = get_trace_store().last_trees(k)
        return trees or None

    @staticmethod
    def _registry_snapshot():
        from deeplearning4j_tpu_torch.observe.registry import get_registry
        return get_registry().snapshot()

    @staticmethod
    def _watchdog_snapshot():
        from deeplearning4j_tpu_torch.observe.watchdog import get_watchdog
        return get_watchdog().snapshot()

    @staticmethod
    def _syncmon_snapshot():
        from deeplearning4j_tpu_torch.observe.syncmon import current_monitor
        mon = current_monitor()
        return mon.snapshot() if mon is not None else None

    @staticmethod
    def _commsmon_snapshot():
        # the JAX package's schema: the per-owner comm ledger and the
        # reshard witness's report when it is live
        from deeplearning4j_tpu_torch.observe.commsmon import (
            get_reshard_witness,
        )
        from deeplearning4j_tpu_torch.observe.watchdog import get_watchdog
        wit = get_reshard_witness()
        return {"comm_totals": get_watchdog().comm_totals(),
                "reshard": wit.report() if wit is not None else None}

    @staticmethod
    def _device_sample():
        # crash-time device truth: what memory looked like at the end
        from deeplearning4j_tpu_torch.observe.devicemon import (
            device_memory_summary,
        )
        return device_memory_summary()


def read_dump(path: str) -> dict:
    """Load a flight dump back (test / flight_view helper)."""
    with open(path) as f:
        return json.load(f)


def latest_dump(dump_dir: Optional[str] = None) -> Optional[str]:
    """Path of the newest flight dump on disk (any process), or None.

    The recovery breadcrumb: a restart is a NEW process, so the crashed
    run's `FlightRecorder.dumps` list is gone — but its artifact is
    still in the dump directory. `RecoveryPlan` records this path on
    resume so the restarted run carries its predecessor's black box."""
    d = dump_dir or get_flight().dump_dir
    best, best_mtime = None, -1.0
    try:
        names = os.listdir(d)
    except OSError:
        return None
    for n in names:
        if not (n.startswith("flight_") and n.endswith(".json")):
            continue
        p = os.path.join(d, n)
        try:
            m = os.path.getmtime(p)
        except OSError:
            continue       # raced with cleanup — not a candidate
        if m > best_mtime:
            best, best_mtime = p, m
    return best


# ------------------------------------------------------------ process-wide
_flight: Optional[FlightRecorder] = None
_install_lock = threading.Lock()


def _wire(fr: Optional[FlightRecorder]) -> None:
    """Point the span emitters at the ring (None detaches)."""
    from deeplearning4j_tpu_torch.observe import trace
    trace._set_flight_sink(fr if (fr is not None and fr.enabled) else None)


def get_flight() -> FlightRecorder:
    """The process-wide recorder (created — and wired into the span
    path — on first use)."""
    global _flight
    if _flight is None:
        with _install_lock:
            if _flight is None:
                fr = FlightRecorder()
                _wire(fr)
                _flight = fr
    return _flight


def set_flight(fr: FlightRecorder) -> Optional[FlightRecorder]:
    """Swap the process-wide recorder (tests point dump_dir at a tmp
    path this way); returns the previous one."""
    global _flight
    with _install_lock:
        prev, _flight = _flight, fr
    _wire(fr)
    return prev
