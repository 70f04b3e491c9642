"""Host-side tracing spans with a JSONL event log (a copy of
`deeplearning4j_tpu/observe/trace.py`, which imports only the stdlib).

`span("fit.step")` times HOST-side work only. The contract that makes it
safe to leave enabled in the training hot loop:

- A span never calls `float()` / `.item()` / `repr()` on a device
  value. Attributes are sanitized to plain JSON scalars; anything else
  (a CUDA tensor included) is recorded as its type name, NOT its value —
  recording the value would be a hidden host sync.
- When no span log is installed, `span()` is a no-op context manager
  (one global read + a null yield), so instrumented code paths cost
  nothing in production runs that don't trace.

Events are JSON lines: {"name", "ts", "dur_ms", "span_id", "parent_id",
"thread", "attrs"} — greppable, tailable by
`python -m deeplearning4j_tpu_torch.observe.dump`, and correlatable with
`torch.profiler` trace windows: `ProfilerListener` emits a
"torch.profiler.trace" span bracketing each capture window into the same
log, so a wall-clock region in the span log can be matched to the
device timeline in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

_ids = itertools.count(1)
_tls = threading.local()
_active_log: Optional["SpanLog"] = None
_install_lock = threading.Lock()

# FlightRecorder ring (observe/flight.py) — when installed, every span
# event is ALSO appended to the crash ring, even with no SpanLog active.
# Set via _set_flight_sink (flight.py wires it) so this module never
# imports flight (no cycle).
_flight_sink = None


def _set_flight_sink(sink) -> None:
    global _flight_sink
    _flight_sink = sink

_PLAIN = (str, int, float, bool, type(None))


def _sanitize(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """JSON scalars pass through; everything else degrades to its type
    name so serializing an attribute can never force a device sync."""
    out = {}
    for k, v in attrs.items():
        out[str(k)] = v if isinstance(v, _PLAIN) else type(v).__name__
    return out


class SpanLog:
    """Thread-safe append-only JSONL writer (line-buffered: each event
    is one `write` of one line, so concurrent spans never interleave
    within a line)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a")
        self.events = 0

    def emit(self, event: dict) -> None:
        line = json.dumps(event) + "\n"
        with self._lock:
            if self._f is None:
                return
            self._f.write(line)
            self._f.flush()
            self.events += 1

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def install_span_log(path_or_log) -> SpanLog:
    """Enable span recording process-wide; returns the active SpanLog."""
    global _active_log
    log = (path_or_log if isinstance(path_or_log, SpanLog)
           else SpanLog(path_or_log))
    with _install_lock:
        _active_log = log
    return log


def uninstall_span_log() -> None:
    global _active_log
    with _install_lock:
        log, _active_log = _active_log, None
    if log is not None:
        log.close()


def tracing_enabled() -> bool:
    return _active_log is not None


def _stack() -> List[int]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@contextlib.contextmanager
def span(name: str, /, **attrs) -> Iterator[Optional[dict]]:
    """Time a host-side region. Yields the (mutable) attrs dict when
    tracing is enabled so callers can add results discovered inside the
    span (host values only), or None when disabled (a flight ring alone
    keeps the None yield — the no-SpanLog contract is pinned)."""
    log = _active_log
    fr = _flight_sink
    if log is None and fr is None:
        yield None
        return
    sid = next(_ids)
    st = _stack()
    parent = st[-1] if st else None
    st.append(sid)
    ts = time.time()
    t0 = time.perf_counter()
    try:
        yield attrs if log is not None else None
    finally:
        dur = (time.perf_counter() - t0) * 1e3
        st.pop()
        event = {"name": name, "ts": round(ts, 6),
                 "dur_ms": round(dur, 4), "span_id": sid,
                 "parent_id": parent,
                 "thread": threading.current_thread().name,
                 "attrs": _sanitize(attrs)}
        if log is not None:
            log.emit(event)
        if fr is not None:
            fr.record_event("span", event)


def emit_manual_span(name: str, t_start: float, t_end: float, /,
                     **attrs) -> None:
    """Record a span whose bounds were measured elsewhere (wall-clock
    seconds, e.g. a torch.profiler capture window bracketed by listener
    callbacks)."""
    log = _active_log
    fr = _flight_sink
    if log is None and fr is None:
        return
    st = _stack()
    event = {"name": name, "ts": round(t_start, 6),
             "dur_ms": round((t_end - t_start) * 1e3, 4),
             "span_id": next(_ids),
             "parent_id": st[-1] if st else None,
             "thread": threading.current_thread().name,
             "attrs": _sanitize(attrs)}
    if log is not None:
        log.emit(event)
    if fr is not None:
        fr.record_event("span", event)


def read_spans(path: str) -> List[dict]:
    """Load a span JSONL back into dicts (round-trip/test helper)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
