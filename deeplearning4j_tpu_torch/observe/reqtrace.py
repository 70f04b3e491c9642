"""Request-scoped causal tracing across the batching and session seams (a
copy of `deeplearning4j_tpu/observe/reqtrace.py`, stdlib only).

Dapper-style trace trees built ON TOP of the sync-free span machinery in
`observe/trace.py` (same span-id counter, same attribute discipline): a
`TraceContext` is minted at the HTTP edge, rides through scheduler
admission, **fans in** to shared batched dispatches (one dispatch span
per participating trace, all listing the co-batched trace ids), and
threads through decode-session steps and training dispatch windows.

Contracts:

- **Never a host sync.** Span attributes are host scalars; anything else
  degrades to its type name exactly like `trace._sanitize` — recording a
  device value's *content* would be a hidden sync. Shallow lists/tuples
  of scalars are allowed (co-batched trace-id lists), capped at
  `_MAX_LIST` items.
- **Sampled-off is zero-allocation.** With `DL4J_TPU_TRACE_SAMPLE`
  unset/0, `new_trace()` returns None before allocating anything and
  every call site is a single `is None` check; no span object, dict, or
  TraceContext is created on the HTTP→dispatch→session path.
- **Anomalies always trace.** Shed / expired / deadline-missed /
  worker-crash requests get a forced error trace regardless of the
  sampling rate (`error_trace`), so the tail is always attributable.

Head-based sampling is deterministic (every round(1/rate)-th eligible
request), not random, so a run is reproducible. The store is bounded (`DL4J_TPU_TRACE_CAP` traces, oldest
evicted) so an unbounded request stream cannot grow memory.

The fleet stitches one tree across processes with `pid_of_trace_id`,
`tree_stats` and `graft_subtree` (host-side tree surgery only).
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.observe import trace as _trace

ENV_SAMPLE = "DL4J_TPU_TRACE_SAMPLE"
ENV_CAP = "DL4J_TPU_TRACE_CAP"

_PLAIN = (str, int, float, bool, type(None))
_MAX_LIST = 32
_MAX_SPANS_PER_TRACE = 1000

_trace_seq = itertools.count(1)
_sample_seq = itertools.count()
_tls = threading.local()

# Implicit carrier for the admission seam: the HTTP edge sets it, and
# `ContinuousBatchingScheduler.submit` falls back to it when no explicit
# trace is passed. Fan-OUT only — the fan-in seam (one dispatch, N
# traces) uses the worker-thread dispatch handoff below instead, because
# a single contextvar cannot represent N parents.
_current: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_tpu_trace", default=None)


def _attr(v: Any) -> Any:
    """Same degradation rule as trace._sanitize, plus shallow scalar
    lists (co-batched trace ids) — never serializes a device value."""
    if isinstance(v, _PLAIN):
        return v
    if isinstance(v, (list, tuple)):
        return [x if isinstance(x, _PLAIN) else type(x).__name__
                for x in list(v)[:_MAX_LIST]]
    return type(v).__name__


def _attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    return {str(k): _attr(v) for k, v in attrs.items()}


class TraceContext:
    """One sampled request: trace id + root span id + sampling decision.

    `span_id` is the ROOT span's id, preallocated at mint time so child
    spans (queue wait, dispatch, session steps) can parent on it before
    the root itself is recorded by `finish_root`."""

    __slots__ = ("trace_id", "span_id", "sampled", "name", "ts", "_t0")

    def __init__(self, trace_id: str, name: str):
        self.trace_id = trace_id
        self.span_id = next(_trace._ids)
        self.sampled = True
        self.name = name
        self.ts = time.time()
        self._t0 = time.perf_counter()

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id}, root={self.span_id})"


class TraceStore:
    """Bounded process-wide span store keyed by trace id.

    `spans_recorded` counts every span ever added — the disabled-fast-path
    test pins it at 0 after an untraced request storm."""

    def __init__(self, cap: Optional[int] = None):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        self.cap = int(cap if cap is not None
                       else os.environ.get(ENV_CAP, "256"))
        self.spans_recorded = 0

    def add_span(self, trace_id: str, event: dict) -> None:
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                spans = self._traces[trace_id] = []
                while len(self._traces) > max(1, self.cap):
                    self._traces.popitem(last=False)
            if len(spans) < _MAX_SPANS_PER_TRACE:
                spans.append(event)
            self.spans_recorded += 1

    def spans(self, trace_id: str) -> List[dict]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def __contains__(self, trace_id: str) -> bool:
        with self._lock:
            return trace_id in self._traces

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def tree(self, trace_id: str) -> Optional[dict]:
        """Reconstructed span tree: {"trace_id", "spans", "depth",
        "tree": [roots]} or None for an unknown trace."""
        spans = self.spans(trace_id)
        if not spans:
            return None
        nodes = {}
        for ev in spans:
            nodes[ev["span_id"]] = dict(ev, children=[])
        roots = []
        for sid, node in nodes.items():
            parent = nodes.get(node.get("parent_id"))
            if parent is not None and parent is not node:
                parent["children"].append(node)
            else:
                roots.append(node)
        for node in nodes.values():
            node["children"].sort(key=lambda n: n.get("ts", 0))
        roots.sort(key=lambda n: n.get("ts", 0))

        def depth(node, d=1):
            kids = node["children"]
            return max([depth(c, d + 1) for c in kids], default=d)

        return {"trace_id": trace_id, "spans": len(spans),
                "depth": max([depth(r) for r in roots], default=0),
                "tree": roots}

    def last_trees(self, k: int) -> List[dict]:
        with self._lock:
            ids = list(self._traces)[-max(0, int(k)):]
        return [t for t in (self.tree(tid) for tid in ids)
                if t is not None]


_store = TraceStore()
_store_lock = threading.Lock()


def get_trace_store() -> TraceStore:
    return _store


def set_trace_store(store: TraceStore) -> TraceStore:
    """Swap the process-wide store; returns the previous one (tests)."""
    global _store
    with _store_lock:
        prev, _store = _store, store
    return prev


# ------------------------------------------------------------- sampling

def sample_rate() -> float:
    try:
        return float(os.environ.get(ENV_SAMPLE, "0") or "0")
    except ValueError:
        return 0.0


def _sampled() -> bool:
    rate = sample_rate()
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    period = max(1, round(1.0 / rate))
    return next(_sample_seq) % period == 0


def _new_tid() -> str:
    return f"t{os.getpid():x}-{next(_trace_seq):06x}"


# ------------------------------------------------------------ recording

def record_span(trace_id: str, name: str, *, span_id: Optional[int] = None,
                parent_id: Optional[int] = None, ts: Optional[float] = None,
                dur_ms: float = 0.0, **attrs) -> int:
    """Append one span to a trace (and to the active SpanLog, so request
    spans land in the same JSONL as fit/epoch spans). Host values only —
    attributes degrade like trace._sanitize. Returns the span id."""
    sid = span_id if span_id is not None else next(_trace._ids)
    if ts is None:
        ts = time.time() - dur_ms / 1e3
    event = {"name": name, "ts": round(ts, 6),
             "dur_ms": round(float(dur_ms), 4), "span_id": sid,
             "parent_id": parent_id, "trace_id": trace_id,
             "thread": threading.current_thread().name,
             "attrs": _attrs(attrs)}
    _store.add_span(trace_id, event)
    log = _trace._active_log
    if log is not None:
        log.emit(event)
    return sid


def new_trace(name: str) -> Optional[TraceContext]:
    """Head-sampling gate at the request edge. Returns None (and
    allocates nothing) when the request is not sampled. Root-span
    attributes go on `finish_root`."""
    if not _sampled():
        return None
    return TraceContext(_new_tid(), name)


def finish_root(ctx: Optional[TraceContext], **attrs) -> None:
    """Record the root span covering the whole request; idempotent-ish
    (a second call appends a duplicate root — call once, in `finally`)."""
    if ctx is None:
        return
    record_span(ctx.trace_id, ctx.name, span_id=ctx.span_id,
                parent_id=None, ts=ctx.ts,
                dur_ms=(time.perf_counter() - ctx._t0) * 1e3, **attrs)


def error_trace(name: str, *, ctx: Optional[TraceContext] = None,
                **attrs) -> str:
    """Force-sample an anomaly (shed/expired/deadline/worker-crash).

    If the request already carries a sampled trace, the error span joins
    it; otherwise a single-span trace is minted regardless of the
    sampling rate. Returns the trace id (attach it to the raised
    exception so the HTTP error payload can surface it)."""
    if ctx is not None:
        record_span(ctx.trace_id, name, parent_id=ctx.span_id,
                    error=True, **attrs)
        return ctx.trace_id
    tid = _new_tid()
    record_span(tid, name, error=True, **attrs)
    return tid


def error_extra(exc: BaseException) -> Dict[str, str]:
    """HttpError kwargs for an exception stamped by error_trace."""
    tid = getattr(exc, "trace_id", None)
    return {"trace_id": tid} if tid else {}


# ------------------------------------------------- implicit propagation

def current_trace() -> Optional[TraceContext]:
    return _current.get()


def set_current(ctx: Optional[TraceContext]):
    """Bind the contextvar carrier (the scheduler's per-request
    `contextvars.copy_context()` snapshot picks it up). Returns the
    reset token."""
    return _current.set(ctx)


def reset_current(token) -> None:
    _current.reset(token)


# ------------------------------------------------------ fan-in dispatch

class _DispatchTrace:
    """One shared batched dispatch joining N sampled traces.

    `span_ids` preallocates a dispatch span id per trace so session-step
    spans recorded INSIDE run_batch (same worker thread) can parent on
    their trace's dispatch span before it is closed."""

    __slots__ = ("span_ids", "parents", "co_traces", "ts", "_t0")

    def __init__(self, traces: List[TraceContext]):
        self.span_ids = {c.trace_id: next(_trace._ids) for c in traces}
        self.parents = {c.trace_id: c.span_id for c in traces}
        self.co_traces = sorted(self.span_ids)
        self.ts = time.time()
        self._t0 = time.perf_counter()


def begin_dispatch(traces: List[TraceContext]) -> Optional["_DispatchTrace"]:
    """Open the fan-in window on THIS thread (the scheduler worker that
    is about to call run_batch). Returns None when nothing is sampled."""
    if not traces:
        return None
    dt = _DispatchTrace(traces)
    _tls.dispatch = dt
    return dt


def active_dispatch() -> Optional["_DispatchTrace"]:
    """The dispatch window opened on this thread, if any — how
    `run_batch` implementations attribute per-row work to traces."""
    return getattr(_tls, "dispatch", None)


def end_dispatch(dt: Optional["_DispatchTrace"], **attrs) -> None:
    """Close the fan-in window: one dispatch span PER participating
    trace (same wall bounds, each listing every co-batched trace id)."""
    if dt is None:
        return
    _tls.dispatch = None
    dur = (time.perf_counter() - dt._t0) * 1e3
    for tid, sid in dt.span_ids.items():
        record_span(tid, "dispatch", span_id=sid,
                    parent_id=dt.parents[tid], ts=dt.ts, dur_ms=dur,
                    co_traces=dt.co_traces, **attrs)


# ------------------------------------------- cross-process graft (fleet)

def pid_of_trace_id(trace_id: str) -> Optional[int]:
    """Recover the minting process's pid from a trace id (the
    `t{pid:x}-{seq:06x}` scheme) — how stitched trees label process
    boundaries without an extra endpoint."""
    try:
        if not trace_id or trace_id[0] != "t":
            return None
        return int(trace_id[1:].split("-", 1)[0], 16)
    except (ValueError, IndexError):
        return None


def tree_stats(doc: dict) -> dict:
    """Recompute span count / depth / distinct-pid count over a (possibly
    stitched) tree doc in place; returns the doc."""
    pids = set()
    count = [0]

    def walk(node, d):
        count[0] += 1
        tid = node.get("trace_id")
        pid = pid_of_trace_id(tid) if isinstance(tid, str) else None
        if pid is not None:
            pids.add(pid)
        return max([walk(c, d + 1) for c in node.get("children", ())],
                   default=d)

    doc["depth"] = max([walk(r, 1) for r in doc.get("tree", ())],
                       default=0)
    doc["spans"] = count[0]
    doc["processes"] = len(pids) or 1
    return doc


def graft_subtree(hop_node: dict, subdoc: dict, *, skew_s: float = 0.0,
                  **boundary_attrs) -> int:
    """Graft a remote trace tree under a hop span of a local tree.

    `subdoc` is another process's `TraceStore.tree()` document; its roots
    become children of `hop_node`. Every grafted timestamp is shifted by
    `-skew_s` (the estimated remote-minus-local clock offset) so the
    waterfall lines up on the LOCAL clock; each grafted root is stamped
    with `boundary="process"` plus `boundary_attrs` (replica name, pid,
    skew) so renderers can draw the process-boundary rule. Returns the
    number of spans grafted. Purely host-side tree surgery — no network,
    no locks, no device access."""
    roots = subdoc.get("tree") or []
    n = [0]

    def shift(node):
        n[0] += 1
        if skew_s and isinstance(node.get("ts"), (int, float)):
            node["ts"] = round(node["ts"] - skew_s, 6)
        for c in node.get("children", ()):
            shift(c)

    for root in roots:
        shift(root)
        attrs = dict(root.get("attrs") or {})
        attrs["boundary"] = "process"
        attrs.update(boundary_attrs)
        root["attrs"] = attrs
        hop_node.setdefault("children", []).append(root)
    hop_node["children"].sort(key=lambda c: c.get("ts", 0))
    return n[0]
