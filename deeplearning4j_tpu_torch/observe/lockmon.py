"""LockWitness — the runtime cross-check for the GL7xx lockset rules.

The port's copy of `deeplearning4j_tpu/observe/lockmon.py` (stdlib
only, so copied rather than imported).

analysis/locks.py proves lock discipline statically; this module
witnesses it dynamically. During the chaos / thread-hammer suites an
opt-in instrumented-lock wrapper records, per thread, the order in
which named locks are acquired and whether guarded fields are touched
with their guard held. Two event kinds come out:

- **lock-order inversions** (rule GL702): the witness maintains the
  global acquisition-order graph — an edge A→B each time B is acquired
  while A is held — and reports the first time an edge's reverse is
  also observed. The two orders need not happen concurrently (that
  would be the deadlock itself); seeing both orders at all is the
  hazard.
- **unguarded field accesses** (rule GL701): `witness_field()` checks
  the declared guard is in the calling thread's held set.

Each event carries the graft-lint rule id via RUNTIME_RULE_HINTS —
the same static↔runtime cross-check syncmon provides for GL2xx — and
lock *names* use the static pass's identity scheme (`Class.attr`,
e.g. `KVSlotPool._cv`), so a runtime inversion pair is
string-comparable against a static GL702 finding.

Opt-in via `DL4J_TPU_LOCKMON=1` (or `force=True` in tests): the
wrapper adds a Python call and a small critical section per
acquisition — hammer-suite pricing, not production pricing.

    witness = get_witness(force=True)
    a = MonitoredLock("Pair._a_lock", witness=witness)
    b = MonitoredLock("Pair._b_lock", witness=witness)
    ...
    witness.report()["inversions"]   # [{"locks": [...], "rule": "GL702"}]
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

_ENV_FLAG = "DL4J_TPU_LOCKMON"

_lock = threading.Lock()
_witness: Optional["LockWitness"] = None


def lockmon_enabled() -> bool:
    return os.environ.get(_ENV_FLAG, "") == "1"


def get_witness(*, force: bool = False) -> Optional["LockWitness"]:
    """The process-global witness when lockmon is enabled (env flag or
    `force=True`), else None — callers instrument unconditionally and
    pay nothing when disabled."""
    global _witness
    if not (force or lockmon_enabled()):
        return None
    with _lock:
        if _witness is None:
            _witness = LockWitness()
        return _witness


def reset_witness() -> None:
    global _witness
    with _lock:
        _witness = None


def _static_rules() -> Dict[str, str]:
    # the rule ids of the JAX package's linter (`analysis/rules.py`
    # RUNTIME_RULE_HINTS), kept here: the port has no linter
    return {"lock_order": "GL702", "guarded_field": "GL701"}


def _call_site(depth: int = 3) -> str:
    try:
        f = sys._getframe(depth)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:
        return "?"


class LockWitness:
    """Per-thread acquisition stacks + the global order graph."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tls = threading.local()
        #: (held, acquired) -> {"count", "site", "threads"}
        self.edges: Dict[Tuple[str, str], dict] = {}
        self.inversions: List[dict] = []
        self.unguarded: List[dict] = []
        self.acquisitions = 0
        self._seen_pairs: Set[FrozenSet[str]] = set()
        self._seen_unguarded: Set[Tuple[str, str]] = set()

    # ----------------------------------------------------- thread state
    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def held(self) -> Tuple[str, ...]:
        """The calling thread's currently-held named locks, outer-first."""
        return tuple(self._stack())

    # ------------------------------------------------------------ events
    def note_acquire(self, name: str, site: Optional[str] = None) -> None:
        stack = self._stack()
        site = site or _call_site()
        tname = threading.current_thread().name
        with self._lock:
            self.acquisitions += 1
            for h in stack:
                if h == name:
                    continue              # re-entrant RLock hold
                rec = self.edges.setdefault(
                    (h, name), {"count": 0, "site": site, "threads": []})
                rec["count"] += 1
                if tname not in rec["threads"]:
                    rec["threads"].append(tname)
                rev = self.edges.get((name, h))
                pair = frozenset((h, name))
                if rev is not None and pair not in self._seen_pairs:
                    self._seen_pairs.add(pair)
                    self.inversions.append({
                        "rule": "GL702",
                        "locks": sorted(pair),
                        "order_a": {"first": name, "then": h,
                                    "site": rev["site"]},
                        "order_b": {"first": h, "then": name,
                                    "site": site},
                    })
        stack.append(name)

    def note_release(self, name: str) -> None:
        stack = self._stack()
        # innermost matching hold; tolerate out-of-order release
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def witness_field(self, owner: str, field: str, guard: str,
                      *, write: bool = False) -> None:
        """Record a guarded-field access; an event is emitted when the
        guard is NOT in the calling thread's held set."""
        if guard in self._stack():
            return
        key = (f"{owner}.{field}", guard)
        site = _call_site()
        with self._lock:
            if key in self._seen_unguarded:
                return
            self._seen_unguarded.add(key)
            self.unguarded.append({
                "rule": "GL701",
                "field": f"{owner}.{field}",
                "guard": guard,
                "write": bool(write),
                "site": site,
                "thread": threading.current_thread().name,
            })

    # ------------------------------------------------------------ report
    def report(self) -> dict:
        """Everything the hammer suites assert on, plus the static rule
        ids (the runtime → static cross-check: an inversion here means
        graft-lint GL702 should have flagged the pair at review time)."""
        with self._lock:
            locks = sorted({n for e in self.edges for n in e})
            return {
                "acquisitions": self.acquisitions,
                "locks": locks,
                "edges": [{"held": a, "acquired": b,
                           "count": rec["count"],
                           "threads": list(rec["threads"])}
                          for (a, b), rec in sorted(self.edges.items())],
                "inversions": [dict(ev) for ev in self.inversions],
                "unguarded": [dict(ev) for ev in self.unguarded],
                "static_rules": _static_rules(),
            }


class MonitoredLock:
    """Drop-in `threading.Lock`/`RLock` wrapper that reports every
    acquisition to a LockWitness under the static pass's lock name.

    With no witness (lockmon disabled) it degrades to one attribute
    indirection over the inner lock. `Condition` wait/notify users
    should monitor the *Condition's* underlying lock instead — wrap via
    `threading.Condition(MonitoredLock(...))` only in hammer suites."""

    __slots__ = ("name", "_inner", "_witness")

    def __init__(self, name: str, *, witness: Optional[LockWitness] = None,
                 rlock: bool = False, inner=None):
        self.name = name
        self._inner = inner if inner is not None else (
            threading.RLock() if rlock else threading.Lock())
        self._witness = witness if witness is not None else get_witness()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got and self._witness is not None:
            self._witness.note_acquire(self.name)
        return got

    def release(self) -> None:
        if self._witness is not None:
            self._witness.note_release(self.name)
        self._inner.release()

    def __enter__(self) -> "MonitoredLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return bool(locked()) if callable(locked) else False
