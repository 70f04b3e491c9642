"""DonationWitness — the runtime cross-check for GL801 use-after-donate.

The port's copy of `deeplearning4j_tpu/observe/donatemon.py` (stdlib
only, so copied rather than imported). A port step updates its trees
in place and donates nothing; what the port gives up is the full
optimizer moments a `ParallelWrapper` replaces by each rank's shard,
which it marks donated (`parallel/data_parallel.py`).

analysis/shardflow.py proves donation discipline statically: a value
passed at a `donate_argnums` position of a jitted call is dead by
contract, and any later read is GL801. This module witnesses the same
contract dynamically. `instrument()` wraps a donating jitted entry
point; after each call the witness marks every array leaf of the
donated arguments as dead (holding a strong reference so the id can
never be reused by a new allocation), and before each call it checks
the incoming arguments against the dead set — passing a stale donated
buffer back in is exactly the bug XLA turns into garbage reads.
`touch()` lets host code assert the same thing at arbitrary points.

Events carry the graft-lint rule id via RUNTIME_RULE_HINTS — the same
static↔runtime cross-check lockmon provides for GL702 — and buffer
names use the static pass's identity scheme (the argument/variable
name, e.g. `state` or `self.params`), so a runtime event is
string-comparable against a static GL801 finding;
`tools/donatemon_smoke.py` asserts exactly that equivalence.

Opt-in via `DL4J_TPU_DONATEMON=1` (or `force=True` in tests). When
disabled, `instrument()` returns the function UNCHANGED — not a
wrapper — so the production step path pays zero Python overhead, zero
extra compiles, and zero extra syncs (the perf gate pins this). When
enabled, the wrapper adds one Python call and an id() sweep over the
argument pytrees per step — hammer-suite pricing, not production
pricing. The witness never reads buffer *contents*: marking and
touching are id()-based, so it adds no device→host syncs even when on.

    w = get_donation_witness(force=True)
    step = instrument(jit_step, (0,), name="train_step",
                      arg_names=("state", "batch"), witness=w)
    state2 = step(state, batch)
    step(state, batch)          # stale! -> GL801 event (or raise)
    w.report()["events"]        # [{"rule": "GL801", "buffer": "state", ...}]
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

_ENV_FLAG = "DL4J_TPU_DONATEMON"

_lock = threading.Lock()
_witness: Optional["DonationWitness"] = None


def donatemon_enabled() -> bool:
    return os.environ.get(_ENV_FLAG, "") == "1"


def get_donation_witness(*, force: bool = False,
                         ) -> Optional["DonationWitness"]:
    """The process-global witness when donatemon is enabled (env flag
    or `force=True`), else None — callers instrument unconditionally
    and pay nothing when disabled."""
    global _witness
    if not (force or donatemon_enabled()):
        return None
    with _lock:
        if _witness is None:
            _witness = DonationWitness()
        return _witness


def reset_donation_witness() -> None:
    global _witness
    with _lock:
        _witness = None


def _static_rules() -> Dict[str, str]:
    # the rule ids of the JAX package's linter (`analysis/rules.py`
    # RUNTIME_RULE_HINTS), kept here: the port has no linter
    return {"use_after_donate": "GL801", "device_serialized": "GL804"}


def _call_site(depth: int = 3) -> str:
    try:
        f = sys._getframe(depth)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:
        return "?"


def _leaves(obj: Any, name: str) -> Iterator[Tuple[Any, str]]:
    """(leaf, path-name) pairs for the stdlib pytree containers the
    step APIs actually pass (dict / list / tuple, nested). Only
    array-like leaves (shape+dtype) are yielded — scalars and strings
    are not donate-able buffers and their ids are reuse-prone."""
    if isinstance(obj, dict):
        for k in obj:
            yield from _leaves(obj[k], f"{name}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{name}[{i}]")
    elif hasattr(obj, "shape") and hasattr(obj, "dtype"):
        yield obj, name


class UseAfterDonateError(RuntimeError):
    """Raised by a witness in raise_on_use mode when a donated buffer
    is touched; carries the GL801 event dict as `.event`."""

    def __init__(self, event: dict):
        self.event = event
        super().__init__(
            f"GL801 use-after-donate: buffer '{event['buffer']}' was "
            f"donated to '{event['callee']}' at {event['donate_site']} "
            f"and touched again at {event['touch_site']}")


class DonationWitness:
    """Dead-buffer ledger keyed by id(), with strong refs pinning ids."""

    def __init__(self, *, raise_on_use: bool = False) -> None:
        self._lock = threading.Lock()
        self.raise_on_use = raise_on_use
        #: id(leaf) -> {"obj": leaf, "buffer", "callee", "site"}
        self._dead: Dict[int, dict] = {}
        self.donations = 0
        self.events: List[dict] = []
        self._seen: set = set()

    # ------------------------------------------------------------ marking
    def mark_donated(self, obj: Any, name: str, callee: str,
                     site: Optional[str] = None) -> int:
        """Mark every array leaf of `obj` dead. The strong reference we
        keep means the CPython id cannot be handed to a fresh array, so
        a later id() hit is always a genuine stale access."""
        site = site or _call_site()
        n = 0
        with self._lock:
            for leaf, path in _leaves(obj, name):
                self._dead[id(leaf)] = {"obj": leaf, "buffer": path,
                                        "root": name, "callee": callee,
                                        "site": site}
                n += 1
            self.donations += n
        return n

    # ----------------------------------------------------------- touching
    def touch(self, obj: Any, name: str,
              site: Optional[str] = None) -> List[dict]:
        """Check `obj`'s leaves against the dead set; one GL801 event
        per (buffer, touch-name) pair. Returns the new events."""
        site = site or _call_site()
        out: List[dict] = []
        with self._lock:
            for leaf, path in _leaves(obj, name):
                rec = self._dead.get(id(leaf))
                if rec is None:
                    continue
                key = (id(leaf), path)
                if key in self._seen:
                    continue
                self._seen.add(key)
                ev = {"rule": "GL801",
                      "buffer": rec["root"],
                      "leaf": rec["buffer"],
                      "touched_as": path,
                      "callee": rec["callee"],
                      "donate_site": rec["site"],
                      "touch_site": site,
                      "thread": threading.current_thread().name}
                self.events.append(ev)
                out.append(ev)
        if out and self.raise_on_use:
            raise UseAfterDonateError(out[0])
        return out

    # ------------------------------------------------------------- report
    def report(self) -> dict:
        """Everything the smoke/chaos suites assert on, plus the static
        rule ids (the runtime → static cross-check: an event here means
        graft-lint GL801 should have flagged the read at review time)."""
        with self._lock:
            return {"donations": self.donations,
                    "dead_buffers": len(self._dead),
                    "events": [dict(ev) for ev in self.events],
                    "static_rules": _static_rules()}


def instrument(fn, donate_argnums: Sequence[int] = (), *,
               name: Optional[str] = None,
               arg_names: Optional[Sequence[str]] = None,
               witness: Optional[DonationWitness] = None):
    """Wrap a donating jitted callable with the donation witness.

    With donatemon disabled (no env flag, no explicit witness) the
    function is returned UNCHANGED — zero overhead, zero extra
    compiles, and the static pass treats `instrument(...)` as a
    transparent wrapper so donation facts flow through either way.

    When enabled: before each call every positional argument is
    touched (a stale donated buffer passed back in fires GL801), and
    after each call the arguments at `donate_argnums` positions are
    marked dead. `arg_names` supplies the static pass's buffer
    identities (e.g. ``("params", "opt_state")``); unnamed positions
    fall back to ``arg<i>``.
    """
    if witness is None:
        witness = get_donation_witness()
    if witness is None:
        return fn
    label = name or getattr(fn, "__name__", "jit_fn")
    donate = tuple(donate_argnums)

    def _name(i: int) -> str:
        if arg_names is not None and i < len(arg_names):
            return arg_names[i]
        return f"arg{i}"

    def wrapper(*args, **kwargs):
        site = _call_site(2)
        for i, a in enumerate(args):
            witness.touch(a, _name(i), site)
        out = fn(*args, **kwargs)
        for i in donate:
            if i < len(args):
                witness.mark_donated(args[i], _name(i), label, site)
        return out

    wrapper.__name__ = f"donatemon[{label}]"
    wrapper.__wrapped__ = fn
    return wrapper
