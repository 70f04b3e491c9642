"""Collective-traffic observability: the comm ledger and the reshard
witness (the port's `deeplearning4j_tpu/observe/commsmon.py`).

**The HLO parser** — `parse_hlo_collectives`, `summarize_collectives`
and `wire_bytes` are the JAX package's, copied (text and arithmetic,
stdlib only): they read a compiled XLA module's collectives, so the
port keeps them for HLO text it is handed (the JAX package's dumps).

**The runtime ledger** — the port compiles no program to parse. Its
collectives are explicit calls, every one through
`parallel/distributed.py`'s wrappers, which record each call here
(`record_collective`): its kind (all-reduce and all-gather, the HLO
names, or broadcast, ring-priced as a group collective), payload bytes
and group size, and the purpose the caller names (grads, params, loss,
bn_stats, ...). Per-call `wire_bytes` follows the JAX package's
one-pass ring convention: `payload * (g-1)/g` for the group
collectives, so a data-parallel gradient all-reduce reconciles with
`bytes(params) * (n-1)/n`; degenerate groups (g <= 1) are kept in the
list but out of the totals. `CommLedger.summary()` is
`summarize_collectives`' block, so an owner that prices one step
(`ParallelWrapper`) hands it to the watchdog's `record_collectives`
and `owner_comm_totals` answers as the JAX package's does.

**The reshard witness** — opt-in via `DL4J_TPU_COMMSMON=1` (or
`force=True`). In the JAX package it catches the implicit reshards
GSPMD inserts where an argument's committed sharding differs from the
spine's. The port has no implicit reshards: a tensor carries no
sharding, every placement is a rank's own tensor, and every movement
between placements is a collective the code calls. So `check()` finds
nothing to compare (no committed spec) and the witness records the
port's EXPLICIT reshards instead (`record_reshard`): a checkpoint
restored onto another rank count.
"""

from __future__ import annotations

import os
import re
import sys
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

_ENV_FLAG = "DL4J_TPU_COMMSMON"

#: Canonical collective kinds the ledger classifies (HLO opcode order
#: matters: longest-prefix first so `all-reduce-start` is not read as
#: `all-reduce` + junk, and `reduce-scatter` is not shadowed).
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "collective-permute", "all-to-all")

_BYTES_PER_ELEM = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e4m3b11fnuz": 1, "f8e5m2": 1,
    "f8e4m3": 1, "f8e3m4": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}

# `f32[128,64]{1,0}` / `bf16[16]` / `f32[]` — dtype + dims, layout
# suffix ignored. Tuple shapes recurse through _shape_bytes.
_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")

# one HLO instruction: `%name = <shape> <opcode>(<operands>), attr=...`
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\(?[^=]*?\)?)\s*"
    r"((?:all-reduce|all-gather|reduce-scatter|collective-permute|"
    r"all-to-all)(?:-start)?)\(",
)

# replica_groups={{0,1},{2,3}}  (explicit) — groups counted by `{`
_GROUPS_EXPLICIT_RE = re.compile(r"replica_groups=\{(\{[^}]*\}"
                                 r"(?:,\{[^}]*\})*)\}")
# replica_groups=[2,4]<=[8]     (iota: 2 groups of 4 over 8 devices)
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _component_bytes(shape_text: str) -> List[int]:
    """Byte size of each array shape mentioned in `shape_text` (tuple
    shapes yield one entry per component)."""
    out = []
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        elem = _BYTES_PER_ELEM.get(dtype)
        if elem is None:
            continue                    # token/opaque types carry no bytes
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        out.append(n * elem)
    return out


def _shape_bytes(shape_text: str) -> int:
    """Total bytes of every array shape in `shape_text`."""
    return sum(_component_bytes(shape_text))


def _group_info(line: str) -> Tuple[int, int]:
    """(group_count, group_size) from a collective's replica_groups
    attribute; (1, 0) when absent/unparseable (size 0 = unknown)."""
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return max(int(m.group(1)), 1), int(m.group(2))
    m = _GROUPS_EXPLICIT_RE.search(line)
    if m:
        groups = m.group(1).split("},{")
        sizes = [len([t for t in g.strip("{}").split(",") if t.strip()])
                 for g in groups]
        return max(len(groups), 1), max(sizes) if sizes else 0
    return 1, 0


def wire_bytes(kind: str, payload: int, group_size: int) -> int:
    """Estimated per-device interconnect bytes for one collective under
    the one-pass ring convention (see module docstring). Unknown group
    size conservatively charges the full payload."""
    g = group_size
    if g <= 1:
        return 0 if g == 1 else payload
    if kind == "collective-permute":
        return payload
    return int(payload * (g - 1) / g)


def parse_hlo_collectives(text: str) -> List[dict]:
    """Walk compiled-module HLO text; one dict per collective op:

        {"kind", "payload_bytes", "wire_bytes", "group_count",
         "group_size", "degenerate", "name"}

    Tolerant by construction: lines that look collective-ish but do not
    parse are skipped (never raise — this runs inside the compile-cost
    seam), async `-done` halves are not double-counted (the `-start`
    carries the shape), and unknown ops simply do not match."""
    ops: List[dict] = []
    for line in text.splitlines():
        m = _INSTR_RE.match(line)
        if m is None:
            continue
        shape_text, opcode = m.group(1), m.group(2)
        kind = opcode[:-6] if opcode.endswith("-start") else opcode
        if kind not in COLLECTIVE_KINDS:
            continue
        # payload: the op's RESULT shape — for all-gather that is the
        # gathered (full) tensor, for all-reduce the reduced tensor;
        # reduce-scatter's result is the shard, so the full pre-scatter
        # payload is result * group_size (below). Async `-start` forms
        # print a tuple (operand, result, ...): the largest component
        # is the payload (the `-done` half never matches the opcode
        # pattern, so async ops count exactly once).
        if opcode.endswith("-start"):
            comps = _component_bytes(shape_text)
            payload = max(comps) if comps else 0
        else:
            payload = _shape_bytes(shape_text)
        gc, gs = _group_info(line)
        if kind == "reduce-scatter" and gs > 1:
            payload *= gs
        name_m = re.match(r"^\s*(?:ROOT\s+)?(%?[\w.\-]+)", line)
        ops.append({
            "kind": kind,
            "payload_bytes": int(payload),
            "wire_bytes": wire_bytes(kind, payload, gs),
            "group_count": gc,
            "group_size": gs,
            "degenerate": gs == 1,
            "name": name_m.group(1) if name_m else "?",
        })
    return ops


def summarize_collectives(ops: Sequence[dict]) -> dict:
    """Aggregate a parsed op list into the ledger block the watchdog
    snapshot and span attrs carry. Degenerate (single-participant)
    collectives are listed but excluded from totals, so `ops == 0`
    really means "no cross-device traffic"."""
    by_kind: Dict[str, dict] = {}
    total_ops = 0
    total_wire = 0
    total_payload = 0
    for op in ops:
        if op.get("degenerate"):
            continue
        k = op["kind"]
        row = by_kind.setdefault(
            k, {"ops": 0, "payload_bytes": 0, "wire_bytes": 0,
                "max_group_size": 0})
        row["ops"] += 1
        row["payload_bytes"] += op["payload_bytes"]
        row["wire_bytes"] += op["wire_bytes"]
        row["max_group_size"] = max(row["max_group_size"],
                                    op["group_size"])
        total_ops += 1
        total_wire += op["wire_bytes"]
        total_payload += op["payload_bytes"]
    return {"ops": total_ops,
            "payload_bytes": int(total_payload),
            "wire_bytes": int(total_wire),
            "degenerate_ops": sum(1 for op in ops
                                  if op.get("degenerate")),
            "by_kind": by_kind}


def publish_collectives(owner_class: str, summary: dict,
                        registry=None) -> None:
    """Bump the per-owner/kind ledger counters for one priced step's
    collective inventory (bounded cardinality: owner CLASS x kinds)."""
    if not summary.get("ops"):
        return
    if registry is None:
        from deeplearning4j_tpu_torch.observe.registry import get_registry
        registry = get_registry()
    for kind, row in summary.get("by_kind", {}).items():
        registry.counter("jit_collective_ops_total", owner=owner_class,
                         kind=kind).inc(row["ops"])
        registry.counter("jit_collective_bytes_total", owner=owner_class,
                         kind=kind).inc(row["wire_bytes"])


# ======================================================= runtime ledger

class CommLedger:
    """Every collective a process ran, as `parse_hlo_collectives`' op
    dicts plus a `purpose` and whether it was staged through the host;
    past `max_ops` a call is counted in `dropped` instead (a long run
    does not grow the list without bound)."""

    def __init__(self, max_ops: int = 100_000):
        self._lock = threading.Lock()
        self.max_ops = int(max_ops)
        self.ops: List[dict] = []
        self.dropped = 0

    def record(self, kind: str, payload_bytes: int, group_size: int, *,
               purpose: str = "", staged: bool = False) -> dict:
        op = {"kind": kind,
              "payload_bytes": int(payload_bytes),
              "wire_bytes": wire_bytes(kind, int(payload_bytes),
                                       int(group_size)),
              "group_count": 1,
              "group_size": int(group_size),
              "degenerate": int(group_size) <= 1,
              "name": purpose or kind,
              "purpose": purpose,
              "staged": bool(staged)}
        with self._lock:
            if len(self.ops) < self.max_ops:
                self.ops.append(op)
            else:
                self.dropped += 1
        return op

    def mark(self) -> int:
        """A position in `ops`; `summary(since=mark)` covers what came
        after it (one step's collectives)."""
        with self._lock:
            return len(self.ops)

    def since(self, mark: int = 0) -> List[dict]:
        with self._lock:
            return [dict(op) for op in self.ops[mark:]]

    def summary(self, since: int = 0) -> dict:
        return summarize_collectives(self.since(since))

    def reset(self) -> None:
        with self._lock:
            self.ops.clear()
            self.dropped = 0


_ledger = CommLedger()


def get_comm_ledger() -> CommLedger:
    return _ledger


def record_collective(kind: str, payload_bytes: int, group_size: int, *,
                      purpose: str = "", staged: bool = False) -> dict:
    """One collective call into the process-wide ledger (always on: a
    list append under a lock, never a device read)."""
    return _ledger.record(kind, payload_bytes, group_size,
                          purpose=purpose, staged=staged)


# ===================================================== runtime witness

def commsmon_enabled() -> bool:
    return os.environ.get(_ENV_FLAG, "") == "1"


_lock = threading.Lock()
_witness: Optional["ReshardWitness"] = None


def get_reshard_witness(*, force: bool = False,
                        ) -> Optional["ReshardWitness"]:
    """The process-global witness when commsmon is enabled (env flag or
    `force=True`), else None — callers instrument unconditionally and
    pay nothing when disabled (the donatemon contract)."""
    global _witness
    if not (force or commsmon_enabled()):
        return None
    with _lock:
        if _witness is None:
            _witness = ReshardWitness()
        return _witness


def reset_reshard_witness() -> None:
    global _witness
    with _lock:
        _witness = None


def _static_rules() -> Dict[str, str]:
    # the rule id of the JAX package's linter (`analysis/rules.py`
    # RUNTIME_RULE_HINTS), kept here: the port has no linter
    return {"reshard": "GL802"}


def _call_site(depth: int = 3) -> str:
    try:
        f = sys._getframe(depth)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:
        return "?"


def _leaves(obj: Any, name: str) -> Iterator[Tuple[Any, str]]:
    """(leaf, path-name) pairs over the stdlib pytree containers the
    dispatch seams pass; only array-like leaves are yielded."""
    if isinstance(obj, dict):
        for k in obj:
            yield from _leaves(obj[k], f"{name}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{name}[{i}]")
    elif hasattr(obj, "shape") and hasattr(obj, "dtype"):
        yield obj, name


def _committed_spec(leaf) -> Optional[str]:
    """The leaf's committed spec as a canonical string, or None when it
    carries none — every torch tensor: the port's placements are ranks'
    own tensors, never metadata on one."""
    sharding = getattr(leaf, "sharding", None)
    spec = getattr(sharding, "spec", None)
    if spec is None:
        return None
    return "".join(str(tuple(spec)).split())


def canonical_spec(spec) -> str:
    """A spec (or tuple) as the witness's canonical string —
    whitespace-free repr of the tuple form, as the JAX package's."""
    return "".join(str(tuple(spec)).split())


class ReshardWitness:
    """Divergences between a leaf's committed spec and the spine's (the
    JAX package's events, which the port cannot produce: see the module
    docstring), and the port's explicit reshards (`record_reshard`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.checks = 0
        self.events: List[dict] = []
        self.reshards: List[dict] = []
        self._traced_owners: set = set()
        self._seen: set = set()

    # ----------------------------------------------------------- checks
    def check(self, obj: Any, name: str, expected, *, owner: str,
              site: Optional[str] = None) -> List[dict]:
        """Check every array leaf of `obj` against `expected` (a spec or
        a callable leaf -> spec). A leaf with no committed spec is
        skipped, as in the JAX package; a torch tensor has none."""
        site = site or _call_site()
        out: List[dict] = []
        first_for_owner = False
        with self._lock:
            self.checks += 1
            for leaf, path in _leaves(obj, name):
                actual = _committed_spec(leaf)
                if actual is None:
                    continue
                exp = expected(leaf) if callable(expected) else expected
                exp_s = canonical_spec(exp)
                if actual == exp_s:
                    continue
                key = (owner, path)
                if key in self._seen:
                    continue
                self._seen.add(key)
                ev = {"rule": "GL802", "owner": owner, "arg": path,
                      "root": name, "expected": exp_s, "actual": actual,
                      "site": site,
                      "thread": threading.current_thread().name}
                self.events.append(ev)
                out.append(ev)
                if owner not in self._traced_owners:
                    self._traced_owners.add(owner)
                    first_for_owner = True
        if out:
            self._publish(out, first_for_owner)
        return out

    def record_reshard(self, owner: str, what: str, *, leaves: int,
                       payload_bytes: int, from_ranks: int,
                       to_ranks: int, site: Optional[str] = None) -> dict:
        """One explicit reshard the port ran: `what` is "restore" (a
        checkpoint written on `from_ranks` ranks reassembled onto
        `to_ranks`)."""
        ev = {"owner": owner, "what": what, "leaves": int(leaves),
              "payload_bytes": int(payload_bytes),
              "from_ranks": int(from_ranks), "to_ranks": int(to_ranks),
              "site": site or _call_site(),
              "thread": threading.current_thread().name}
        with self._lock:
            self.reshards.append(ev)
        try:
            from deeplearning4j_tpu_torch.observe.registry import (
                get_registry,
            )
            get_registry().counter("reshards_total", owner=owner,
                                   what=what).inc()
            from deeplearning4j_tpu_torch.observe.flight import get_flight
            get_flight().record("reshard", **ev)
        # the counter and breadcrumb are reporting channels; the list
        # above is the record either way
        except Exception:
            pass
        return ev

    def _publish(self, events: List[dict], force_trace: bool) -> None:
        """Counters + flight breadcrumbs + (first per owner) a forced
        trace exemplar — all best-effort, never load-bearing."""
        try:
            from deeplearning4j_tpu_torch.observe.registry import (
                get_registry,
            )
            reg = get_registry()
            for ev in events:
                reg.counter("reshard_events_total",
                            owner=ev["owner"]).inc()
        except Exception:
            pass
        try:
            from deeplearning4j_tpu_torch.observe.flight import get_flight
            fr = get_flight()
            for ev in events:
                fr.record("reshard_event", **ev)
        except Exception:
            pass
        if force_trace:
            try:
                from deeplearning4j_tpu_torch.observe import reqtrace
                ev = events[0]
                tid = reqtrace.error_trace(
                    "commsmon.reshard", rule=ev["rule"],
                    owner=ev["owner"], arg=ev["arg"],
                    expected=ev["expected"], actual=ev["actual"],
                    site=ev["site"])
                with self._lock:
                    ev["trace_id"] = tid
            except Exception:
                pass

    # ------------------------------------------------------------ report
    def report(self) -> dict:
        with self._lock:
            return {"checks": self.checks,
                    "events": [dict(ev) for ev in self.events],
                    "reshards": [dict(ev) for ev in self.reshards],
                    "static_rules": _static_rules()}


def instrument(fn, *, name: Optional[str] = None,
               arg_specs: Optional[Sequence] = None,
               arg_names: Optional[Sequence[str]] = None,
               witness: Optional[ReshardWitness] = None):
    """Wrap a dispatch entry point with the reshard witness (the JAX
    package's seam). With commsmon disabled the function is returned
    UNCHANGED."""
    if witness is None:
        witness = get_reshard_witness()
    if witness is None:
        return fn
    label = name or getattr(fn, "__name__", "step_fn")
    specs = tuple(arg_specs or ())

    def _name(i: int) -> str:
        if arg_names is not None and i < len(arg_names):
            return arg_names[i]
        return f"arg{i}"

    def wrapper(*args, **kwargs):
        site = _call_site(2)
        for i, a in enumerate(args):
            if i < len(specs) and specs[i] is not None:
                witness.check(a, _name(i), specs[i], owner=label,
                              site=site)
        return fn(*args, **kwargs)

    wrapper.__name__ = f"commsmon[{label}]"
    wrapper.__wrapped__ = fn
    return wrapper


def check_dispatch_args(owner: str, named_args: Dict[str, tuple],
                        witness: Optional[ReshardWitness] = None) -> None:
    """In-place witness seam for dispatch loops (the executor's step):
    each entry is name -> (value, expected_spec). No-op when commsmon is
    off."""
    if witness is None:
        witness = get_reshard_witness()
    if witness is None:
        return
    site = _call_site(2)
    for arg_name, (value, expected) in named_args.items():
        witness.check(value, arg_name, expected, owner=owner, site=site)
