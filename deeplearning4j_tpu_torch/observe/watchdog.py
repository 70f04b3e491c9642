"""RecompileWatchdog — make shape churn loud before it eats a run.

The JAX package counts a compile when a new key enters a model's
`_jit_cache`. The port compiles nothing per shape; its counterpart of a
compile is the first call of a new key in a per-owner cache, the call
that pays for a shape the owner has not seen:

- a `NetGraphs` entry made or captured anew (`utils/cuda_graphs.py`): a
  key's first call runs eagerly and is captured on the card, and a call
  whose in-place addresses changed drops the entry and captures again;
- a batch bucket's first forward in `ParallelInference`
  (`parallel/inference.py`), the serving registry's warm-up.

Each owner reports such a call here with its tag (`owner_tag(owner)`:
the class name and the object's id, so two nets never share a count)
and the watchdog:

- counts them per owning object and per owner class (the class-level
  count feeds the `jit_compiles{owner=<class>}` registry counter, the
  name the JAX package publishes, so its SLO and anomaly detectors read
  the port unchanged — bounded label cardinality);
- records each key's shape signature (its repr), so `snapshot()` shows
  which shapes churned;
- warns ONCE per owner when its count crosses the churn threshold
  (`DL4J_TPU_RECOMPILE_THRESHOLD`, default 10), records the trip in the
  flight recorder and dumps it — every batch is paying a capture.

`warned(owner_tag)` is the deploy gate: `ModelRegistry.deploy` rolls a
deploy back whose warm-up tripped the candidate runner's tag.

Counting costs one lock acquisition per first call, never per step.
The JAX watchdog's XLA cost probe has no counterpart here. Its
collective ledger has one: an owner whose step runs collectives
(`parallel.ParallelWrapper`) prices one step of each key through
`observe/commsmon.py`'s runtime ledger and hands the summary to
`record_collectives`, which `owner_comm_totals` and `comm_totals` read.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")

DEFAULT_THRESHOLD = int(os.environ.get("DL4J_TPU_RECOMPILE_THRESHOLD", "10"))
_MAX_SIGNATURES = 64   # per-owner bound on recorded shape signatures


def owner_tag(owner) -> str:
    """The per-instance tag an owner reports under."""
    return f"{type(owner).__name__}@{id(owner):#x}"


def _flight():
    """The crash ring, or None — watchdog events are breadcrumbs, never
    load-bearing, so any flight failure is swallowed here."""
    try:
        from deeplearning4j_tpu_torch.observe.flight import get_flight
        return get_flight()
    # counting must survive a broken flight recorder
    except Exception:
        return None


class RecompileWatchdog:
    """Counts first calls of new keys per owner; warn-once past
    `threshold`."""

    def __init__(self, *, threshold: int = DEFAULT_THRESHOLD,
                 metrics=None):
        self.threshold = max(1, int(threshold))
        self._metrics = metrics
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._signatures: Dict[str, List[str]] = {}
        self._warned: set = set()
        self._collectives: Dict[str, Dict[str, dict]] = {}

    def _registry(self):
        with self._lock:
            if self._metrics is None:
                from deeplearning4j_tpu_torch.observe.registry import (
                    get_registry,
                )
                self._metrics = get_registry()
            return self._metrics

    def record_compile(self, owner_tag: str, owner_class: str,
                       key) -> None:
        """One first call of key `key` on `owner_tag` (a per-instance
        tag) of class `owner_class`."""
        warn_count = None
        with self._lock:
            n = self._counts.get(owner_tag, 0) + 1
            self._counts[owner_tag] = n
            sigs = self._signatures.setdefault(owner_tag, [])
            if len(sigs) < _MAX_SIGNATURES:
                sigs.append(repr(key))
            if n >= self.threshold and owner_tag not in self._warned:
                self._warned.add(owner_tag)
                warn_count = n
        self._registry().counter("jit_compiles", owner=owner_class).inc()
        fr = _flight()
        if fr is not None:
            fr.record("jit_compile", owner=owner_class, tag=owner_tag,
                      key=repr(key)[:160])
        if warn_count is not None:
            with self._lock:
                recent = self._signatures.get(owner_tag, [])[-5:]
            logger.warning(
                "RecompileWatchdog: %s has run %d new shape keys "
                "(threshold %d) — likely shape churn (dynamic batch or "
                "sequence sizes: every new key is an eager warm-up and a "
                "graph capture, or a bucket's first forward). Recent "
                "keys: %s. Bucket input shapes (pad to fixed batch/length "
                "buckets, as ParallelInference does) or raise "
                "DL4J_TPU_RECOMPILE_THRESHOLD if this workload "
                "legitimately needs many.",
                owner_tag, warn_count, self.threshold, recent)
            if fr is not None:
                # the trip is the black-box moment: dump the ring so the
                # churned signatures survive the run
                fr.record("recompile_threshold_trip", owner=owner_class,
                          tag=owner_tag, compiles=warn_count,
                          threshold=self.threshold)
                fr.dump("recompile_threshold")

    # --------------------------------------------------------- reporting
    def warned(self, owner_tag: str) -> bool:
        """Has this owner tripped the churn threshold? The deploy-gate
        seam: `ModelRegistry.deploy` checks the candidate runner's tag
        after its warm-up and rolls back instead of flipping a version
        that would capture per request."""
        with self._lock:
            return owner_tag in self._warned

    def compiles(self, owner_tag: Optional[str] = None) -> int:
        with self._lock:
            if owner_tag is not None:
                return self._counts.get(owner_tag, 0)
            return sum(self._counts.values())

    def record_collectives(self, owner_tag: str, owner_class: str, key,
                           summary: dict) -> None:
        """Attach one step's collective inventory (the ledger block from
        `commsmon.summarize_collectives`) to an owner's key; publishes
        `jit_collective_ops_total` / `jit_collective_bytes_total{owner,
        kind}` as the JAX package does for a compiled program."""
        with self._lock:
            rows = self._collectives.setdefault(owner_tag, {})
            sig = repr(key)
            if len(rows) < _MAX_SIGNATURES or sig in rows:
                rows[sig] = dict(summary)
        from deeplearning4j_tpu_torch.observe.commsmon import (
            publish_collectives,
        )
        publish_collectives(owner_class, summary,
                            registry=self._registry())
        if summary.get("ops"):
            fr = _flight()
            if fr is not None:
                fr.record("compile_collectives", owner=owner_class,
                          tag=owner_tag, key=repr(key)[:160],
                          ops=summary["ops"],
                          wire_bytes=summary["wire_bytes"])

    def owner_comm_totals(self, owner_tag: str) -> Optional[dict]:
        """Collective totals across every step key this owner priced
        ({"programs", "ops", "wire_bytes"}), or None when it priced
        none. Degenerate single-rank ops never count."""
        with self._lock:
            rows = self._collectives.get(owner_tag)
            if rows is None:
                return None
            return {"programs": len(rows),
                    "ops": sum(r.get("ops", 0) for r in rows.values()),
                    "wire_bytes": sum(r.get("wire_bytes", 0)
                                      for r in rows.values())}

    def comm_totals(self) -> dict:
        """Whole-process comm rollup keyed by owner tag (flight dumps
        embed it)."""
        with self._lock:
            tags = list(self._collectives)
        out = {}
        for tag in tags:
            tot = self.owner_comm_totals(tag)
            if tot is not None:
                out[tag] = tot
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "threshold": self.threshold,
                "total_compiles": sum(self._counts.values()),
                "per_owner": {
                    tag: {"compiles": n,
                          "signatures": list(self._signatures.get(tag, ())),
                          "collectives": {
                              sig: dict(row) for sig, row in
                              self._collectives.get(tag, {}).items()},
                          "warned": tag in self._warned}
                    for tag, n in self._counts.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._signatures.clear()
            self._collectives.clear()
            self._warned.clear()


_cost_failure_logged = False


def note_cost_analysis_failure(detail: str) -> None:
    """A failed flop count must be visible, not silent: DEBUG-log the
    first failure, count every one in
    `profiling_cost_analysis_failures` — and never raise on a training
    path."""
    global _cost_failure_logged
    try:
        from deeplearning4j_tpu_torch.observe.registry import get_registry
        get_registry().counter("profiling_cost_analysis_failures").inc()
    # the counter is the reporting channel; the log below still fires
    except Exception:
        pass
    if not _cost_failure_logged:
        _cost_failure_logged = True
        logger.debug(
            "step cost analysis unavailable (%s); further failures "
            "are counted in profiling_cost_analysis_failures", detail)


# ------------------------------------------------------------ process-wide
_default_watchdog = RecompileWatchdog()
_lock = threading.Lock()


def get_watchdog() -> RecompileWatchdog:
    return _default_watchdog


def set_watchdog(watchdog: RecompileWatchdog) -> RecompileWatchdog:
    """Swap the process-wide watchdog (tests pin thresholds this way);
    returns the previous one."""
    global _default_watchdog
    with _lock:
        prev, _default_watchdog = _default_watchdog, watchdog
    return prev
