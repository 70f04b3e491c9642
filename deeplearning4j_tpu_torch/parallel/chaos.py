"""Fault-injection harness: deterministic chaos for the recovery path
(port of `deeplearning4j_tpu/parallel/chaos.py`, on the port's
`TrainingListener`).

Every failure mode the preemption-proofing claims to survive has an
injectable, deterministic trigger here, so tests can kill runs at exact
step and file boundaries and check a bit-identical resume:

- `SigtermAtStep` — a TrainingListener that delivers a real SIGTERM (or
  `PreemptionHandler.request_stop()` when given a handler: the path off
  the main thread) at iteration N. CPython runs signal handlers between
  bytecodes on the main thread, so the flag is set before the next
  batch-boundary check: the stop lands at a deterministic batch.
- `CheckpointIOFault` — a `ShardedCheckpointer.fault_hook` that raises
  after a chosen number of file writes ("kill the writer after the first
  shard file"): a half-written step is invisible and resume takes the
  previous committed step.
- `FailingIterator` / `StallingIterator` — a data-pipeline crash or
  stall at batch K.
- `ReplicaKill` — SIGKILL a serving replica process mid-stream.

Test and operations tooling: stdlib only, no syncs, inert unless wired
in.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Callable, Iterable, Iterator, Optional

from deeplearning4j_tpu_torch.optim.listeners import TrainingListener

__all__ = [
    "SigtermAtStep", "CheckpointIOFault", "FailingIterator",
    "StallingIterator", "InjectedFault", "ReplicaKill",
]


class InjectedFault(OSError):
    """The exception every injector raises by default — recognizable in
    logs/flight dumps as chaos, never a real IO failure."""


class SigtermAtStep(TrainingListener):
    """Deliver SIGTERM to this process when iteration N completes.

    With a `handler` (a PreemptionHandler) the trigger calls
    `request_stop()` instead of `os.kill` — the off-main-thread path
    where signal delivery isn't available (threaded test runners).
    `fired` records delivery so tests can assert the fault actually ran.
    """

    def __init__(self, at_iteration: int,
                 handler: Optional[Any] = None):
        self.at_iteration = int(at_iteration)
        self.handler = handler
        self.fired = False

    def iteration_done(self, model, iteration, epoch, score):
        if self.fired or iteration < self.at_iteration:
            return
        self.fired = True
        if self.handler is not None:
            self.handler.request_stop()
        else:
            os.kill(os.getpid(), signal.SIGTERM)


class CheckpointIOFault:
    """`ShardedCheckpointer.fault_hook` raising at an exact file boundary.

    `fail_after=N` lets N matching writes succeed and kills the N+1-th;
    `kind` filters which boundary counts ("shard" | "manifest" |
    "commit" | None for all). `times` bounds how many checkpoints die
    (default 1: the writer fails once, later saves succeed — the
    recover-after-fault scenario). Counters are writer-thread-touched
    only, so no lock is needed beyond the GIL.
    """

    def __init__(self, *, fail_after: int = 1, kind: Optional[str] = "shard",
                 times: int = 1,
                 exc_factory: Callable[[], BaseException] = None):
        self.fail_after = int(fail_after)
        self.kind = kind
        self.times = int(times)
        self.exc_factory = exc_factory or (
            lambda: InjectedFault("injected checkpoint IO fault"))
        self.touched = 0
        self.raised = 0

    def __call__(self, kind: str, path: str) -> None:
        if self.kind is not None and kind != self.kind:
            return
        if self.raised >= self.times:
            return
        self.touched += 1
        if self.touched > self.fail_after:
            self.raised += 1
            self.touched = 0      # re-arm for the next checkpoint attempt
            raise self.exc_factory()


class ReplicaKill:
    """Kill a whole serving-fleet replica PROCESS — the fleet-scale
    fault: one mesh vanishes mid-stream with no goodbye (SIGKILL, so
    no handler runs and no socket closes cleanly). The router must
    notice the dead stream, fail the session over to another replica
    (KV handed off or re-prefilled), and the client's token sequence
    must continue uncorrupted — which the fleet chaos suite asserts
    byte-for-byte against an uninterrupted greedy run.

    `target` is a pid or any object with a `.pid` (a launcher
    ReplicaProcess, a subprocess.Popen). `after_tokens` arms a
    client-side trigger: call `maybe_fire(n_tokens_streamed)` from the
    consuming loop and the kill lands exactly once, at the first event
    at or past the threshold — deterministic in token count, not in
    wall time."""

    def __init__(self, target: Any, *, after_tokens: int = 0,
                 sig: int = signal.SIGKILL):
        self.target = target
        self.after_tokens = int(after_tokens)
        self.sig = sig
        self.fired = False

    @property
    def pid(self) -> int:
        return int(getattr(self.target, "pid", self.target))

    def fire(self) -> None:
        if self.fired:
            return
        self.fired = True
        try:
            os.kill(self.pid, self.sig)
        # target already dead: the fault still "happened"; injection is
        # idempotent by design
        except ProcessLookupError:
            pass

    def maybe_fire(self, n_tokens: int) -> bool:
        if not self.fired and n_tokens >= self.after_tokens:
            self.fire()
            return True
        return False


class FailingIterator:
    """Iterable that raises at batch `fail_at` — the input-pipeline crash
    (a training exception, NOT a clean stop: the executor flight-dumps
    and re-raises, and the next run resumes from the last checkpoint).
    `times` bounds how many epochs/passes fail (default 1)."""

    def __init__(self, inner: Iterable, *, fail_at: int, times: int = 1,
                 exc_factory: Callable[[], BaseException] = None):
        self.inner = inner
        self.fail_at = int(fail_at)
        self.times = int(times)
        self.exc_factory = exc_factory or (
            lambda: InjectedFault("injected iterator failure"))
        self.raised = 0

    def __iter__(self) -> Iterator:
        for i, item in enumerate(iter(self.inner)):
            if i == self.fail_at and self.raised < self.times:
                self.raised += 1
                raise self.exc_factory()
            yield item


class StallingIterator:
    """Iterable that sleeps `stall_s` before yielding batch `stall_at` —
    a slow input pipeline. Recovery must treat this as ordinary ETL time
    (no watchdog trip, no spurious stop), which the chaos suite pins."""

    def __init__(self, inner: Iterable, *, stall_at: int,
                 stall_s: float = 0.25, times: int = 1):
        self.inner = inner
        self.stall_at = int(stall_at)
        self.stall_s = float(stall_s)
        self.times = int(times)
        self.stalled = 0

    def __iter__(self) -> Iterator:
        for i, item in enumerate(iter(self.inner)):
            if i == self.stall_at and self.stalled < self.times:
                self.stalled += 1
                time.sleep(self.stall_s)
            yield item
