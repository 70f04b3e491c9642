"""Elastic training: preemption handling and the outer driver (port of
`deeplearning4j_tpu/parallel/elastic.py`).

- `PreemptionHandler`: installs signal handlers (SIGTERM, what a
  maintenance event or a scheduler's eviction delivers) that set a flag
  checked at batch boundaries; training stops CLEANLY (after the
  in-flight step and a final checkpoint) instead of dying mid-write.
  `uninstall()` restores the previous handlers.
- `ElasticTrainer`: the outer driver — wrap the model for the mesh,
  resume from the newest committed checkpoint, train with periodic
  asynchronous checkpoints, and on preemption checkpoint and return
  `resumable=True`. Running the same program again (on the same or
  another rank count) continues the loss curve.
"""

from __future__ import annotations

import logging
import signal
from typing import Any, Callable, Dict, Optional, Sequence

from deeplearning4j_tpu_torch.parallel.checkpoint import ShardedCheckpointer
from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper

logger = logging.getLogger("deeplearning4j_tpu_torch")

_warned_off_main_thread = False


class PreemptionHandler:
    """Flag-setting signal handler (reference precedent: none — the
    reference has no preemption story; ParallelWrapper.java:94-99 only
    installs an UncaughtExceptionHandler)."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self._preempted = False
        self._previous: Dict[int, Any] = {}
        self.signals = tuple(signals)
        # True when install() could not register handlers (non-main
        # thread); preemption then only arrives via request_stop()/stop_fn
        self.degraded = False

    def install(self) -> "PreemptionHandler":
        global _warned_off_main_thread
        for s in self.signals:
            try:
                self._previous[s] = signal.signal(s, self._on_signal)
            except ValueError:
                # signal.signal is main-thread-only; under threaded test
                # runners / servers the fit must still run — degrade to
                # the stop_fn/request_stop path instead of crashing
                self.degraded = True
                if not _warned_off_main_thread:
                    _warned_off_main_thread = True
                    logger.warning(
                        "PreemptionHandler.install(): not on the main "
                        "thread, signal handlers unavailable — relying on "
                        "stop_fn/request_stop() for preemption (warning "
                        "once per process)")
        return self

    def uninstall(self) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()

    def _on_signal(self, signum, frame):
        self._preempted = True

    def request_stop(self) -> None:
        """Programmatic preemption — the delivery path that still works
        when install() degraded off the main thread."""
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    def reset(self) -> None:
        self._preempted = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *a):
        self.uninstall()


class ElasticTrainer:
    """Preemption-safe outer training driver over ParallelWrapper +
    ShardedCheckpointer.

    fit() returns a dict: {"completed": bool, "preempted": bool,
    "resumable": bool, "iteration": int} — a preempted run checkpoints
    and returns; running the same fit() again (same directory) resumes
    mid-epoch and finishes the remaining epochs with a bit-identical
    loss curve."""

    def __init__(self, net, checkpoint_dir: str, *, mesh=None,
                 param_rules=None, checkpoint_every: int = 10,
                 max_to_keep: int = 3,
                 preemption_signals: Sequence[int] = (signal.SIGTERM,),
                 stop_fn: Optional[Callable[[], bool]] = None,
                 spine=None, shard_opt_state: bool = True):
        # the spine survives preemption cycles: a restart on a SMALLER
        # mesh builds a fresh context here and restore_into_wrapper
        # re-partitions params AND replica-sharded moments onto it
        self.wrapper = ParallelWrapper(net, mesh=mesh,
                                       param_rules=param_rules,
                                       spine=spine,
                                       shard_opt_state=shard_opt_state)
        self.checkpointer = ShardedCheckpointer(
            checkpoint_dir, max_to_keep=max_to_keep)
        self.checkpoint_every = checkpoint_every
        self.handler = PreemptionHandler(preemption_signals)
        self._extra_stop = stop_fn

    def _should_stop(self) -> bool:
        if self.handler.preempted:
            return True
        return bool(self._extra_stop and self._extra_stop())

    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 128) -> Dict[str, Any]:
        net = self.wrapper.net
        resume = None
        if self.checkpointer.latest_step() is not None:
            resume = self.checkpointer.restore_into_wrapper(self.wrapper)
        with self.handler:
            # the wrapper's RecoveryPlan owns the rest: periodic async
            # saves, the final exact-position snapshot on stop, and the
            # writer flush (finalize) — this driver just supplies the
            # handler-aware stop predicate and reports the outcome
            self.wrapper.fit(
                data, labels, epochs=epochs, batch_size=batch_size,
                checkpointer=self.checkpointer,
                checkpoint_every=self.checkpoint_every,
                resume=resume, stop_fn=self._should_stop)
            # the wrapper's record is authoritative — a transient stop_fn
            # that flipped back must still report the truncated run
            preempted = self.wrapper.stopped_early
        # resumable: the documented contract (JAX's docstring promises
        # it; its dict lacks the key, ROADMAP C22): a preempted run whose
        # stop position is committed
        resumable = bool(preempted
                         and self.checkpointer.latest_step() is not None)
        return {"completed": not preempted, "preempted": preempted,
                "resumable": resumable, "iteration": net.iteration}
