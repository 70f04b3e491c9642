"""RecoveryPlan — preemption-proof fit plumbing shared by every fit loop
(port of `deeplearning4j_tpu/optim/recovery.py`).

The plan threads a `ShardedCheckpointer` and a `PreemptionHandler`
through `TrainingExecutor`'s seams (`before_batch` / `after_dispatch` /
`epoch_start` / `epoch_end`), so `MultiLayerNetwork.fit`,
`ComputationGraph.fit` and `ParallelWrapper.fit` share ONE recovery
path:

- **Asynchronous checkpoints off the critical path**: saves happen at
  dispatch boundaries (`after_dispatch`), where params, moments and the
  generator are a consistent snapshot even under fused
  `steps_per_dispatch>1` (the window is indivisible, so the cadence
  coarsens to window ends; a resume into a partial window replays by
  SKIP and the executor drains the tail step by step). `save()` copies
  the tensors to the host; the writer thread writes the files. Nothing
  here reads the loss, so the executor's one host sync an epoch holds.
- **Exact mid-epoch resume** from (step, generator state, iterator
  cursor): `resume="auto"` restores the newest committed checkpoint
  (through `restore_fn` when the caller owns placements —
  `ParallelWrapper`), then replays the epoch's consumed batches as
  SKIPs.
- **Black-box continuity**: a resumed run records the prior crash's
  flight dump as a breadcrumb (`resume` ring event); a preemption stop
  records `preemption_checkpoint` with the exact cursor.
- **Clean preemption**: `preemption=True` installs a SIGTERM handler for
  the fit and restores the previous one after it (degrading to
  `request_stop` off the main thread); the flag, or a caller `stop_fn`,
  stops training at the next batch boundary and `finalize()` writes a
  final exact-position snapshot.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from deeplearning4j_tpu_torch.optim.executor import SKIP, STOP

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["RecoveryPlan", "AUTO", "build_plan", "run_with_recovery"]

AUTO = "auto"


def build_plan(net, **kw) -> Optional["RecoveryPlan"]:
    """A RecoveryPlan when any recovery kwarg is set, else None — so the
    plain `fit()` fast path stays hook-free (no per-batch indirection)."""
    # NB: `is not None`, not truthiness — resume={} (a restore with no
    # recorded position) must still build a plan
    if (kw.get("checkpointer") is None and kw.get("resume") is None
            and kw.get("stop_fn") is None and not kw.get("preemption")):
        return None
    return RecoveryPlan(net, **kw)


def run_with_recovery(execu, plan: Optional["RecoveryPlan"],
                      iterable, epochs: int):
    """Drive `execu.run` under a plan's lifecycle: install the handler,
    resume from the plan's epoch, flush the writer on BOTH exits (without
    masking a training crash), snapshot the exact stop position."""
    if plan is None:
        return execu.run(iterable, epochs)
    with plan:
        try:
            execu.run(iterable, epochs, start_epoch=plan.start_epoch)
        except BaseException:
            plan.abort()
            raise
    plan.finalize(execu.stopped)
    return execu.net


class RecoveryPlan:
    """One fit() call's recovery state machine over the executor seams.

    Parameters
    ----------
    net : the model (params_tree / updater_state / state_tree / _rng /
        iteration / epoch — the ShardedCheckpointer contract).
    checkpointer : Optional[ShardedCheckpointer]; saves every
        `checkpoint_every` iterations at dispatch boundaries, plus a
        final snapshot on early stop.
    resume : None | position dict (from `restore_into*`) | "auto"
        ("auto" restores the newest committed step itself — via
        `restore_fn` when given, else `checkpointer.restore_into(net)`).
    stop_fn : extra stop predicate checked at batch boundaries.
    preemption : None | PreemptionHandler | True. `True` builds a
        SIGTERM handler owned (installed/uninstalled) by the plan's
        context manager; an explicit handler is the caller's to install.
    prepare : per-batch transform applied after the skip/stop gate
        (ParallelWrapper's pad-to-divisible hook).
    """

    def __init__(self, net, *, checkpointer=None, checkpoint_every: int = 1,
                 resume=None, stop_fn: Optional[Callable[[], bool]] = None,
                 preemption=None, prepare: Optional[Callable] = None,
                 restore_fn: Optional[Callable[[], Dict]] = None):
        self.net = net
        self.checkpointer = checkpointer
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.stop_fn = stop_fn
        self.prepare = prepare
        self._owns_handler = preemption is True
        if preemption is True:
            from deeplearning4j_tpu_torch.parallel.elastic import (
                PreemptionHandler,
            )
            preemption = PreemptionHandler()
        self.handler = preemption or None
        if resume == AUTO:
            resume = self._auto_restore(restore_fn)
        self.resume = resume
        self.start_epoch = int(net.epoch) if resume is not None else 0
        self.skip = int((resume or {}).get("batch_in_epoch", 0))
        self.last_batch_index = self.skip - 1
        self._last_saved = int(net.iteration)
        self.stopped = False
        if resume is not None:
            self._resume_breadcrumb()

    # ------------------------------------------------------------ setup
    def _auto_restore(self, restore_fn):
        ck = self.checkpointer
        if ck is None and restore_fn is None:
            raise ValueError(
                'resume="auto" has nothing to restore from: pass '
                "checkpointer=... (or an explicit resume position dict)")
        if ck is None or ck.latest_step() is None:
            return None
        if restore_fn is not None:
            return restore_fn()
        return ck.restore_into(self.net)

    def _resume_breadcrumb(self):
        """The restart carries its predecessor's black box: point the
        ring at the prior crash dump (if one exists on disk)."""
        from deeplearning4j_tpu_torch.observe.flight import (
            get_flight, latest_dump,
        )
        prior = latest_dump()
        get_flight().record(
            "resume", iteration=int(self.net.iteration),
            epoch=int(self.net.epoch), batch_in_epoch=self.skip,
            prior_dump=prior)
        if prior:
            logger.info(
                "Resuming at iteration %d (epoch %d, batch %d); prior "
                "flight dump: %s", self.net.iteration, self.net.epoch,
                self.skip, prior)

    # --------------------------------------------------- executor seams
    def should_stop(self) -> bool:
        if self.handler is not None and self.handler.preempted:
            return True
        return bool(self.stop_fn is not None and self.stop_fn())

    def before_batch(self, bi: int, ds):
        if bi < self.skip:
            return SKIP          # resume replay: already trained
        if self.should_stop():
            return STOP
        if self.prepare is not None:
            ds = self.prepare(ds)
        return ds

    def after_dispatch(self, bi: int) -> None:
        self.last_batch_index = bi
        if self.checkpointer is None:
            return
        it = int(self.net.iteration)
        # modulo keeps the unfused cadence byte-compatible with the old
        # inline closure; the distance test catches cadences a K-step
        # scan window jumps clean over
        if (it % self.checkpoint_every == 0
                or it - self._last_saved >= self.checkpoint_every):
            self._save(bi + 1)

    def epoch_start(self) -> None:
        # a stop before this epoch's first non-skipped batch must
        # checkpoint the RESUMED position (skip batches are already
        # trained), not the previous epoch's tail
        self.last_batch_index = self.skip - 1

    def epoch_end(self) -> None:
        self.skip = 0

    # --------------------------------------------------------- lifecycle
    def __enter__(self) -> "RecoveryPlan":
        if self.handler is not None and self._owns_handler:
            self.handler.install()
        return self

    def __exit__(self, *exc) -> bool:
        if self.handler is not None and self._owns_handler:
            self.handler.uninstall()
        return False

    def _save(self, batch_in_epoch: int) -> None:
        self.checkpointer.save(
            self.net, step=int(self.net.iteration),
            position={"batch_in_epoch": int(batch_in_epoch)})
        self._last_saved = int(self.net.iteration)

    def finalize(self, stopped: bool) -> None:
        """After a clean `run()`: snapshot the exact stop position when
        training ended early, then flush the writer (re-raising any
        writer error — a silently failed checkpoint is a lost run)."""
        self.stopped = bool(stopped)
        ck = self.checkpointer
        if ck is None:
            return
        if stopped:
            if int(self.net.iteration) != self._last_saved:
                # the periodic cadence didn't cover the last dispatch
                self._save(self.last_batch_index + 1)
            from deeplearning4j_tpu_torch.observe.flight import get_flight
            get_flight().record(
                "preemption_checkpoint", iteration=int(self.net.iteration),
                epoch=int(self.net.epoch),
                batch_in_epoch=self.last_batch_index + 1)
        ck.wait()

    def abort(self) -> None:
        """On the exception path: flush the writer WITHOUT raising — the
        original crash must propagate unmasked. Writer errors are
        recorded on the flight ring and logged instead."""
        ck = self.checkpointer
        if ck is None:
            return
        try:
            ck.wait()
        except Exception as e:
            logger.warning(
                "checkpoint writer failed while handling a training "
                "crash: %s: %s", type(e).__name__, e)
            try:
                from deeplearning4j_tpu_torch.observe.flight import get_flight
                get_flight().record("checkpoint_writer_error",
                                    error=type(e).__name__,
                                    message=str(e)[:200])
            # breadcrumb only: the training crash already propagating is
            # the payload
            except Exception:
                pass
