"""The fit-loop engine — port of `deeplearning4j_tpu/optim/executor.py`.

- `LossTracker` keeps the latest loss as the device tensor the step
  returned and turns it into a Python float only on demand: reading
  ``score_``, a listener calling ``float(score)``, a ``sync_every=N``
  cadence, or the one read at the end of each epoch. So the steady loop
  makes no host sync, and the host runs ahead enqueueing steps.
- `TrainingExecutor` owns the epoch and batch loop, iteration
  bookkeeping, ETL timing, listener fan-out and the epoch-end read.
- Fused dispatch (`steps_per_dispatch=K`): K batches of one
  `batch_signature` are buffered and handed to the net's `fused_step`
  at once, which runs them as one dispatch (a CUDA graph of K train
  steps on the card) and returns a (K,) device loss; listeners get
  `losses[j]` for each step. A short tail, a batch whose signature
  differs from the buffer's and a batch `can_fuse` turns down (a tBPTT
  batch) drain the buffer through the per-step path.

Not ported yet: the recovery hooks (checkpointing, resume, stop) and the
tracing spans.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

import torch

from deeplearning4j_tpu_torch.observe import get_registry

__all__ = ["LossTracker", "TrainingExecutor", "batch_signature"]


class LossTracker:
    """Deferred-sync score holder. ``host_syncs`` counts the reads that
    waited for the device."""

    def __init__(self, sync_every: int = 0):
        self.sync_every = int(sync_every)
        self._raw: Any = None
        self._cached: Optional[float] = None
        self._since_sync = 0
        self.host_syncs = 0
        self.updates = 0

    def set(self, loss) -> None:
        self._raw = loss
        self._cached = None

    def update(self, loss) -> None:
        self.set(loss)
        self.updates += 1
        self._since_sync += 1
        if self.sync_every and self._since_sync >= self.sync_every:
            self.materialize()

    @property
    def value(self) -> Optional[float]:
        """The tracked loss as a float — the sync point."""
        if self._raw is None:
            return None
        if self._cached is None:
            if isinstance(self._raw, torch.Tensor) and self._raw.is_cuda:
                self.host_syncs += 1
            self._cached = float(self._raw)
            self._since_sync = 0
        return self._cached

    def peek(self):
        """The loss without forcing a sync (a tensor if never read)."""
        return self._raw if self._cached is None else self._cached

    def materialize(self) -> Optional[float]:
        return self.value


def _arr_sig(a):
    return None if a is None else (tuple(a.shape), str(a.dtype))


def batch_signature(ds):
    """Two batches fuse into one dispatch only when their signatures
    match: the same kind (DataSet or MultiDataSet), shapes, dtypes and
    mask presence, so the same graph."""
    if hasattr(ds, "features_masks"):   # MultiDataSet
        return ("m",
                tuple(_arr_sig(f) for f in ds.features),
                tuple(_arr_sig(l) for l in ds.labels),
                tuple(_arr_sig(x) for x in (ds.features_masks or ())),
                tuple(_arr_sig(x) for x in (ds.labels_masks or ())))
    return ("d", _arr_sig(ds.features), _arr_sig(ds.labels),
            _arr_sig(ds.features_mask), _arr_sig(ds.labels_mask))


class TrainingExecutor:
    """The epoch/batch/listener loop. `step(ds) -> loss` runs one
    training step and returns the device loss; `fused_step(batches) ->
    losses` runs K steps as one dispatch, for batches `can_fuse(ds)`
    accepts, when `steps_per_dispatch` K > 1."""

    def __init__(self, net, *, step: Callable,
                 fused_step: Optional[Callable] = None,
                 can_fuse: Optional[Callable] = None,
                 steps_per_dispatch: int = 1):
        self.net = net
        self.step = step
        self.fused_step = fused_step
        self.can_fuse = can_fuse or (lambda ds: False)
        self.k = max(1, int(steps_per_dispatch or 1))
        reg = get_registry()
        self._iter_counter = reg.counter("train_iterations")
        self._etl_hist = reg.histogram("train_etl_ms")
        self._dispatch_hist = reg.histogram("train_dispatch_ms")

    def run(self, iterable, epochs: int):
        net = self.net
        listeners = net.listeners
        for l in listeners:
            l.on_fit_start(net)
        for _ in range(epochs):
            for l in listeners:
                l.on_epoch_start(net, net.epoch)
            buf: List = []
            etl_start = time.perf_counter()
            for ds in iter(iterable):
                etl_ms = (time.perf_counter() - etl_start) * 1e3
                fusible = (self.k > 1 and self.fused_step is not None
                           and self.can_fuse(ds))
                if fusible and buf and \
                        batch_signature(buf[0][0]) != batch_signature(ds):
                    self._drain(buf)
                    buf = []
                if fusible:
                    buf.append((ds, etl_ms))
                    if len(buf) == self.k:
                        self._run_fused(buf)
                        buf = []
                else:
                    self._drain(buf)
                    buf = []
                    self._drain([(ds, etl_ms)])
                etl_start = time.perf_counter()
            self._drain(buf)
            for l in listeners:
                l.on_epoch_end(net, net.epoch)
            net.epoch += 1
            # the one read an epoch: score_ is a float at every epoch end
            net._loss_tracker.materialize()
        for l in listeners:
            l.on_fit_end(net)
        return net

    def _drain(self, buf) -> None:
        """Batches through the per-step path (a short tail would need a
        K'-step graph of its own)."""
        for ds, etl_ms in buf:
            t_d = time.perf_counter()
            loss = self.step(ds)
            self._finish(loss, etl_ms, (time.perf_counter() - t_d) * 1e3)

    def _run_fused(self, buf) -> None:
        t_d = time.perf_counter()
        losses = self.fused_step([ds for ds, _ in buf])
        # one dispatch for K steps: its enqueue time shared evenly
        dispatch_ms = (time.perf_counter() - t_d) * 1e3 / len(buf)
        for j, (_, etl_ms) in enumerate(buf):
            # losses[j] stays on the device: indexing does not sync
            self._finish(losses[j], etl_ms, dispatch_ms)

    def _finish(self, loss, etl_ms: float, dispatch_ms: float) -> None:
        net = self.net
        net._loss_tracker.update(loss)
        net.iteration += 1
        self._iter_counter.inc()
        self._etl_hist.observe(etl_ms)
        # host-side enqueue time of the step, not its device time
        self._dispatch_hist.observe(dispatch_ms)
        for l in net.listeners:
            if hasattr(l, "set_etl_time"):
                l.set_etl_time(etl_ms)
            l.iteration_done(net, net.iteration, net.epoch,
                             net._loss_tracker.peek())
