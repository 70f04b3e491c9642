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

Recovery seams (`optim/recovery.RecoveryPlan` plugs into them, as in
JAX): `before_batch(bi, ds)` returns the batch, `SKIP` (a resume
replaying batches already trained) or `STOP` (a clean stop at a batch
boundary); `after_dispatch(bi)` fires once a dispatch (a step, or a
K-step window) where params, moments and the generator are a
consistent snapshot (the checkpoint seam); `epoch_start()` /
`epoch_end()` bracket each epoch. A resume whose position falls inside
a window skips to it and fills the window from there; a short tail
drains step by step, so the resumed steps equal the uninterrupted ones.
`mesh_ctx` scopes a `parallel.mesh.MeshContext` over the run.

Observe hooks: the run is a `fit` span with a `fit.epoch` span an
epoch; with request tracing sampled (`DL4J_TPU_TRACE_SAMPLE`) each
epoch is a `train.epoch` trace whose `train.dispatch` spans are its
step windows (host enqueue time, never a device wait). `StepAttribution`
splits each step into etl / dispatch / host time and infers the device
time at the epoch's one loss read (the tracker's `on_block`); the net
keeps it as `_attribution` for `PerformanceListener`. An exception that
escapes the loop dumps the flight recorder. `maybe_start_monitor()`
starts the device-memory poller when `DL4J_TPU_DEVICEMON` asks.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

import torch

from deeplearning4j_tpu_torch.observe import get_registry, reqtrace, span
from deeplearning4j_tpu_torch.observe.attribution import (
    StepAttribution, attribution_enabled,
)
from deeplearning4j_tpu_torch.observe.devicemon import maybe_start_monitor
from deeplearning4j_tpu_torch.observe.flight import get_flight

__all__ = ["LossTracker", "TrainingExecutor", "batch_signature", "SKIP",
           "STOP"]

# before_batch sentinels: skip this batch (resume replay) / stop cleanly
SKIP = object()
STOP = object()


class LossTracker:
    """Deferred-sync score holder. ``host_syncs`` counts the reads that
    waited for the device. ``on_block(block_ms)``, when set, is called
    after a loss tensor is read, with how long the read waited: the
    block point `StepAttribution` infers device time from."""

    def __init__(self, sync_every: int = 0):
        self.sync_every = int(sync_every)
        self._raw: Any = None
        self._cached: Optional[float] = None
        self._since_sync = 0
        self.host_syncs = 0
        self.updates = 0
        self.on_block: Optional[Callable[[float], None]] = None

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
            blocked = isinstance(self._raw, torch.Tensor)
            if blocked and self._raw.is_cuda:
                self.host_syncs += 1
            t0 = time.perf_counter()
            self._cached = float(self._raw)
            if blocked and self.on_block is not None:
                self.on_block((time.perf_counter() - t0) * 1e3)
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
                 steps_per_dispatch: int = 1,
                 before_batch: Optional[Callable] = None,
                 after_step: Optional[Callable] = None,
                 after_dispatch: Optional[Callable] = None,
                 epoch_start: Optional[Callable] = None,
                 epoch_end: Optional[Callable] = None,
                 mesh_ctx=None):
        self.net = net
        self.mesh_ctx = mesh_ctx
        self.step = step
        self.fused_step = fused_step
        self.can_fuse = can_fuse or (lambda ds: False)
        self.k = max(1, int(steps_per_dispatch or 1))
        self.before_batch = before_batch
        self.after_step = after_step
        self.after_dispatch = after_dispatch
        self.epoch_start = epoch_start
        self.epoch_end = epoch_end
        self.stopped = False
        self._attr: Optional[StepAttribution] = None
        # the epoch's request trace; None when sampling is off, so the
        # hot loop pays one attribute read a dispatch window
        self._rt = None
        reg = get_registry()
        self._iter_counter = reg.counter("train_iterations")
        self._etl_hist = reg.histogram("train_etl_ms")
        self._dispatch_hist = reg.histogram("train_dispatch_ms")

    def run(self, iterable, epochs: int, *, start_epoch: int = 0):
        if self.mesh_ctx is not None:
            from deeplearning4j_tpu_torch.parallel.mesh import (
                use_mesh_context,
            )
            with use_mesh_context(self.mesh_ctx):
                return self._run(iterable, epochs, start_epoch)
        return self._run(iterable, epochs, start_epoch)

    def _run(self, iterable, epochs: int, start_epoch: int):
        net = self.net
        listeners = net.listeners
        # the black box and the device poller, wired before the first
        # fit span so a crash dump carries this run from its start
        flight = get_flight()
        maybe_start_monitor()
        tracker = net._loss_tracker
        attr = None
        if attribution_enabled():
            attr = StepAttribution(get_registry())
            # PerformanceListener reads the device step time here
            net._attribution = attr
            tracker.on_block = attr.on_device_block
        self._attr = attr
        try:
            with span("fit", epochs=epochs, start_epoch=start_epoch,
                      steps_per_dispatch=self.k):
                for l in listeners:
                    l.on_fit_start(net)
                self.stopped = False
                for _ in range(start_epoch, epochs):
                    ep = net.epoch
                    self._rt = reqtrace.new_trace("train.epoch")
                    with span("fit.epoch", epoch=ep):
                        self._epoch(iterable)
                    if self.stopped:
                        self._finish_epoch_trace(ep, stopped=True)
                        break
                    self._finish_epoch_trace(ep)
                for l in listeners:
                    l.on_fit_end(net)
        except BaseException as e:
            # close the epoch trace first, so the dump's trace block
            # carries the crashed epoch's dispatch windows
            self._finish_epoch_trace(net.epoch, error=type(e).__name__)
            flight.dump("training_exception", exc=e)
            raise
        finally:
            tracker.on_block = None
        return net

    def _epoch(self, iterable) -> None:
        net = self.net
        if self.epoch_start is not None:
            self.epoch_start()
        for l in net.listeners:
            l.on_epoch_start(net, net.epoch)
        buf: List = []
        etl_start = time.perf_counter()
        for bi, ds in enumerate(iter(iterable)):
            etl_ms = (time.perf_counter() - etl_start) * 1e3
            if self.before_batch is not None:
                ds = self.before_batch(bi, ds)
                if ds is SKIP:
                    etl_start = time.perf_counter()
                    continue
                if ds is STOP:
                    self.stopped = True
                    break
            fusible = (self.k > 1 and self.fused_step is not None
                       and self.can_fuse(ds))
            if fusible and buf and \
                    batch_signature(buf[0][1]) != batch_signature(ds):
                self._drain(buf)
                buf = []
            if fusible:
                buf.append((bi, ds, etl_ms))
                if len(buf) == self.k:
                    self._run_fused(buf)
                    buf = []
            else:
                self._drain(buf)
                buf = []
                self._drain([(bi, ds, etl_ms)])
            etl_start = time.perf_counter()
        self._drain(buf)
        if self.stopped:
            return
        for l in net.listeners:
            l.on_epoch_end(net, net.epoch)
        net.epoch += 1
        if self.epoch_end is not None:
            self.epoch_end()
        # the one read an epoch: score_ is a float at every epoch end,
        # and the block point attribution infers device time from
        net._loss_tracker.materialize()

    def _finish_epoch_trace(self, epoch: int, **attrs) -> None:
        """Close the epoch's trace root (None-safe; resets _rt)."""
        rt, self._rt = self._rt, None
        reqtrace.finish_root(rt, epoch=epoch, iteration=self.net.iteration,
                             steps_per_dispatch=self.k, **attrs)

    def _trace_window(self, bi_lo: int, bi_hi: int, dur_ms: float,
                      fused: bool = False) -> None:
        """One `train.dispatch` span a step window, keyed (epoch, batch
        range); `dur_ms` is the host's enqueue time, never a device
        wait."""
        rt = self._rt
        if rt is None:
            return
        ep = self.net.epoch
        attrs = dict(dur_ms=dur_ms, epoch=ep, window=f"{ep}:{bi_lo}-{bi_hi}",
                     steps=bi_hi - bi_lo + 1, fused=fused)
        comm = self._comm_totals()
        if comm is not None:
            attrs["comm_ops"] = comm["ops"]
            attrs["comm_bytes"] = comm["wire_bytes"]
        reqtrace.record_span(
            rt.trace_id, "train.dispatch", parent_id=rt.span_id, **attrs)

    def _comm_totals(self) -> Optional[dict]:
        """The collective totals the watchdog holds for the owner whose
        steps run collectives (a `ParallelWrapper` sets the net's
        `_comm_owner` to its tag for a fit), or None."""
        tag = getattr(self.net, "_comm_owner", None)
        if tag is None:
            return None
        from deeplearning4j_tpu_torch.observe.watchdog import get_watchdog
        return get_watchdog().owner_comm_totals(tag)

    def _drain(self, buf) -> None:
        """Batches through the per-step path (a short tail would need a
        K'-step graph of its own)."""
        for bi, ds, etl_ms in buf:
            t_d = time.perf_counter()
            loss = self.step(ds)
            dispatch_ms = (time.perf_counter() - t_d) * 1e3
            self._trace_window(bi, bi, dispatch_ms)
            self._finish(bi, loss, etl_ms, dispatch_ms)
            if self.after_dispatch is not None:
                self.after_dispatch(bi)

    def _run_fused(self, buf) -> None:
        t_d = time.perf_counter()
        losses = self.fused_step([ds for _, ds, _ in buf])
        # one dispatch for K steps: its enqueue time shared evenly
        dispatch_ms = (time.perf_counter() - t_d) * 1e3 / len(buf)
        self._trace_window(buf[0][0], buf[-1][0], dispatch_ms * len(buf),
                           fused=True)
        for j, (bi, _, etl_ms) in enumerate(buf):
            # losses[j] stays on the device: indexing does not sync
            self._finish(bi, losses[j], etl_ms, dispatch_ms)
        if self.after_dispatch is not None:
            # once a window: params reflect all K steps, a consistent
            # (step, generator, cursor) snapshot
            self.after_dispatch(buf[-1][0])

    def _finish(self, bi: int, loss, etl_ms: float,
                dispatch_ms: float) -> None:
        net = self.net
        net._loss_tracker.update(loss)
        net.iteration += 1
        self._iter_counter.inc()
        self._etl_hist.observe(etl_ms)
        # host-side enqueue time of the step, not its device time
        self._dispatch_hist.observe(dispatch_ms)
        t_h = time.perf_counter()
        for l in net.listeners:
            if hasattr(l, "set_etl_time"):
                l.set_etl_time(etl_ms)
            l.iteration_done(net, net.iteration, net.epoch,
                             net._loss_tracker.peek())
        if self.after_step is not None:
            self.after_step(bi)
        if self._attr is not None:
            self._attr.record_iteration(
                etl_ms, dispatch_ms, (time.perf_counter() - t_h) * 1e3)
