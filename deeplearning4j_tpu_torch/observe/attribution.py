"""Step-time attribution: etl / dispatch / host / device segments (a
copy of `deeplearning4j_tpu/observe/attribution.py`, stdlib only).

`train_step_ms` says a step took 12 ms; it cannot say whether that was
the input pipeline, Python overhead, or the device actually computing —
and under async dispatch the naive fix (time the step call) measures
only the ENQUEUE, because the device runs behind the host on purpose.
Reading the device clock directly would mean forcing a sync, which is
exactly what the deferred-dispatch pipeline forbids (PyGraph's rule for
capture instrumentation, arXiv:2503.19779: near-zero steady-state
overhead or it lies to you).

But the pipeline already owns one guaranteed block point: the
LossTracker materialization at each epoch boundary (the ≤1-sync/epoch
contract; in the port, `float()` of the loss tensor, which waits for
every kernel queued before it — at K > 1 that includes the replays of
the K-step CUDA graphs). Attribution measures around it:

- per iteration (host clock, no syncs): `etl_ms` (batch wait),
  `dispatch_ms` (the step call — the enqueue, or a graph replay's launch), `host_ms` (listener
  fan-out + after_step);
- per window (materialize to materialize): `block_ms`, the time
  `float(loss)` actually waited for the device to drain the queue —
  measured at the boundary the tracker already owns.

Device-execute time for the window is then inferred:

    device_total = min(block + dispatch + host, wall - etl)

The device provably ran for `block` ms beyond everything the host did,
plus whatever it overlapped with host work — credited up to the
dispatch+host budget, capped by the wall time outside the input
pipeline. Device-bound runs converge to `wall - etl` (the queue never
drains early); host-bound runs are bounded by dispatch+host (an upper
bound: the device may have idled). Per-step device time is the window
total divided by its step count — published as the `device` segment of
`train_step_attribution_ms`, the `train_device_step_ms` gauge, a
`fit.attribution_window` span, and `last_device_step_ms()` which
PerformanceListener uses as the measured MFU denominator.

Env: DL4J_TPU_ATTRIBUTION=0 disables (the executor then skips all
timing aggregation).

Stdlib-only; one instance per `TrainingExecutor.run`, so instrument
handles bind to the registry active at fit start.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from deeplearning4j_tpu_torch.observe.registry import get_registry
from deeplearning4j_tpu_torch.observe.trace import emit_manual_span

SEGMENTS = ("etl", "dispatch", "host", "device")


def attribution_enabled() -> bool:
    return os.environ.get("DL4J_TPU_ATTRIBUTION", "1") != "0"


class StepAttribution:
    """Per-fit accumulator of step-time segments.

    `record_iteration` is the hot path: three histogram observes + one
    short lock. `on_device_block` runs once per materialization (≤1 per
    epoch steady-state) and closes the inference window.
    """

    def __init__(self, registry=None):
        reg = registry or get_registry()
        self._hist = {seg: reg.histogram("train_step_attribution_ms",
                                         segment=seg)
                      for seg in SEGMENTS}
        self._g_device = reg.gauge("train_device_step_ms")
        self._lock = threading.Lock()
        self.windows = 0
        self._last_device_ms: Optional[float] = None
        self._w_t0 = time.perf_counter()
        self._w_ts = time.time()
        self._steps = 0
        self._etl = self._dispatch = self._host = 0.0

    def _reset_window_locked(self, t0: float, ts: float) -> None:
        # the _locked suffix is the contract: every caller holds self._lock
        self._w_t0 = t0
        self._w_ts = ts
        self._steps = 0
        self._etl = self._dispatch = self._host = 0.0

    # ------------------------------------------------------------ hot path
    def record_iteration(self, etl_ms: float, dispatch_ms: float,
                         host_ms: float) -> None:
        with self._lock:
            self._steps += 1
            self._etl += etl_ms
            self._dispatch += dispatch_ms
            self._host += host_ms
        self._hist["etl"].observe(etl_ms)
        self._hist["dispatch"].observe(dispatch_ms)
        self._hist["host"].observe(host_ms)

    # -------------------------------------------------- the block boundary
    def on_device_block(self, block_ms: float) -> None:
        """LossTracker callback: a device loss just materialized after
        blocking for `block_ms`. Closes the attribution window."""
        now = time.perf_counter()
        ts = time.time()
        with self._lock:
            steps = self._steps
            wall = (now - self._w_t0) * 1e3
            etl, disp, host = self._etl, self._dispatch, self._host
            w_ts = self._w_ts
            self._reset_window_locked(now, ts)
        if steps == 0:
            return   # a re-read between windows (score_ accessed twice)
        device_total = min(block_ms + disp + host,
                           max(wall - etl, block_ms))
        per_step = device_total / steps
        with self._lock:
            self.windows += 1
            self._last_device_ms = per_step
        self._hist["device"].observe(per_step)
        self._g_device.set(per_step)
        emit_manual_span("fit.attribution_window", w_ts, ts,
                         steps=steps,
                         etl_ms=round(etl, 3),
                         dispatch_ms=round(disp, 3),
                         host_ms=round(host, 3),
                         block_ms=round(block_ms, 3),
                         device_ms_per_step=round(per_step, 4))

    # ---------------------------------------------------------- reporting
    def last_device_step_ms(self) -> Optional[float]:
        """Most recent window's inferred device time per step (the
        measured MFU denominator); None until a window has closed."""
        with self._lock:
            return self._last_device_ms

    def snapshot(self) -> dict:
        with self._lock:
            return {"windows": self.windows,
                    "last_device_step_ms": self._last_device_ms,
                    "open_window_steps": self._steps}
