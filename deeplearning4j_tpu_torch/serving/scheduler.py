"""Continuous-batching scheduler + admission control (port of
`deeplearning4j_tpu/serving/scheduler.py`).

A request joins the very next device dispatch as soon as a slot worker
frees: while a worker is busy the queue accumulates arrivals, so batches
grow under load and shrink to singletons when idle, with no wait timer.

Admission is a bounded queue with a policy: `block` (the submitter waits,
bounded by `block_timeout_s`), `shed` (a full queue rejects:
RequestShedError, HTTP 503) or `deadline` (every request carries one;
DeadlineExceededError, HTTP 504). A request that expires while queued is
failed and never dispatched.

Shutdown: every submitted request either completes or fails with an
explicit error. A crashed worker restarts with doubling backoff and
requeues its batch at the front; after `max_worker_restarts`
consecutive crashes the held batch fails with WorkerCrashError.

The workers run the device work, so they get the device explicitly:
each worker thread makes `device` its current CUDA device before it
takes a batch.

Observe hooks (`observe/reqtrace.py`, `observe/flight.py`): a request
carries the TraceContext its HTTP edge minted (or the edge's contextvar
carrier) across admission; at dispatch each traced request closes a
`queue.wait` span and the co-batched traces share one `dispatch` span
each (the fan-in window `run_batch` parents its per-row spans on). Shed,
expired and crashed requests are traced whatever the sampling rate, and
the trace id rides the raised exception (`trace_id`). A worker crash
dumps the flight recorder; a failed dispatch leaves a
`serving_dispatch_error` event in it.

Not ported yet: sequence-parallel batch keys and the chaos fault seam
(ROADMAP A6).
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.observe import reqtrace
from deeplearning4j_tpu_torch.serving.metrics import ServingStats


class AdmissionPolicy:
    BLOCK = "block"
    SHED = "shed"
    DEADLINE = "deadline"

    ALL = (BLOCK, SHED, DEADLINE)


class RequestShedError(RuntimeError):
    """Admission queue full under the shed policy (HTTP 503)."""


class DeadlineExceededError(RuntimeError):
    """Request deadline passed before completion (HTTP 504)."""


class SchedulerClosedError(RuntimeError):
    """Scheduler shut down before (or while) holding this request."""


class WorkerCrashError(RuntimeError):
    """A slot worker crashed more than `max_worker_restarts` times in a
    row while holding this batch; the batch was failed."""


class _WorkerCrashed(BaseException):
    """Internal: carries the in-flight batch out of a crashed worker
    iteration to the supervisor."""

    def __init__(self, batch, cause: BaseException):
        super().__init__(str(cause))
        self.batch = batch
        self.cause = cause


class _Request:
    __slots__ = ("x", "fut", "model", "deadline", "t_enqueue", "ctx",
                 "trace", "t_wall")

    def __init__(self, x, fut, model, deadline, ctx, trace=None):
        self.x = x
        self.fut = fut
        self.model = model
        self.deadline = deadline
        self.t_enqueue = time.monotonic()
        self.ctx = ctx
        # None on the sampled-off path (no span objects); t_wall anchors
        # the queue.wait span
        self.trace = trace
        self.t_wall = time.time() if trace is not None else 0.0


class ContinuousBatchingScheduler:
    """Slot workers pulling per-model FIFO queues; one registry behind.

    `registry` needs `acquire(name) -> entry` / `release(entry)` with
    `entry.run_batch(xs)`. `slots` is the number of concurrent dispatch
    lanes. `device` is the CUDA device the workers run on (None: the
    current device when CUDA is present; ignored on a CPU-only host).
    """

    def __init__(self, registry, stats: Optional[ServingStats] = None, *,
                 max_batch_size: int = 64, queue_capacity: int = 256,
                 policy: str = AdmissionPolicy.BLOCK,
                 default_deadline_ms: Optional[float] = None,
                 slots: int = 1, block_timeout_s: float = 30.0,
                 max_worker_restarts: int = 3,
                 worker_restart_backoff_s: float = 0.05, device=None):
        if policy not in AdmissionPolicy.ALL:
            raise ValueError(
                f"admission policy must be one of {AdmissionPolicy.ALL}, "
                f"got {policy!r}")
        if policy == AdmissionPolicy.DEADLINE and not default_deadline_ms:
            raise ValueError(
                "deadline admission policy requires default_deadline_ms")
        self.registry = registry
        self.stats = stats if stats is not None else ServingStats()
        self.max_batch = max_batch_size
        self.capacity = queue_capacity
        self.policy = policy
        self.default_deadline = (default_deadline_ms / 1e3
                                 if default_deadline_ms else None)
        self.block_timeout = block_timeout_s
        self.max_worker_restarts = max(0, int(max_worker_restarts))
        self.worker_restart_backoff = float(worker_restart_backoff_s)
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = None if device is None else torch.device(device)
        self._cv = threading.Condition()
        self._queues: Dict[str, deque] = {}
        self._depth = 0
        self._inflight = 0
        self._closed = False
        self._streaks: Dict[str, int] = {}
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"serving-slot-{i}")
            for i in range(max(1, slots))]
        for w in self._workers:
            w.start()

    # ---------------------------------------------------------- public
    def queue_depth(self) -> int:
        with self._cv:
            return self._depth

    def restart_streak(self) -> int:
        """Worst current consecutive-crash streak across slot workers."""
        with self._cv:
            return max(self._streaks.values(), default=0)

    def _note_streak(self, n: int) -> None:
        with self._cv:
            self._streaks[threading.current_thread().name] = n
            worst = max(self._streaks.values())
        self.stats.worker_streak(worst)

    def submit(self, model: str, x,
               deadline_ms: Optional[float] = None, *,
               trace=None) -> Future:
        """Admit one request; returns a Future resolving to the output
        rows. Raises RequestShedError / DeadlineExceededError /
        SchedulerClosedError per the admission contract.

        `trace` carries the request's TraceContext across admission
        (decode sessions resubmit from worker threads, where the edge's
        contextvar is not in scope); when omitted,
        `reqtrace.current_trace()` is picked up. Shed and expired
        requests are traced whatever the sampling rate, and the trace
        id is stamped on the raised exception."""
        x = np.asarray(x)
        now = time.monotonic()
        dl_s = (deadline_ms / 1e3 if deadline_ms is not None
                else self.default_deadline)
        deadline = now + dl_s if dl_s is not None else None
        if trace is None:
            trace = reqtrace.current_trace()
        with self._cv:
            if self._closed:
                raise SchedulerClosedError("scheduler is shut down")
            if self._depth >= self.capacity:
                if self.policy == AdmissionPolicy.SHED:
                    self.stats.shed(model)
                    err = RequestShedError(
                        f"admission queue full "
                        f"({self._depth}/{self.capacity})")
                    err.trace_id = reqtrace.error_trace(
                        "request.shed", ctx=trace, model=model,
                        queue_depth=self._depth, capacity=self.capacity)
                    raise err
                limit = now + self.block_timeout
                if deadline is not None:
                    limit = min(limit, deadline)
                while self._depth >= self.capacity and not self._closed:
                    remaining = limit - time.monotonic()
                    if remaining <= 0:
                        if (deadline is not None
                                and time.monotonic() >= deadline):
                            self.stats.expired(model)
                            err = DeadlineExceededError(
                                "deadline passed waiting for admission")
                            err.trace_id = reqtrace.error_trace(
                                "request.expired", ctx=trace, model=model,
                                where="admission")
                            raise err
                        self.stats.shed(model)
                        err = RequestShedError(
                            f"admission blocked > {self.block_timeout}s")
                        err.trace_id = reqtrace.error_trace(
                            "request.shed", ctx=trace, model=model,
                            queue_depth=self._depth,
                            blocked_s=round(self.block_timeout, 3))
                        raise err
                    self._cv.wait(remaining)
                if self._closed:
                    raise SchedulerClosedError("scheduler is shut down")
            fut: Future = Future()
            req = _Request(x, fut, model, deadline,
                           contextvars.copy_context(), trace)
            self._queues.setdefault(model, deque()).append(req)
            self._depth += 1
            self.stats.admitted(model)
            self._cv.notify_all()
        return fut

    def output(self, model: str, x,
               deadline_ms: Optional[float] = None) -> np.ndarray:
        """Blocking submit."""
        return self.submit(model, x, deadline_ms).result()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty and no batch is in flight."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._depth == 0 and self._inflight == 0, timeout)

    def shutdown(self):
        """Fail everything queued with SchedulerClosedError, let the
        in-flight batch finish, stop the slot workers."""
        with self._cv:
            self._closed = True
            leftovers = [r for q in self._queues.values() for r in q]
            self._queues.clear()
            self._depth = 0
            self._cv.notify_all()
        for r in leftovers:
            if not r.fut.done():
                r.fut.set_exception(SchedulerClosedError(
                    "scheduler shut down before serving this request"))
                self.stats.completed(r.model, 0.0, ok=False)
        for w in self._workers:
            w.join(timeout=10)

    # ---------------------------------------------------------- worker
    def _take_batch(self):
        """Pop the next single-model batch, FIFO-fair across models by
        oldest head request. Called under self._cv."""
        name = min((n for n, q in self._queues.items() if q),
                   key=lambda n: self._queues[n][0].t_enqueue)
        q = self._queues[name]
        batch = [q.popleft()]
        rows = batch[0].x.shape[0]
        while q and rows < self.max_batch:
            nxt = q.popleft()
            batch.append(nxt)
            rows += nxt.x.shape[0]
        self._depth -= len(batch)
        return batch

    def _worker(self):
        """Supervisor: a crash requeues the held batch at the front and
        restarts the loop after a doubling backoff; a crash loop is
        bounded by `max_worker_restarts`."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        streak = [0]
        backoff = self.worker_restart_backoff
        while True:
            try:
                self._worker_loop(streak)
                return
            except _WorkerCrashed as wc:
                batch, cause = wc.batch, wc.cause
            streak[0] += 1
            self._note_streak(streak[0])
            self.stats.worker_restarted()
            # a dead worker is a silent outage: black box first
            from deeplearning4j_tpu_torch.observe.flight import get_flight

            get_flight().dump("scheduler_worker_crash", exc=cause)
            if streak[0] > self.max_worker_restarts:
                for r in batch:
                    exc = WorkerCrashError(
                        f"worker crashed {streak[0]} consecutive "
                        f"times holding this batch: {cause!r}")
                    exc.trace_id = reqtrace.error_trace(
                        "request.worker_crash", ctx=r.trace,
                        model=r.model, crashes=streak[0],
                        cause=type(cause).__name__)
                    if not r.fut.done():
                        r.fut.set_exception(exc)
                    self.stats.completed(r.model, 0.0, ok=False)
                streak[0] = 0
                self._note_streak(0)
                backoff = self.worker_restart_backoff
                continue
            if batch:
                self._requeue(batch)
            time.sleep(backoff)
            backoff = min(backoff * 2.0, 1.0)

    def _requeue(self, batch) -> None:
        """Put a crashed worker's batch back at the head of its queue."""
        with self._cv:
            if self._closed:
                closed = list(batch)
            else:
                closed = []
                q = self._queues.setdefault(batch[0].model, deque())
                for r in reversed(batch):
                    q.appendleft(r)
                self._depth += len(batch)
            self._cv.notify_all()
        for r in closed:
            if not r.fut.done():
                r.fut.set_exception(SchedulerClosedError(
                    "scheduler shut down while recovering this request"))
            self.stats.completed(r.model, 0.0, ok=False)

    def _worker_loop(self, streak):
        while True:
            try:
                with self._cv:
                    while not self._closed and self._depth == 0:
                        self._cv.wait()
                    if self._closed:
                        return
                    batch = self._take_batch()
                    self._inflight += 1
                    self._cv.notify_all()
            except BaseException as e:
                raise _WorkerCrashed([], e) from e
            try:
                self._dispatch(batch)
                if streak[0]:
                    streak[0] = 0
                    self._note_streak(0)
            except _WorkerCrashed:
                raise
            except BaseException as e:
                raise _WorkerCrashed(batch, e) from e
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _dispatch(self, batch):
        now = time.monotonic()
        live = []
        for r in batch:
            if r.deadline is not None and now >= r.deadline:
                self.stats.expired(r.model)
                exc = DeadlineExceededError(
                    f"deadline exceeded after "
                    f"{now - r.t_enqueue:.3f}s in queue")
                exc.trace_id = reqtrace.error_trace(
                    "request.expired", ctx=r.trace, model=r.model,
                    where="queue", queue_s=round(now - r.t_enqueue, 3))
                if not r.fut.done():
                    r.fut.set_exception(exc)
                continue
            live.append(r)
        if not live:
            return
        model = live[0].model
        for r in live:
            self.stats.queue_waited(r.model, (now - r.t_enqueue) * 1e3)
        try:
            entry = self.registry.acquire(model)
        except BaseException as e:
            for r in live:
                if not r.fut.done():
                    r.fut.set_exception(e)
                self.stats.completed(r.model, 0.0, ok=False)
            return
        dt = None
        try:
            xs = (live[0].x if len(live) == 1
                  else np.concatenate([r.x for r in live], axis=0))
            self.stats.batch_dispatched(xs.shape[0], self.max_batch)
            traced = [r for r in live if r.trace is not None]
            if traced:
                # fan-in: close each trace's admission wait, then open ONE
                # dispatch window joining the co-batched traces, pinned
                # to this worker thread (run_batch parents on it)
                t_w = time.time()
                for r in traced:
                    reqtrace.record_span(
                        r.trace.trace_id, "queue.wait",
                        parent_id=r.trace.span_id, ts=r.t_wall,
                        dur_ms=(t_w - r.t_wall) * 1e3, model=model)
                dt = reqtrace.begin_dispatch([r.trace for r in traced])
            ys = live[0].ctx.run(entry.run_batch, xs)
            done = time.monotonic()
            ver = getattr(entry, "version", None)
            reqtrace.end_dispatch(dt, model=model, rows=int(xs.shape[0]),
                                  requests=len(live), version=ver)
            dt = None
            off = 0
            for r in live:
                n = r.x.shape[0]
                if not r.fut.done():
                    r.fut.version = ver
                    r.fut.set_result(ys[off:off + n])
                self.stats.completed(
                    r.model, done - r.t_enqueue,
                    trace_id=r.trace.trace_id if r.trace else None)
                off += n
        except BaseException as e:
            reqtrace.end_dispatch(dt, model=model, requests=len(live),
                                  error=type(e).__name__)
            for r in live:
                if not r.fut.done():
                    r.fut.set_exception(e)
                self.stats.completed(r.model, 0.0, ok=False)
            # per-batch faults reach the futures and stats; a ring event
            # keeps them visible in a later crash dump too
            from deeplearning4j_tpu_torch.observe.flight import get_flight

            get_flight().record("serving_dispatch_error", model=model,
                                error=type(e).__name__,
                                requests=len(live))
        finally:
            self.registry.release(entry)
