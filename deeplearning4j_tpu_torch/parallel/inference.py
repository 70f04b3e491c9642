"""ParallelInference — the bucketed batch runner behind the serving
registry (port of `deeplearning4j_tpu/parallel/inference.py`), on one
card.

Reference parity: `parallelism/ParallelInference.java:33-74`, modes
INPLACE and BATCHED. A batch is padded to the smallest bucket that holds
it (repeating its first row) and run as one `net.output` call; a batch
past the largest bucket is run in chunks of it and reassembled in order.
Buckets keep the shapes a model sees few and fixed, as the JAX runner's
per-bucket jit cache does; a bucket's first forward is reported to the
recompile watchdog under the runner's `owner_tag` (the counterpart of
the JAX runner's per-bucket compile), which the registry's deploy gate
reads after a warm-up. In BATCHED mode a collector thread coalesces
concurrent `output()` requests up to `max_batch_size` rows or
`max_wait_ms`, runs them as one batch and hands each caller its rows.

The JAX runner shards the batch over a mesh's data axis; meshes are not
ported (ROADMAP A6), so `mesh=` other than None raises.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional

import numpy as np
import torch


class InferenceMode:
    """Reference: `ParallelInference.InferenceMode` (`:53`)."""

    INPLACE = "inplace"
    BATCHED = "batched"


class ParallelInference:
    def __init__(self, net, *, mesh=None, mode: str = InferenceMode.BATCHED,
                 max_batch_size: int = 64, max_wait_ms: float = 5.0,
                 batch_buckets: Optional[List[int]] = None):
        if mesh is not None:
            raise NotImplementedError(
                "ParallelInference over a device mesh is not ported yet "
                "(ROADMAP.md A6); the port runs on one card")
        if mode not in (InferenceMode.INPLACE, InferenceMode.BATCHED):
            raise ValueError(f"unknown inference mode {mode!r}")
        self.net = net
        self.mode = mode
        self.max_batch = max_batch_size
        self.max_wait = max_wait_ms / 1e3
        self.buckets = sorted(set(batch_buckets
                                  or [1, 8, 32, max_batch_size]))
        from deeplearning4j_tpu_torch.observe.watchdog import owner_tag

        self.owner_tag = owner_tag(self)
        self._seen_buckets: set = set()
        self._seen_lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # every future enqueued on the collector is counted until it
        # completes, by its done callback (drain())
        self._pending = 0
        self._pending_cv = threading.Condition()
        from deeplearning4j_tpu_torch.observe import get_registry

        reg = get_registry()
        self._m_dispatches = reg.counter("inference_dispatches_total")
        self._m_rows = reg.histogram("inference_batch_rows")
        self._worker: Optional[threading.Thread] = None
        if mode == InferenceMode.BATCHED:
            self._worker = threading.Thread(target=self._collector,
                                            daemon=True,
                                            name="parallel-inference")
            self._worker.start()

    # ---------------------------------------------------------- public
    def output(self, x) -> np.ndarray:
        """Blocking single request (thread-safe)."""
        x = np.asarray(x)
        if self.mode == InferenceMode.INPLACE:
            return self._run(x)
        if self._stop.is_set():
            raise RuntimeError("ParallelInference is shut down")
        fut: Future = Future()
        with self._pending_cv:
            self._pending += 1
        fut.add_done_callback(self._dec_pending)
        self._queue.put((x, fut))
        # a shutdown between the check above and the put: the collector's
        # exit drain may have run already, so fail the request here
        if self._stop.is_set() and not fut.done():
            try:
                fut.set_exception(RuntimeError(
                    "ParallelInference is shut down"))
            except InvalidStateError:   # the collector completed it
                pass
        return fut.result()

    def run_batch(self, x) -> np.ndarray:
        """Scheduler SPI: one already-formed batch, synchronously (pad to
        the bucket, one `output()` a bucket), bypassing the collector."""
        return self._run(np.asarray(x))

    def warmup(self, feat_shape, dtype=np.float32) -> int:
        """Run the forward once at every batch bucket (the registry's
        deploy-time canary). Returns the number of buckets warmed."""
        for b in self.buckets:
            self._run(np.zeros((b, *tuple(feat_shape)), dtype))
        return len(self.buckets)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued request has completed; False on
        timeout. Does not stop the collector."""
        with self._pending_cv:
            return self._pending_cv.wait_for(
                lambda: self._pending == 0, timeout)

    def shutdown(self):
        self._stop.set()
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=10)

    # --------------------------------------------------------- internal
    def _dec_pending(self, _fut):
        with self._pending_cv:
            self._pending -= 1
            self._pending_cv.notify_all()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @torch.no_grad()
    def _run(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        cap = self.buckets[-1]
        if n > cap:
            return np.concatenate(
                [self._run(x[i:i + cap]) for i in range(0, n, cap)], axis=0)
        self._m_dispatches.inc()
        self._m_rows.observe(n)
        b = self._bucket(n)
        key = (b, *x.shape[1:], str(x.dtype))
        with self._seen_lock:
            new = key not in self._seen_buckets
            self._seen_buckets.add(key)
        if new:
            from deeplearning4j_tpu_torch.observe.watchdog import (
                get_watchdog,
            )

            get_watchdog().record_compile(self.owner_tag,
                                          type(self).__name__, key)
        if n < b:
            x = np.concatenate([x, np.repeat(x[:1], b - n, axis=0)], axis=0)
        y = self.net.output(x)
        return y[:n].float().cpu().numpy()

    def _collector(self):
        """Coalesce concurrent requests into one batch (reference:
        BatchedInferenceObservable)."""
        net_dev = getattr(self.net, "device", None)
        if net_dev is not None and torch.device(net_dev).type == "cuda":
            torch.cuda.set_device(net_dev)
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                break
            batch = [item]
            total = item[0].shape[0]
            t0 = time.monotonic()
            while total < self.max_batch:
                remaining = self.max_wait - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                batch.append(nxt)
                total += nxt[0].shape[0]
            try:
                ys = self._run(np.concatenate([b[0] for b in batch], axis=0))
            except Exception as e:
                for _x, fut in batch:
                    _settle(fut, exception=e)
                continue
            off = 0
            for x, fut in batch:
                _settle(fut, result=ys[off:off + x.shape[0]])
                off += x.shape[0]
        # requests still queued at shutdown fail loudly: a dropped future
        # would block its caller forever
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _settle(item[1], exception=RuntimeError(
                    "ParallelInference shut down before serving this "
                    "request"))


def _settle(fut: Future, result=None, exception=None) -> None:
    """Complete one request's future unless it is done already. `output()`
    may fail a future from its own thread at any moment (a shutdown), so
    the check and the call can interleave with it: the InvalidStateError
    that follows is that request's alone and must not reach the others
    of its batch (C14)."""
    if fut.done():
        return
    try:
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass
