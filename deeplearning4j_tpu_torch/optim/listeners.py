"""Training listeners — port of the core of
`deeplearning4j_tpu/optim/listeners.py`.

Listeners run on the host after each step. The `score` handed to
``iteration_done`` is the loss as the step returned it: a 0-dim tensor
on the device. A listener that calls ``float(score)`` pays a host sync
for it, stalling the step pipeline; one that does not costs nothing.
Prefer a cadence of 10 or more in a hot loop.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    """onEpochStart / onEpochEnd / iterationDone / fit start and end."""

    def iteration_done(self, model, iteration: int, epoch: int,
                       score) -> None:
        pass

    def on_epoch_start(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass

    def on_fit_start(self, model) -> None:
        pass

    def on_fit_end(self, model) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Log the score every N iterations (a host sync each time)."""

    def __init__(self, print_iterations: int = 10,
                 out: Optional[Callable] = None):
        self.n = max(1, print_iterations)
        self._out = out or (lambda msg: logger.info(msg))

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.n == 0:
            self._out(f"Score at iteration {iteration} is "
                      f"{float(score):.6f}")


class CollectScoresIterationListener(TrainingListener):
    """Accumulate (iteration, score) pairs (a host sync each time)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class PerformanceListener(TrainingListener):
    """Throughput on the host clock: samples, tokens (samples times the
    time axis of a sequence batch) and batches a second, ms a step and
    ETL time, every `frequency` iterations. Reads no score, so it adds no
    sync: in a pipelined loop its rate is the host's enqueue rate until
    the queue fills, then the device's."""

    def __init__(self, frequency: int = 10,
                 report: Optional[Callable] = None):
        self.frequency = max(1, frequency)
        self._report = report or (lambda msg: logger.info(msg))
        self._last_time = None
        self._last_iter = 0
        self.last_samples_per_sec = 0.0
        self.last_tokens_per_sec = 0.0
        self.last_batches_per_sec = 0.0
        self.last_step_ms: Optional[float] = None
        self.last_etl_ms = 0.0
        from deeplearning4j_tpu_torch.observe import get_registry

        reg = get_registry()
        self._g_sps = reg.gauge("train_samples_per_sec")
        self._g_tps = reg.gauge("train_tokens_per_sec")
        self._g_step_ms = reg.gauge("train_step_ms")

    def set_etl_time(self, ms: float) -> None:
        self.last_etl_ms = ms

    def iteration_done(self, model, iteration, epoch, score):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time, self._last_iter = now, iteration
            return
        if iteration - self._last_iter < self.frequency:
            return
        dt = now - self._last_time
        n = iteration - self._last_iter
        bs = getattr(model, "last_batch_size", None) or 0
        seq = getattr(model, "last_seq_len", None) or 1
        self.last_batches_per_sec = n / dt
        self.last_samples_per_sec = n * bs / dt
        self.last_tokens_per_sec = n * bs * seq / dt
        self.last_step_ms = dt / n * 1e3
        self._g_sps.set(self.last_samples_per_sec)
        self._g_tps.set(self.last_tokens_per_sec)
        self._g_step_ms.set(self.last_step_ms)
        self._report(f"iteration {iteration}: "
                     f"{self.last_samples_per_sec:.1f} samples/sec, "
                     f"{self.last_tokens_per_sec:.1f} tokens/sec, "
                     f"{self.last_step_ms:.1f} ms/step, "
                     f"ETL {self.last_etl_ms:.1f} ms")
        self._last_time, self._last_iter = now, iteration


class TimeIterationListener(TrainingListener):
    """ETA logging every `frequency` iterations on the host clock (reads
    no score, so no sync: in a pipelined loop its rate is the host's
    enqueue rate until the queue fills). Reference:
    TimeIterationListener."""

    def __init__(self, total_iterations: int, frequency: int = 100):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self._start = None
        self._start_iter = 0

    def on_fit_start(self, model):
        self._start = time.perf_counter()
        self._start_iter = getattr(model, "iteration", 0)

    def iteration_done(self, model, iteration, epoch, score):
        if self._start is None:
            # attached mid-fit: anchor the clock one step back so this
            # report still has a rate
            self._start = time.perf_counter()
            self._start_iter = iteration - 1
        if iteration % self.frequency == 0 and iteration > 0:
            done = iteration - self._start_iter
            if done <= 0:
                return
            rate = (time.perf_counter() - self._start) / done
            if self.total and self.total > 0:
                remaining = rate * max(self.total - iteration, 0)
                logger.info(f"iteration {iteration}/{self.total}, "
                            f"ETA {remaining:.0f}s")
            else:
                logger.info(f"iteration {iteration}, "
                            f"{rate * 1e3:.1f} ms/iter")


class EvaluativeListener(TrainingListener):
    """`model.evaluate` on a held-out iterator every `frequency` epochs
    (the evaluation reads class indices back: a host sync). Reference:
    EvaluativeListener."""

    def __init__(self, iterator, frequency: int = 1, on_epoch: bool = True):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.on_epoch = on_epoch
        self.evaluations: List = []

    def on_epoch_end(self, model, epoch):
        if self.on_epoch and epoch % self.frequency == 0:
            e = model.evaluate(self.iterator)
            self.evaluations.append(e)
            logger.info(f"epoch {epoch} eval: accuracy={e.accuracy():.4f}")
