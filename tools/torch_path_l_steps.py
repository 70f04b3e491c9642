#!/usr/bin/env python3
"""`chip_smoke.py`'s `path_l` trained several times on each design of
the LSTM forward B2a, every step timed on the card and on the host.

    python3 tools/torch_path_l_steps.py [--runs 3]

Each run builds path_l's net afresh (GravesLSTM(512) x 2 +
RnnOutputLayer(64), T 128, batch 64, float32, Nesterovs(0.01, 0.9),
seed 5) and fits the same 4 batches (two masked) for 3 epochs, every B2a
launch in one design (`ops/lstm.b2_design` answers it for the run). The
designs take turns, design 2 first: persistent, cluster, cluster,
persistent, ... Per step:

- `step_ms`: its device time, from CUDA events recorded after each step
  is enqueued, as `chip_smoke.timed_fit` records them;
- `host_ms`: the host's time from the end of the previous step's
  enqueue (at an epoch's first step: from the end of `fit`'s one read an
  epoch, the loss, which waits for the card) to the end of this one's;
- `etl_ms`: the batch fetch's share of it (the executor's: the first
  step of an epoch also pins and copies the next batch);
- `gc_ms`: the time Python's garbage collector ran within it.

Each epoch boundary also gets `epoch_wait_ms`, the host's wait in the
loss read. Prints one JSON line a run, then one a design: tokens/s over
steps 3-12, and the median and largest step at the epoch boundaries
(steps 5 and 9) and elsewhere. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

B, T, EPOCHS, PER_EPOCH = 64, 128, 3, 4


def fit_once(design: str, batches):
    """One timed fit of path_l's net with B2a in `design`."""
    from deeplearning4j_tpu_torch.ops import lstm as lk
    from deeplearning4j_tpu_torch.optim.listeners import TrainingListener

    class Clock(TrainingListener):
        def __init__(self):
            self.events, self.host, self.etl, self.gc = [], [], [], []
            self.wait, self.t, self.gc_ms, self.epoch_end = [], 0.0, 0.0, 0.0

        def _mark(self):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

        def on_fit_start(self, model):
            self._mark()
            self.t = time.perf_counter()

        def on_epoch_start(self, model, epoch):
            if self.epoch_end:
                now = time.perf_counter()
                self.wait.append((now - self.epoch_end) * 1e3)
                self.t = now

        def on_epoch_end(self, model, epoch):
            self.epoch_end = time.perf_counter()

        def set_etl_time(self, ms):
            self.etl.append(ms)

        def iteration_done(self, model, iteration, epoch, score):
            self._mark()
            now = time.perf_counter()
            self.host.append((now - self.t) * 1e3)
            self.gc.append(self.gc_ms)
            self.t, self.gc_ms = now, 0.0

    clock = Clock()
    gc_start = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            clock.gc_ms += (time.perf_counter() - gc_start[0]) * 1e3

    chosen = lk.b2_design
    lk.b2_design = lambda *shape: design
    gc.callbacks.append(on_gc)
    try:
        net = cs.build_lstm_net("cuda", seed=5)
        net.listeners.append(clock)
        torch.cuda.synchronize()
        lk.reset_counts()
        net.fit(batches, epochs=EPOCHS)
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(on_gc)
        lk.b2_design = chosen
    steps = EPOCHS * PER_EPOCH
    cs.check(lk.LAUNCHES_BY_DESIGN[("lstm_fwd", design)] == 2 * steps,
             f"{design}: B2a launches {dict(lk.LAUNCHES_BY_DESIGN)}")
    ev = clock.events
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    return {"phase": "path_l_steps", "design": design,
            "tokens_per_s_steps_3_12": (steps - 2) * B * T
            / (ev[2].elapsed_time(ev[steps]) / 1e3),
            "step_ms": step_ms, "host_ms": clock.host, "etl_ms": clock.etl,
            "gc_ms": clock.gc, "epoch_wait_ms": clock.wait}


def summary(design, runs):
    boundary = [PER_EPOCH * e for e in range(1, EPOCHS)]
    at = [r["step_ms"][i] for r in runs for i in boundary]
    rest = [r["step_ms"][i] for r in runs
            for i in range(1, EPOCHS * PER_EPOCH) if i not in boundary]
    return {"phase": "path_l_steps_summary", "design": design,
            "runs": len(runs),
            "tokens_per_s_steps_3_12": [r["tokens_per_s_steps_3_12"]
                                        for r in runs],
            "boundary_step_ms_median": float(np.median(at)),
            "boundary_step_ms_max": max(at),
            "other_step_ms_median": float(np.median(rest)),
            "other_step_ms_max": max(rest)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3,
                    help="fits per design (default 3)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_path_l_steps: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.gpu_name_and_limit(), flush=True)
    batches = cs.seq_batches(np.random.default_rng(0), PER_EPOCH, B, T, 128,
                             64, masked=(1, 3))
    fit_once("persistent", batches)             # builds and warms, untimed
    order = ["persistent", "cluster", "cluster", "persistent"]
    runs = {"persistent": [], "cluster": []}
    for i in range(2 * args.runs):
        design = order[i % 4]
        row = fit_once(design, batches)
        cs.emit(row)
        runs[design].append(row)
    for design, rows in runs.items():
        cs.emit(summary(design, rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
