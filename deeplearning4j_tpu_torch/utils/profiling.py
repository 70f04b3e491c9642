"""Profiling utilities of the port: a peak table of the card, a step's
flop count, `torch.profiler` traces and a listener that captures one
(the counterpart of `deeplearning4j_tpu/utils/profiling.py`).

- `peak_flops` / `peak_hbm_bytes` / `peak_ici_bytes` read a table keyed
  by `torch.cuda.get_device_name()`. It holds the NVIDIA H100 SXM part's
  data-sheet figures (dense, without sparsity, at its 700 W limit): 989
  TFLOP/s in bf16, 495 in TF32, 67 in float32 outside the tensor cores,
  3.35 TB/s of HBM3, 450 GB/s of NVLink in one direction. An unknown
  card returns None and warns once, so a caller omits the MFU rather
  than invent one.
- `step_cost` / `step_flops` count one train step's operations with
  `torch.utils.flop_counter.FlopCounterMode` (matrix products,
  convolutions and attention; elementwise work is not counted, where
  XLA's cost analysis counts it). The counter cannot see the kernels
  the port launches through ctypes, so the count runs one step of a
  copy of the model whose tensors are fake CPU tensors
  (`FakeTensorMode`): every kernel wrapper takes its plain PyTorch
  version there, the counter sees its products, and nothing is
  computed or allocated. The count never runs on the fit loop's path.
- `trace(log_dir)` captures a `torch.profiler` trace (Chrome trace
  JSON, viewable in Perfetto or TensorBoard) of the work inside it.
- `ProfilerListener` captures one over a window of iterations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
import warnings
from typing import Optional

import torch

from deeplearning4j_tpu_torch.observe.watchdog import (
    note_cost_analysis_failure,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")

# Per-card peaks from the data sheet, matched against the lower-cased
# device name. The SXM part only: the PCIe and NVL parts have other
# figures and are not in the table.
_H100_SXM = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12,
             "hbm": 3.35e12, "nvlink": 450e9}
PEAKS_BY_NAME = (
    ("h100 80gb hbm3", _H100_SXM),
    ("h100 sxm", _H100_SXM),
)
PRECISIONS = ("bf16", "tf32", "fp32")

_warned: set = set()


def _device_name(device_kind: Optional[str]) -> str:
    if device_kind is not None:
        return device_kind
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def _peak(what: str, device_kind: Optional[str]) -> Optional[float]:
    name = _device_name(device_kind)
    low = name.lower()
    for key, row in PEAKS_BY_NAME:
        if key in low:
            return row[what]
    if (what, low) not in _warned:
        _warned.add((what, low))
        logger.warning(
            "profiling: no data-sheet %s peak for device %r, so no "
            "roofline or MFU is reported for it. Add it to "
            "PEAKS_BY_NAME or pass the peak explicitly.", what, name)
    return None


def peak_flops(device_kind: Optional[str] = None,
               precision: str = "bf16") -> Optional[float]:
    """Dense peak FLOP/s of a card (default: CUDA device 0) for
    `precision` ("bf16", "tf32" or "fp32"). Unknown cards return None
    AND warn once naming the card — callers (PerformanceListener) must
    then OMIT the MFU gauge rather than publish NaN."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return _peak(precision, device_kind)


def peak_hbm_bytes(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak device-memory bandwidth (bytes/s) of a card; same contract as
    `peak_flops`."""
    return _peak("hbm", device_kind)


def peak_ici_bytes(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak card-to-card bandwidth (bytes/s, one direction: NVLink on an
    H100 SXM); same contract as `peak_flops`."""
    return _peak("nvlink", device_kind)


@dataclasses.dataclass(frozen=True)
class CostReport:
    """One train step's counted operations: `flops` in total and by
    PyTorch operator (`by_op`, e.g. "aten.mm")."""

    flops: Optional[float] = None
    by_op: Optional[dict] = None


def _fake_copy(model, mode):
    """A model of `model`'s class and configuration on the CPU whose
    trees hold fake tensors of the live trees' shapes and dtypes (no
    init, no memory)."""
    from deeplearning4j_tpu_torch.utils.pytrees import tree_map

    copy = type(model)(model.conf, device="cpu")

    def fake(t):
        if not isinstance(t, torch.Tensor):
            return t
        with mode:
            out = torch.zeros(t.shape, dtype=t.dtype, device="cpu")
        return out.requires_grad_(t.requires_grad)

    copy.params_tree = tree_map(fake, model.params_tree)
    copy.state_tree = tree_map(fake, model.state_tree)
    copy.updater_state = tree_map(fake, model.updater_state)
    copy._stateful = set(model._stateful)
    copy._build_updaters()
    with mode:
        copy._step_t = torch.zeros((), dtype=torch.int64)
    return copy


def step_cost(model, features, labels) -> Optional[CostReport]:
    """The operations of one train step of `model` on a batch of
    `features` and `labels` (arrays or tensors; only their shapes and
    dtypes matter), counted on a fake copy (module docstring). Failures
    return None — DEBUG-logged once and counted in
    `profiling_cost_analysis_failures`, never raised."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.data.dataset import DataSet

    try:
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        copy = _fake_copy(model, mode)
        # the batch as the fit loop puts it (a real CPU cast), then faked
        real = copy._put_batch(DataSet(features, labels))
        with mode:
            feats, labs = (torch.zeros(t.shape, dtype=t.dtype, device="cpu")
                           for t in (real.features, real.labels))
        counter = FlopCounterMode(display=False)
        # the updaters key their launch plans by data pointers, which a
        # fake tensor warns about: the plan is never launched here
        with mode, counter, warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            copy.make_step_fn()(copy.params_tree, copy.updater_state,
                                copy.state_tree, copy._step_t, feats, labs,
                                None, None, copy._rng, None)
        by_op = {str(k): int(v) for k, v in
                 counter.get_flop_counts().get("Global", {}).items()}
        total = float(counter.get_total_flops())
        return CostReport(flops=total or None, by_op=by_op)
    except Exception as e:
        note_cost_analysis_failure(
            f"step_cost flop count failed: {type(e).__name__}: {e}")
        return None


def step_flops(model, features, labels) -> Optional[float]:
    """Counted FLOPs of one train step (`step_cost`), or None."""
    report = step_cost(model, features, labels)
    return report.flops if report is not None else None


def _profile(log_dir: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` trace of the work inside the block into
    `log_dir` (a Chrome-trace JSON that Perfetto and TensorBoard read)."""
    os.makedirs(log_dir, exist_ok=True)
    prof = _profile(log_dir)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()


class ProfilerListener:
    """TrainingListener that captures a profiler trace over iterations
    [start_iteration, start_iteration + num_iterations). Attach alongside
    PerformanceListener for numbers and a timeline in one run."""

    def __init__(self, log_dir: str, *, start_iteration: int = 5,
                 num_iterations: int = 5):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.num_iterations = num_iterations
        self._prof = None
        self.captured = False

    # TrainingListener protocol (duck-typed; no import cycle with optim)
    def on_fit_start(self, model):
        # re-arm: a listener reused across fit() calls captures one
        # trace window per fit
        self.captured = False

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass

    def iteration_done(self, model, iteration, epoch, score):
        if self.captured:
            return
        if self._prof is None and iteration >= self.start_iteration:
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof = _profile(self.log_dir)
            self._prof.start()
            self._started_at = iteration
            self._t0 = time.time()
            return
        if self._prof is not None and \
                iteration >= self._started_at + self.num_iterations:
            self._close_trace(iteration)

    def on_fit_end(self, model):
        if self._prof is not None:   # fit ended mid-capture
            self._close_trace(getattr(model, "iteration", None))

    def _close_trace(self, end_iteration):
        prof, self._prof = self._prof, None
        prof.stop()
        self.captured = True
        # mirror the capture window into the span log so the JSONL
        # timeline can be matched to the profiler's
        from deeplearning4j_tpu_torch.observe import emit_manual_span

        emit_manual_span("torch.profiler.trace", self._t0, time.time(),
                         log_dir=self.log_dir,
                         start_iteration=self._started_at,
                         end_iteration=end_iteration)
