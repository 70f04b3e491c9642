"""StatsListener — per-iteration training statistics capture (port of
`deeplearning4j_tpu/ui/stats.py`).

Reference parity: `deeplearning4j-ui-model/.../ui/stats/BaseStatsListener.java`
(`iterationDone:297` gathers score, param/update histograms + mean magnitudes,
minibatch/example rates, memory, every `listenerFrequency` iterations, and
routes an initialization report + update reports into a `StatsStorageRouter`).

On the device: every statistic of a report is computed where the
parameters live. The leaves of each dtype are copied end to end into
one flat vector a report, and every statistic and histogram is a
segmented reduction over it (`torch.segment_reduce`, one launch for
all leaves, not one a leaf); the previous report's flat copy stays on
the device, so the update statistics and histograms are differences
taken there too. The score, the per-leaf statistics, the update
statistics, the histograms and the activation statistics are packed
into one float64 tensor and read back once a report. The whole model
never comes to the host.

The report equals the JAX package's key for key:

- leaves are named and ordered as JAX's `tree_flatten_with_path` names
  them (dict keys sorted, joined by "/"), not in the insertion order
  `optim/updaters.tree_leaves` walks;
- statistics are taken of the leaf cast to float32, as JAX's
  `_tree_stats` takes them, and accumulated in float64; `std` is the
  population deviation (ddof 0, `jnp.std`'s);
- an update is the difference of two reports' parameters in the leaf's
  dtype, as JAX subtracts its host copies;
- a histogram is `np.histogram(x, bins)`'s algorithm done in torch
  (`segment_histograms`): numpy's edges (its `linspace`, in the precision of the
  NumPy installed), its index arithmetic and its one-ulp corrections,
  the maximum in the last bin. On the CPU the counts are numpy's
  exactly; a bfloat16 leaf is binned in float32 (JAX bins its bfloat16
  host copy in bfloat16).

The init record's `software` block is `{"torch_version", "cuda",
"backend"}` (JAX's is `{"jax_version", "backend"}`); `backend` is the
model's device type, `hardware.device_kind` the card's name.
"""

from __future__ import annotations

import resource
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optim.listeners import TrainingListener
from deeplearning4j_tpu_torch.ui.storage import Persistable, StatsStorageRouter

TYPE_ID = "StatsListener"  # reference: BaseStatsListener.TYPE_ID:45

# the per-leaf statistics in JAX's report order (its stats tree's keys,
# sorted by `tree_flatten`)
STAT_KEYS = ("max", "mean", "mean_magnitude", "min", "norm2", "std")


def named_leaves(tree, prefix: Tuple[str, ...] = ()
                 ) -> List[Tuple[str, torch.Tensor]]:
    """(name, leaf) of nested dicts in JAX's flatten order: dict keys
    sorted, depth first, a sequence's items by index; the name is the
    path joined by "/" (`_leaf_names`'s). `()` and `None` hold no
    leaf."""
    if isinstance(tree, dict):
        return [nl for k in sorted(tree)
                for nl in named_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [nl for i, v in enumerate(tree)
                for nl in named_leaves(v, prefix + (str(i),))]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _bin_dtype(dtype: torch.dtype) -> torch.dtype:
    """The float type numpy bins values of `dtype` in: float64 for
    float64, float32 otherwise (bfloat16 and float16 are widened
    first)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# NumPy 2 (NEP 50) takes `np.histogram`'s edges of float32 data in
# float32 arithmetic; NumPy 1 took them in float64 and rounded them to
# float32 once (its `linspace` promoted the float32 limits with a Python
# float). The two differ by many float32 ulps at an edge near zero, so
# the port follows the NumPy it runs beside.
_EDGES_IN_FLOAT64 = np.lib.NumpyVersion(np.__version__) < "2.0.0"


def segments(sizes: List[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lengths, segment of every element) of vectors of `sizes` laid end
    to end, both int64 on `device`."""
    lengths = torch.tensor(sizes, dtype=torch.int64, device=device)
    seg = torch.repeat_interleave(
        torch.arange(len(sizes), device=device), lengths,
        output_size=sum(sizes))
    return lengths, seg


def _reduce(x: torch.Tensor, how: str, lengths: torch.Tensor):
    """One reduction per segment (no host read: `unsafe` skips the
    lengths' check, which reads their sum)."""
    return torch.segment_reduce(x, how, lengths=lengths, unsafe=True)


def _linspace(lo, hi, bins: int, dtype):
    """numpy's `linspace(lo, hi, bins + 1)` for each row's limits, in
    `dtype`: y * step + lo (y / bins * (hi - lo) for a subnormal step),
    the last edge set to hi. [rows, bins + 1]. The divisor is a tensor on
    the device: CUDA divides by a Python number as a product with its
    reciprocal, one bit off numpy's quotient."""
    delta = (hi - lo)[:, None]
    div = torch.full((), bins, dtype=dtype, device=lo.device)
    step = delta / div
    ramp = torch.arange(bins + 1, dtype=dtype, device=lo.device)[None, :]
    edges = torch.where(step == 0, ramp / div * delta, ramp * step) \
        + lo[:, None]
    edges[:, -1] = hi
    return edges


def segment_histograms(x: torch.Tensor, lengths: torch.Tensor,
                       seg: torch.Tensor, bins: int = 20):
    """`np.histogram(v, bins)` of every segment `v` of the flat `x`, on
    `x`'s device with no host read: (counts int64 [segments, bins],
    first edges, last edges). Each segment's edges span [min, max]
    (widened by 0.5 each way when they are equal) and are numpy's
    `linspace` (`_EDGES_IN_FLOAT64` says in which precision); each value's
    bin is numpy's `(v - lo) / (hi - lo) * bins`, truncated, with the
    maximum moved into the last bin and one-ulp misplacements corrected
    against the edges (`numpy/lib/_histograms_impl.py`'s uniform-bin
    path)."""
    x = x.to(_bin_dtype(x.dtype))
    lo, hi = _reduce(x, "min", lengths), _reduce(x, "max", lengths)
    same = lo == hi
    wide = torch.float64 if _EDGES_IN_FLOAT64 else x.dtype
    elo, ehi = lo.to(wide), hi.to(wide)
    edges = _linspace(torch.where(same, elo - 0.5, elo),
                      torch.where(same, ehi + 0.5, ehi), bins,
                      wide).to(x.dtype)
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    idx = ((x - lo[seg]) / (hi - lo)[seg] * bins).to(torch.int64)
    idx = idx - (idx == bins).to(torch.int64)
    flat = edges.reshape(-1)
    at = seg * (bins + 1)
    idx = idx - (x < flat[at + idx]).to(torch.int64)
    idx = idx + ((x >= flat[at + idx + 1])
                 & (idx != bins - 1)).to(torch.int64)
    # bincount without its size read (torch.bincount syncs on CUDA)
    counts = torch.zeros(len(lengths) * bins, dtype=torch.int64,
                         device=x.device)
    counts.index_add_(0, seg * bins + idx, torch.ones(
        (), dtype=torch.int64, device=x.device).expand_as(idx))
    return counts.view(len(lengths), bins), edges[:, 0], edges[:, -1]


def segment_stats(x: torch.Tensor, lengths: torch.Tensor,
                  seg: torch.Tensor) -> torch.Tensor:
    """[max, mean, mean_magnitude, min, norm2, std] of every segment of
    the flat `x` cast to float32, accumulated in float64 (`STAT_KEYS`
    order; std with ddof 0): [segments, 6]."""
    xf = x.float()
    mn, mx = _reduce(xf, "min", lengths), _reduce(xf, "max", lengths)
    xd = xf.double()
    n = lengths.double()
    mean = _reduce(xd, "sum", lengths) / n
    dev = xd - mean[seg]
    return torch.stack([
        mx.double(), mean, _reduce(xd.abs(), "sum", lengths) / n,
        mn.double(), _reduce(xd * xd, "sum", lengths).sqrt(),
        (_reduce(dev * dev, "sum", lengths) / n).sqrt()], dim=1)


def _update_stats(u: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[mean_magnitude, norm2] of every segment of an update, accumulated
    in float64: [segments, 2]."""
    ud = u.double()
    return torch.stack([_reduce(ud.abs(), "sum", lengths) / lengths,
                        _reduce(ud * ud, "sum", lengths).sqrt()], dim=1)


def _act_stats(a: torch.Tensor) -> torch.Tensor:
    """[mean, std, mean_magnitude] of an activation (population std)."""
    ad = a.reshape(-1).double()
    var, mean = torch.var_mean(ad, correction=0)
    return torch.stack([mean, var.sqrt(), ad.abs().mean()])


def _hist_rows(x, lengths, seg, bins: int) -> torch.Tensor:
    """[segments, bins + 2] float64 rows of counts, first and last edge
    (counts are exact in float64 up to 2**53)."""
    counts, lo, hi = segment_histograms(x, lengths, seg, bins)
    return torch.cat([counts.double(), lo.double()[:, None],
                      hi.double()[:, None]], dim=1)


def _hist_dict(row: List[float], bins: int) -> Dict[str, Any]:
    return {"counts": [int(c) for c in row[:bins]],
            "min": float(row[bins]), "max": float(row[bins + 1])}


class _Layout:
    """A parameter tree's leaves grouped by dtype, each group laid end to
    end as one flat vector with its segments; built once a tree layout
    (shapes and dtypes in flatten order)."""

    def __init__(self, leaves: List[torch.Tensor]):
        self.key = self.key_of(leaves)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, x in enumerate(leaves):
            by_dtype.setdefault(x.dtype, []).append(i)
        dev = leaves[0].device
        self.groups = [(idx, *segments([leaves[i].numel() for i in idx],
                                       dev))
                       for idx in by_dtype.values()]
        # the leaf of each row the groups' results stack into
        self.order = [i for idx, _, _ in self.groups for i in idx]

    @staticmethod
    def key_of(leaves):
        return [(tuple(x.shape), x.dtype, x.device) for x in leaves]

    def flats(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        """One new flat copy of each group's leaves, in their dtype."""
        return [torch.cat([leaves[i].detach().reshape(-1) for i in idx])
                for idx, _, _ in self.groups]


class StatsListener(TrainingListener):
    """Reference: `BaseStatsListener` + its concrete
    `ui/stats/StatsListener.java`; constructor mirrors
    `BaseStatsListener(StatsStorageRouter, listenerFrequency):117`.

    `last_readback_bytes` is the size of the last report's packed read
    back; `last_report_ms` the host time the last report took."""

    def __init__(self, router: StatsStorageRouter, frequency: int = 1, *,
                 session_id: Optional[str] = None, worker_id: str = "local",
                 collect_histograms: bool = False, histogram_bins: int = 20,
                 collect_activations: bool = False,
                 activation_examples: int = 32):
        self.router = router
        self.frequency = max(frequency, 1)
        self.session_id = session_id or uuid.uuid4().hex[:12]
        self.worker_id = worker_id
        self.collect_histograms = collect_histograms
        self.histogram_bins = histogram_bins
        self.collect_activations = collect_activations
        self.activation_examples = activation_examples
        self._init_done = False
        self._count = 0
        self._last_report_time: Optional[float] = None
        self._layout: Optional[_Layout] = None
        # the previous report's parameters: `_layout`'s flat groups
        self._last_params: Optional[List[torch.Tensor]] = None
        self._iter_since_report = 0
        self.last_readback_bytes = 0
        self.last_report_ms = 0.0

    # ---------------------------------------------------------------- hooks
    def on_fit_start(self, model) -> None:
        if not self._init_done:
            self._do_init(model)

    def iteration_done(self, model, iteration: int, epoch: int,
                       score) -> None:
        self._count += 1
        self._iter_since_report += 1
        if self._count % self.frequency:
            return
        t0 = time.perf_counter()
        if not self._init_done:
            self._do_init(model)
        now = time.time()
        report: Dict[str, Any] = {
            "iteration": int(iteration),
            "epoch": int(epoch),
            "score": None,
            "timestamp": now,
        }
        # rates (reference: updateExamplesMinibatchesCounts:695 + rate calc)
        if self._last_report_time is not None:
            dt = max(now - self._last_report_time, 1e-9)
            report["minibatches_per_second"] = self._iter_since_report / dt
        self._last_report_time = now
        self._iter_since_report = 0

        params = getattr(model, "params_tree", None)
        leaves = named_leaves(params) if params is not None else []
        names = [n for n, _ in leaves]
        tensors = [x for _, x in leaves]
        device = tensors[0].device if tensors else torch.device("cpu")
        if tensors and (self._layout is None
                        or self._layout.key != _Layout.key_of(tensors)):
            self._layout, self._last_params = _Layout(tensors), None
        bins = self.histogram_bins
        # every device value of the report, in one packed row
        parts: List[torch.Tensor] = [
            torch.as_tensor(score, device=device).double().reshape(1)]
        has_update = False
        act_names: List[str] = []
        with torch.no_grad():
            if tensors:
                groups = self._layout.groups
                flats = self._layout.flats(tensors)
                parts.append(torch.cat([
                    segment_stats(f, lengths, seg)
                    for f, (_, lengths, seg) in zip(flats, groups)]))
                has_update = self._last_params is not None
                if has_update:
                    upd = [f - p for f, p in zip(flats, self._last_params)]
                    parts.append(torch.cat([
                        _update_stats(u, lengths)
                        for u, (_, lengths, _) in zip(upd, groups)]))
                    if self.collect_histograms:
                        parts.append(torch.cat([
                            _hist_rows(u, lengths, seg, bins)
                            for u, (_, lengths, seg) in zip(upd, groups)]))
                    del upd
                if self.collect_histograms:
                    parts.append(torch.cat([
                        _hist_rows(f, lengths, seg, bins)
                        for f, (_, lengths, seg) in zip(flats, groups)]))
                self._last_params = flats
            if self.collect_activations:
                feats = getattr(model, "_last_features", None)
                ff = getattr(model, "feed_forward", None)
                if feats is not None and ff is not None:
                    acts = ff(feats[:self.activation_examples])
                    layer_names = [l.name for l in model.conf.layers]
                    pairs = list(zip(layer_names, acts))
                    act_names = [n for n, _ in pairs]
                    if pairs:
                        parts.append(torch.stack(
                            [_act_stats(a) for _, a in pairs]))
            packed = torch.cat([p.to(device).reshape(-1) for p in parts])
            host = packed.cpu().tolist()       # the report's one read-back
        self.last_readback_bytes = packed.numel() * packed.element_size()

        pos = 0

        def take(width: int) -> List[List[float]]:
            """The next block of rows, `width` values each, one a leaf,
            back in flatten (name) order."""
            nonlocal pos
            rows = [host[pos + r * width:pos + (r + 1) * width]
                    for r in range(len(names))]
            pos += width * len(names)
            out = [None] * len(names)
            for r, leaf in enumerate(self._layout.order):
                out[leaf] = rows[r]
            return out

        report["score"] = float(host[0])
        pos = 1
        if tensors:
            report["param_stats"] = {
                n: dict(zip(STAT_KEYS, row))
                for n, row in zip(names, take(len(STAT_KEYS)))}
        if has_update:
            report["update_stats"] = {
                n: {"mean_magnitude": row[0], "norm2": row[1]}
                for n, row in zip(names, take(2))}
            if self.collect_histograms:
                # gradient/update histograms — the HistogramModule's
                # second panel (reference: BaseStatsListener update
                # histogram collection)
                report["update_histograms"] = {
                    n: _hist_dict(row, bins)
                    for n, row in zip(names, take(bins + 2))}
        if tensors and self.collect_histograms:
            report["param_histograms"] = {
                n: _hist_dict(row, bins)
                for n, row in zip(names, take(bins + 2))}
        if act_names:
            # activation stats (reference: BaseStatsListener activation
            # mean-magnitude/histogram collection via onForwardPass) — one
            # extra forward on a slice of the last training batch, opt-in
            vals = host[pos:pos + 3 * len(act_names)]
            report["activation_stats"] = {
                n: {"mean": vals[3 * i], "std": vals[3 * i + 1],
                    "mean_magnitude": vals[3 * i + 2]}
                for i, n in enumerate(act_names)}

        # memory (reference: system/JVM memory in the init+update reports)
        report["memory_rss_mb"] = (
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0)
        # device-truth counterpart: per-device memory in use/peak/limit
        # beside the host RSS
        from deeplearning4j_tpu_torch.observe.devicemon import (
            device_memory_summary,
        )
        dm = device_memory_summary()
        if dm is not None:
            report["device_memory"] = dm

        self.router.put_update(Persistable(
            self.session_id, TYPE_ID, self.worker_id, now, report))
        self.last_report_ms = (time.perf_counter() - t0) * 1e3

    # ----------------------------------------------------------------- init
    def _do_init(self, model) -> None:
        """Reference: `BaseStatsListener.doInit:560` — session metadata,
        software/hardware info, model config + param counts."""
        conf_json = None
        conf = getattr(model, "conf", None)
        if conf is not None and hasattr(conf, "to_json"):
            try:
                conf_json = conf.to_json()
            except Exception:
                conf_json = None
        dev = torch.device(getattr(model, "device", "cpu"))
        on_card = dev.type == "cuda"
        info = {
            "model_class": type(model).__name__,
            "config_json": conf_json,
            "num_params": int(getattr(model, "num_params", lambda: 0)() or 0),
            "software": {"torch_version": torch.__version__,
                         "cuda": torch.version.cuda,
                         "backend": dev.type},
            "hardware": {"num_devices": (torch.cuda.device_count()
                                         if on_card else 1),
                         "device_kind": (torch.cuda.get_device_name(dev)
                                         if on_card else dev.type)},
            "timestamp": time.time(),
        }
        self.router.put_static_info(Persistable(
            self.session_id, TYPE_ID, self.worker_id, time.time(), info))
        self._init_done = True

    def clone(self, worker_id: Optional[str] = None) -> "StatsListener":
        """Per-replica copy for multi-worker training (the reference's
        ParallelWrapper clones listeners per Trainer): SAME session, distinct
        worker id, fresh accumulation state."""
        if worker_id is None:
            worker_id = f"{self.worker_id}-{uuid.uuid4().hex[:6]}"
        return StatsListener(self.router, self.frequency,
                             session_id=self.session_id,
                             worker_id=worker_id,
                             collect_histograms=self.collect_histograms,
                             histogram_bins=self.histogram_bins,
                             collect_activations=self.collect_activations,
                             activation_examples=self.activation_examples)
