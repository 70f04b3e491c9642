"""Observability for the PyTorch port: one telemetry spine for training
and serving (the counterpart of `deeplearning4j_tpu/observe/`).

- `MetricsRegistry` (`registry.py`) — process-wide counters, gauges and
  histograms; the serving `/metrics` endpoint and the training
  listeners render it.
- `span()` (`trace.py`) — host-side tracing spans into a JSONL log; a
  span never reads a device value, so tracing adds no host sync.
- `reqtrace.py` — request-scoped trace trees (a `TraceContext` minted at
  the HTTP edge, fan-in dispatch spans, per-window session spans, the
  fit loop's `train.epoch` roots), head-sampled by
  `DL4J_TPU_TRACE_SAMPLE`, served by `GET /trace/{id}`.
- `FlightRecorder` (`flight.py`) — a bounded ring of recent events,
  dumped to JSON on a training exception, a scheduler worker crash, a
  watchdog trip or an SLO breach; `python -m
  deeplearning4j_tpu_torch.observe.dump` pretty-prints dumps, registry
  snapshots and span logs.
- `series.py` / `slo.py` — bounded time series over the registry, the
  SLO engine's multi-window burn rates and the anomaly watch.
- `RecompileWatchdog` (`watchdog.py`) — counts the first call of every
  new key in a per-owner cache (a CUDA-graph capture, a batch bucket's
  first forward), the port's counterpart of a jit compile, and warns
  once per owner past a churn threshold.
- `HostSyncMonitor` (`syncmon.py`) — opt-in count of device→host
  materializations (`.item()`, `.cpu()`, `synchronize`, ...).
- `DeviceMonitor` (`devicemon.py`) — per-card allocator memory.
- `StepAttribution` (`attribution.py`) — a step's etl / dispatch / host
  / device split, measured at the fit loop's one sync an epoch.

- `LockWitness` (`lockmon.py`) and `DonationWitness` (`donatemon.py`)
  — the JAX package's opt-in lock-order and use-after-donate witnesses,
  copied (stdlib only).
- `commsmon.py` — the comm ledger every collective of
  `parallel/distributed.py` records into (kind, payload, group size,
  wire bytes under the one-pass ring convention), the JAX package's HLO
  collective parser, and the `ReshardWitness` of the port's explicit
  reshards.

`WatchedJitCache` has no counterpart: the port keeps no jit cache, its
owners report to the watchdog directly.
"""

from deeplearning4j_tpu_torch.observe.registry import (
    MetricsRegistry, get_registry, set_registry,
)
from deeplearning4j_tpu_torch.observe.trace import (
    SpanLog, emit_manual_span, install_span_log, read_spans, span,
    tracing_enabled, uninstall_span_log,
)
from deeplearning4j_tpu_torch.observe.watchdog import (
    RecompileWatchdog, get_watchdog, set_watchdog,
)
from deeplearning4j_tpu_torch.observe.syncmon import (
    HostSyncMonitor, current_monitor,
)
from deeplearning4j_tpu_torch.observe.flight import (
    FlightRecorder, get_flight, latest_dump, read_dump, set_flight,
)
from deeplearning4j_tpu_torch.observe.devicemon import (
    DeviceMonitor, device_memory_summary, get_device_monitor,
    maybe_start_monitor, set_device_monitor,
)
from deeplearning4j_tpu_torch.observe.attribution import (
    StepAttribution, attribution_enabled,
)
from deeplearning4j_tpu_torch.observe.reqtrace import (
    TraceContext, TraceStore, active_dispatch, begin_dispatch,
    current_trace, end_dispatch, error_extra, error_trace, finish_root,
    get_trace_store, new_trace, record_span, set_trace_store,
)
from deeplearning4j_tpu_torch.observe.series import (
    SeriesRing, SeriesSampler, SeriesStore, series_key,
)
from deeplearning4j_tpu_torch.observe.slo import (
    SLO, AnomalyWatch, SLOEngine, default_slos,
)
from deeplearning4j_tpu_torch.observe.lockmon import (
    LockWitness, MonitoredLock, get_witness, lockmon_enabled,
    reset_witness,
)
from deeplearning4j_tpu_torch.observe.donatemon import (
    DonationWitness, UseAfterDonateError, donatemon_enabled,
    get_donation_witness, instrument, reset_donation_witness,
)
from deeplearning4j_tpu_torch.observe.commsmon import (
    CommLedger, ReshardWitness, commsmon_enabled, get_comm_ledger,
    get_reshard_witness, parse_hlo_collectives, reset_reshard_witness,
    summarize_collectives,
)

__all__ = [
    "MetricsRegistry", "get_registry", "set_registry",
    "SpanLog", "span", "install_span_log", "uninstall_span_log",
    "tracing_enabled", "read_spans", "emit_manual_span",
    "RecompileWatchdog", "get_watchdog", "set_watchdog",
    "HostSyncMonitor", "current_monitor",
    "FlightRecorder", "get_flight", "set_flight", "latest_dump", "read_dump",
    "DeviceMonitor", "device_memory_summary", "get_device_monitor",
    "maybe_start_monitor", "set_device_monitor",
    "StepAttribution", "attribution_enabled",
    "TraceContext", "TraceStore", "get_trace_store", "set_trace_store",
    "new_trace", "finish_root", "record_span", "error_trace", "error_extra",
    "current_trace", "begin_dispatch", "active_dispatch", "end_dispatch",
    "SeriesRing", "SeriesSampler", "SeriesStore", "series_key",
    "SLO", "AnomalyWatch", "SLOEngine", "default_slos",
    "LockWitness", "MonitoredLock", "get_witness", "lockmon_enabled",
    "reset_witness",
    "DonationWitness", "UseAfterDonateError", "donatemon_enabled",
    "get_donation_witness", "instrument", "reset_donation_witness",
    "CommLedger", "ReshardWitness", "commsmon_enabled", "get_comm_ledger",
    "get_reshard_witness", "reset_reshard_witness", "parse_hlo_collectives",
    "summarize_collectives",
]
