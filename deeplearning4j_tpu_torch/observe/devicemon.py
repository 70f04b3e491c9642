"""DeviceMonitor — device-truth memory telemetry.

The registry and spans measure the HOST clock; nothing in the spine sees
device memory, and the failure mode that leaves invisible is the slow
creep toward an out-of-memory error hundreds of steps away. The JAX
package polls `device.memory_stats()`; the port reads the CUDA caching
allocator of each card:

- `torch.cuda.memory_stats(d)`: `allocated_bytes.all.current` (bytes in
  use), `allocated_bytes.all.peak` (peak bytes in use) and
  `active.all.current` (active allocator blocks, the port's count of
  live arrays);
- `torch.cuda.mem_get_info(d)`: the card's total memory (the limit).

into the five gauges of the JAX package, labelled `device="cuda:N"`:

  device_memory_bytes_in_use{device="cuda:0"}
  device_memory_peak_bytes{device="cuda:0"}
  device_memory_limit_bytes{device="cuda:0"}
  device_memory_used_fraction{device="cuda:0"}
  device_live_arrays{device="cuda:0"}

and warns ONCE per device when used_fraction crosses the headroom
threshold (DL4J_TPU_HBM_WARN_FRACTION, default 0.9).

On the CPU (no card) the sample is `{"device": "cpu:0", "kind": "cpu",
"live_arrays": None, "memory_stats": None}` and no gauge is published.
That differs from the JAX package on its CPU backend in one point: JAX
counts live arrays there (`jax.live_arrays()`) and publishes
`device_live_arrays`; torch keeps no registry of live CPU tensors, so
the port reports None and no live-array gauge. `memory_stats` is None in
both (ROADMAP C18).

Polling is pull-based: `sample_once()` costs one allocator query per
card and runs (a) on demand from the `/devices` endpoint and flight
dumps, and (b) optionally on a background thread (`start()`, or
DL4J_TPU_DEVICEMON=1 + `maybe_start_monitor()`, which the
TrainingExecutor calls at every fit). Each sample also lands in the
FlightRecorder ring. A sample reads allocator counters only: no kernel,
no synchronize.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional

import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")

DEFAULT_INTERVAL_S = float(os.environ.get("DL4J_TPU_DEVICEMON_INTERVAL",
                                          "10"))
DEFAULT_WARN_FRACTION = float(os.environ.get("DL4J_TPU_HBM_WARN_FRACTION",
                                             "0.9"))

# allocator stat -> (sample key, registry gauge name)
_STAT_GAUGES = (
    ("allocated_bytes.all.current", "bytes_in_use",
     "device_memory_bytes_in_use"),
    ("allocated_bytes.all.peak", "peak_bytes_in_use",
     "device_memory_peak_bytes"),
)


def _label(device: torch.device) -> str:
    return f"{device.type}:{device.index or 0}"


def _devices() -> List[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class DeviceMonitor:
    """Poll per-card allocator memory into the registry."""

    def __init__(self, *, interval_s: Optional[float] = None,
                 warn_fraction: Optional[float] = None,
                 registry=None, record_flight: bool = True):
        self.interval_s = (DEFAULT_INTERVAL_S if interval_s is None
                           else float(interval_s))
        self.warn_fraction = (DEFAULT_WARN_FRACTION if warn_fraction is None
                              else float(warn_fraction))
        self._registry = registry     # None -> resolve per sample, so a
        self.record_flight = record_flight    # test registry swap is seen
        self._lock = threading.Lock()
        self._warned: set = set()
        self._last: List[dict] = []
        self.polls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ sampling
    def sample_once(self, devices=None) -> List[dict]:
        """One poll over `devices` (default: every card, or the CPU on a
        host without one). Returns the per-device sample list it also
        publishes as gauges."""
        reg = self._registry
        if reg is None:
            from deeplearning4j_tpu_torch.observe.registry import (
                get_registry,
            )
            reg = get_registry()
        samples = []
        for d in (_devices() if devices is None
                  else [torch.device(x) for x in devices]):
            label = _label(d)
            if d.type != "cuda":
                samples.append({"device": label, "kind": d.type,
                                "live_arrays": None, "memory_stats": None})
                continue
            stats = torch.cuda.memory_stats(d)
            live = int(stats.get("active.all.current", 0))
            sample: Dict = {"device": label,
                            "kind": torch.cuda.get_device_name(d),
                            "live_arrays": live}
            reg.gauge("device_live_arrays", device=label).set(live)
            for key, name, gname in _STAT_GAUGES:
                v = int(stats.get(key, 0))
                sample[name] = v
                reg.gauge(gname, device=label).set(v)
            limit = int(torch.cuda.mem_get_info(d)[1])
            sample["bytes_limit"] = limit
            reg.gauge("device_memory_limit_bytes", device=label).set(limit)
            in_use = sample["bytes_in_use"]
            frac = in_use / float(limit)
            sample["used_fraction"] = round(frac, 4)
            reg.gauge("device_memory_used_fraction",
                      device=label).set(frac)
            self._maybe_warn(label, frac, in_use, limit)
            samples.append(sample)
        with self._lock:
            self._last = samples
            self.polls += 1
        if self.record_flight:
            try:
                from deeplearning4j_tpu_torch.observe.flight import (
                    get_flight,
                )
                get_flight().record("device_memory", devices=samples)
            # the ring breadcrumb is best-effort; the gauges above are
            # the authoritative surface
            except Exception:
                pass
        return samples

    def _maybe_warn(self, label: str, frac: float, in_use: int,
                    limit: int) -> None:
        if frac < self.warn_fraction:
            return
        with self._lock:
            if label in self._warned:
                return
            self._warned.add(label)
        logger.warning(
            "DeviceMonitor: memory headroom low on %s — %.1f%% of %.0f "
            "MiB in use (%.0f MiB, warn threshold %.0f%%). The next "
            "allocation spike (optimizer state, an activation peak, a "
            "new graph's pool) may run out of memory; shrink the batch "
            "or the pools before the allocator does it for you.",
            label, frac * 100.0, limit / 2**20, in_use / 2**20,
            self.warn_fraction * 100.0)
        try:
            from deeplearning4j_tpu_torch.observe.flight import get_flight
            get_flight().record("hbm_headroom_warning", device=label,
                                used_fraction=round(frac, 4),
                                bytes_in_use=int(in_use),
                                bytes_limit=int(limit))
        # the ring breadcrumb is best-effort; the warning reached the log
        except Exception:
            pass

    # ---------------------------------------------------------- background
    @property
    def running(self) -> bool:
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        """Start background polling (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, name="dl4j-torch-devicemon", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        # pin this run's Event: start() replaces self._stop on restart,
        # and a straggling old loop must keep waiting on its own event
        with self._lock:
            stop = self._stop
        while not stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                logger.debug("DeviceMonitor: sample failed", exc_info=True)

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
            self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=timeout)

    # ---------------------------------------------------------- reporting
    def last_samples(self) -> List[dict]:
        with self._lock:
            return list(self._last)

    def snapshot(self) -> dict:
        # `running` takes the lock itself: read it first (the JAX
        # monitor reads it under the lock and deadlocks, ROADMAP C18)
        running = self.running
        with self._lock:
            return {"interval_s": self.interval_s,
                    "warn_fraction": self.warn_fraction,
                    "polls": self.polls,
                    "running": running,
                    "devices": list(self._last)}


# ------------------------------------------------------------ process-wide
_monitor: Optional[DeviceMonitor] = None
_install_lock = threading.Lock()


def get_device_monitor() -> DeviceMonitor:
    global _monitor
    if _monitor is None:
        with _install_lock:
            if _monitor is None:
                _monitor = DeviceMonitor()
    return _monitor


def set_device_monitor(mon: DeviceMonitor) -> Optional[DeviceMonitor]:
    """Swap the process-wide monitor (tests pin intervals/registries);
    returns the previous one."""
    global _monitor
    with _install_lock:
        prev, _monitor = _monitor, mon
    return prev


def device_memory_summary() -> Optional[List[dict]]:
    """One best-effort sample for embedding in reports (flight dumps);
    None when the allocator query fails."""
    try:
        return get_device_monitor().sample_once()
    except Exception:
        return None


def maybe_start_monitor() -> bool:
    """Start background polling iff DL4J_TPU_DEVICEMON is truthy
    (default off — on-demand sampling is free; a poll thread is a
    choice). Idempotent; the TrainingExecutor calls this at every fit."""
    if os.environ.get("DL4J_TPU_DEVICEMON", "0").lower() in (
            "0", "", "false"):
        return False
    get_device_monitor().start()
    return True
