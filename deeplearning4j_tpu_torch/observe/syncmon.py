"""HostSyncMonitor — the dispatch-depth guard as a runtime metric.

The JAX package counts device→host materializations by patching
`ArrayImpl.__float__` and `block_until_ready`. The port patches the
seams where a torch program waits for its device:

- a tensor's value read on the host: `Tensor.item`, `tolist`, `numpy`,
  `__float__`, `__int__`, `__bool__` (the "float" kind);
- a device-to-host copy: `Tensor.cpu()` and `Tensor.to(<cpu device>)`
  of a tensor that is not on the CPU (also the "float" kind);
- a wait on the device: `torch.cuda.synchronize`,
  `torch.cuda.Event.synchronize`, `torch.cuda.Stream.synchronize` (the
  "block" kind).

A monitor counts a seam on its own device only (`device=`, default the
current CUDA device, else the CPU): a read of a CPU tensor under a
monitor of the CPU counts, as JAX on its CPU backend counts `float()` of
a CPU array, so the CPU tests hold the port's counts to JAX's. A
`.cpu()` of a CPU tensor is no copy and counts nothing.

    with HostSyncMonitor() as mon:
        net.fit(x, y, epochs=3)
    print(mon.syncs)          # total materializations

While installed, `PerformanceListener` reports syncs/step in its
periodic line and the `train_host_syncs_per_step` registry gauge.
Opt-in, because every patched seam costs one Python call while a
monitor is installed. Install/uninstall are refcounted and idempotent;
nested monitors share one patch. The wrappers read host metadata (the
tensor's device) and add no device operation, so a monitor is safe
around a CUDA-graph capture.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

_lock = threading.Lock()
_monitors: list = []          # install order; [-1] is `current_monitor()`
_originals: Optional[list] = None

# Tensor methods that read a value on the host
_READS = ("item", "tolist", "numpy", "__float__", "__int__", "__bool__")


def current_monitor() -> Optional["HostSyncMonitor"]:
    """The innermost installed monitor, or None (the PerformanceListener
    seam: report syncs/step only when someone asked to measure)."""
    with _lock:
        return _monitors[-1] if _monitors else None


def _bump(device: torch.device, kind: str, seam: str) -> None:
    for m in list(_monitors):
        if m._watches(device):
            m._bump(kind, seam)


def _to_cpu(args, kw) -> bool:
    """Does a `Tensor.to(...)` call name the CPU as its destination?"""
    dest = kw.get("device")
    if dest is None and args:
        a = args[0]
        if isinstance(a, torch.Tensor):
            dest = a.device
        elif isinstance(a, (str, torch.device)):
            dest = a
    if dest is None or isinstance(dest, int):
        return False
    try:
        return torch.device(dest).type == "cpu"
    except (RuntimeError, TypeError):
        return False


def _patch() -> None:
    """Install the counting wrappers (called with _lock held, once)."""
    global _originals
    saved = []
    T = torch.Tensor

    def wrap_read(name, orig):
        def counting(self, *a, **kw):
            _bump(self.device, "float", name)
            return orig(self, *a, **kw)
        return counting

    for name in _READS:
        saved.append((T, name, T.__dict__.get(name)))
        setattr(T, name, wrap_read(name, getattr(T, name)))

    orig_cpu, orig_to = T.cpu, T.to

    def counting_cpu(self, *a, **kw):
        if self.device.type != "cpu":
            _bump(self.device, "float", "cpu")
        return orig_cpu(self, *a, **kw)

    def counting_to(self, *a, **kw):
        if self.device.type != "cpu" and _to_cpu(a, kw):
            _bump(self.device, "float", "to")
        return orig_to(self, *a, **kw)

    for name, fn in (("cpu", counting_cpu), ("to", counting_to)):
        saved.append((T, name, T.__dict__.get(name)))
        setattr(T, name, fn)

    cuda = torch.cuda
    orig_sync = cuda.synchronize

    def counting_sync(device=None):
        if isinstance(device, int):
            dev = torch.device("cuda", device)
        else:
            dev = torch.device("cuda" if device is None else device)
        _bump(dev, "block", "synchronize")
        return orig_sync(device)

    saved.append((cuda, "synchronize", orig_sync))
    cuda.synchronize = counting_sync
    for cls in (cuda.Event, cuda.Stream):
        orig = cls.synchronize

        def counting(self, *a, _orig=orig, _seam=cls.__name__, **kw):
            # an Event may name no device of its own: any CUDA monitor
            dev = getattr(self, "device", None) or torch.device("cuda")
            _bump(dev, "block", f"{_seam}.synchronize")
            return _orig(self, *a, **kw)

        saved.append((cls, "synchronize", orig))
        cls.synchronize = counting
    _originals = saved


def _unpatch() -> None:
    global _originals
    for owner, name, orig in reversed(_originals):
        if orig is None:
            delattr(owner, name)    # fall back to the inherited method
        else:
            setattr(owner, name, orig)
    _originals = None


def _default_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class HostSyncMonitor:
    """Counts device→host materializations on `device` while
    installed."""

    def __init__(self, metrics=None, device=None):
        self._metrics = metrics
        self.device = (_default_device() if device is None
                       else torch.device(device))
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._count_lock = threading.Lock()
        self.float_syncs = 0
        self.block_syncs = 0
        self.by_seam: Dict[str, int] = {}
        self._installed = False

    def _watches(self, device: torch.device) -> bool:
        if device.type != self.device.type:
            return False
        return (device.type == "cpu" or device.index is None
                or device.index == self.device.index)

    @property
    def syncs(self) -> int:
        with self._count_lock:
            return self.float_syncs + self.block_syncs

    def _bump(self, kind: str, seam: str) -> None:
        with self._count_lock:
            if kind == "float":
                self.float_syncs += 1
            else:
                self.block_syncs += 1
            self.by_seam[seam] = self.by_seam.get(seam, 0) + 1

    def take(self) -> int:
        """Syncs since the last take() — the per-report-window delta the
        PerformanceListener divides by its batch count."""
        with self._count_lock:
            n = self.float_syncs + self.block_syncs
            self.float_syncs = 0
            self.block_syncs = 0
        return n

    def snapshot(self) -> dict:
        with self._count_lock:
            return {
                "device": str(self.device),
                "float_syncs": self.float_syncs,
                "block_syncs": self.block_syncs,
                "total": self.float_syncs + self.block_syncs,
                "by_seam": dict(self.by_seam),
            }

    # -------------------------------------------------------- lifecycle
    def install(self) -> "HostSyncMonitor":
        with _lock:
            if self._installed:
                return self
            if not _monitors:
                _patch()
            _monitors.append(self)
            self._installed = True
            if self._metrics is None:
                from deeplearning4j_tpu_torch.observe.registry import (
                    get_registry,
                )
                self._metrics = get_registry()
        self._flight_mark("syncmon_installed")
        return self

    def uninstall(self) -> None:
        with _lock:
            if not self._installed:
                return
            self._installed = False
            if self in _monitors:
                _monitors.remove(self)
            if not _monitors and _originals is not None:
                _unpatch()
        self._flight_mark("syncmon_uninstalled")

    def _flight_mark(self, kind: str) -> None:
        """Lifecycle breadcrumb in the crash ring: a dump that shows
        sync counts should also show when counting was on."""
        try:
            from deeplearning4j_tpu_torch.observe.flight import get_flight
            with self._count_lock:
                total = self.float_syncs + self.block_syncs
            get_flight().record(kind, total_syncs=total)
        # a breadcrumb must never break install/uninstall
        except Exception:
            pass

    def __enter__(self) -> "HostSyncMonitor":
        return self.install()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()
