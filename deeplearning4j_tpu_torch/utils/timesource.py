"""Time sources: system clock + NTP-disciplined clock (the port's copy
of `deeplearning4j_tpu/utils/timesource.py`).

Reference parity: `spark/time/` — `TimeSource` SPI,
`SystemClockTimeSource`, `NTPTimeSource` (queries an NTP server on a
schedule, caches the offset, so phase-timing stats from different hosts
line up on one timeline), selected via `TimeSourceProvider` (system
property `org.deeplearning4j.spark.time.TimeSource`).

The SNTP exchange is the standard 48-byte RFC 4330 client datagram over
UDP — no dependencies. Offline/blocked environments fall back to the
system clock with `synchronized_` False (never an exception at training
time, matching the reference's log-and-continue behavior).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

_NTP_EPOCH_DELTA = 2208988800  # 1900-01-01 → 1970-01-01 in seconds


class TimeSource:
    """Reference: `spark/time/TimeSource.java`."""

    def current_time_millis(self) -> int:
        raise NotImplementedError


class SystemClockTimeSource(TimeSource):
    """Reference: `spark/time/SystemClockTimeSource.java`."""

    def current_time_millis(self) -> int:
        return int(time.time() * 1000)


def sntp_offset_ms(server: str = "pool.ntp.org", *, port: int = 123,
                   timeout: float = 2.0) -> float:
    """One SNTP exchange → clock offset in ms ((t1-t0)+(t2-t3))/2.
    Raises on network failure (caller decides the fallback policy)."""
    packet = bytearray(48)
    packet[0] = 0x1B  # LI=0, VN=3, Mode=3 (client)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        t0 = time.time()
        s.sendto(bytes(packet), (server, port))
        data, _ = s.recvfrom(256)
        t3 = time.time()
    if len(data) < 48:
        raise IOError(f"short NTP response from {server}")

    def ts(off):
        sec, frac = struct.unpack("!II", data[off:off + 8])
        return sec - _NTP_EPOCH_DELTA + frac / 2**32

    t1 = ts(32)   # server receive
    t2 = ts(40)   # server transmit
    return (((t1 - t0) + (t2 - t3)) / 2.0) * 1000.0


class NTPTimeSource(TimeSource):
    """Reference: `spark/time/NTPTimeSource.java` — offset measured
    against an NTP server, refreshed every `update_freq_ms`; failures
    leave the last known offset (0 initially) and mark
    `synchronized_ = False`."""

    DEFAULT_SERVER = "0.pool.ntp.org"

    def __init__(self, server: Optional[str] = None,
                 update_freq_ms: int = 30 * 60 * 1000, *,
                 timeout: float = 2.0):
        # reference reads server/frequency from system properties
        self.server = server or os.environ.get(
            "DL4J_TPU_NTP_SERVER", self.DEFAULT_SERVER)
        self.update_freq_ms = update_freq_ms
        self.timeout = timeout
        self.offset_ms = 0.0
        self.synchronized_ = False
        # first sync inline (construction isn't on the timed path); later
        # refreshes run on a daemon thread — the reference schedules its
        # updates on a background executor for the same reason:
        # current_time_millis() must never block on the network.
        self._update_once()
        import threading
        import weakref

        self._stop = threading.Event()
        # The worker holds only a WEAK reference: a bound-method target
        # would pin the instance forever (never GC'd, __del__ never runs,
        # thread leaks). With the weakref the thread exits when the source
        # is dropped OR close()d.
        self._thread = threading.Thread(
            target=_ntp_refresh_worker,
            args=(weakref.ref(self), self._stop),
            daemon=True, name="ntp-refresh")
        self._thread.start()

    def _update_once(self):
        try:
            self.offset_ms = sntp_offset_ms(
                self.server, timeout=self.timeout)
            self.synchronized_ = True
        except Exception:
            # keep last offset; flag unsynchronized (reference logs + keeps
            # serving system time rather than failing training)
            self.synchronized_ = False

    def close(self):
        self._stop.set()

    def __del__(self):
        self._stop.set()

    def current_time_millis(self) -> int:
        """Cached-offset read — never touches the network."""
        return int(time.time() * 1000 + self.offset_ms)


def _ntp_refresh_worker(ref, stop):
    """Module-level refresh loop over a weakref (see NTPTimeSource.__init__).
    Interval clamped to >= 1s so update_freq_ms=0 can't busy-loop SNTP."""
    while True:
        src = ref()
        if src is None:
            return
        interval = max(src.update_freq_ms, 1000) / 1000.0
        del src
        if stop.wait(interval):
            return
        src = ref()
        if src is None:
            return
        src._update_once()
        del src


class TimeSourceProvider:
    """Reference: `spark/time/TimeSourceProvider.java` — singleton chosen
    by config (env var here instead of the JVM system property)."""

    _instance: Optional[TimeSource] = None

    @classmethod
    def get_instance(cls) -> TimeSource:
        if cls._instance is None:
            kind = os.environ.get("DL4J_TPU_TIME_SOURCE", "system").lower()
            cls._instance = (NTPTimeSource() if kind == "ntp"
                             else SystemClockTimeSource())
        return cls._instance

    @classmethod
    def set_instance(cls, ts: Optional[TimeSource]) -> None:
        # no implicit close(): callers may re-register the old instance
        # later (its refresh thread must stay alive); an unreferenced NTP
        # source stops its thread via __del__ when collected
        cls._instance = ts
