"""Stats storage: pub/sub persistence for training statistics.

A copy of `deeplearning4j_tpu/ui/storage.py`, which imports nothing of
JAX: the port keeps its own. The file format is the same, so a file
written by one package replays in the other.

Reference parity: `deeplearning4j-core/.../api/storage/StatsStorage.java`
(session/type/worker IDs, static info vs updates, listener registration;
the interface extends `StatsStorageRouter.java` so every storage is also a
sink), `Persistable.java` (timestamped records), and the impls in
`deeplearning4j-ui-model/.../storage/` (InMemoryStatsStorage = map-backed,
FileStatsStorage = MapDB file — here an append-only JSONL file that is
replayed on open).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Persistable:
    """One timestamped record. Reference: `api/storage/Persistable.java`
    (getSessionID/getTypeID/getWorkerID/getTimeStamp + serialization)."""

    session_id: str
    type_id: str
    worker_id: str
    timestamp: float
    content: Dict[str, Any]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "Persistable":
        return cls(**json.loads(s))


@dataclasses.dataclass
class StatsStorageEvent:
    """Pub/sub notification. Reference: `api/storage/StatsStorageEvent.java`
    (NewSessionID / NewTypeID / NewWorkerID / PostUpdate)."""

    event_type: str  # "new_session" | "new_worker" | "post_update" | "post_static"
    session_id: str
    type_id: str
    worker_id: str
    timestamp: float


class StatsStorageRouter:
    """Write-side interface. Reference:
    `api/storage/StatsStorageRouter.java` (putStaticInfo/putUpdate)."""

    def put_static_info(self, record: Persistable) -> None:
        raise NotImplementedError

    def put_update(self, record: Persistable) -> None:
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Readable storage + listener registry. Reference:
    `api/storage/StatsStorage.java:30` — every storage is also a router."""

    def __init__(self):
        self._static: Dict[Tuple[str, str, str], Persistable] = {}
        self._updates: Dict[Tuple[str, str, str], List[Persistable]] = {}
        self._listeners: List[Callable[[StatsStorageEvent], None]] = []
        self._lock = threading.RLock()

    # ------------------------------------------------------------- writes
    def put_static_info(self, record: Persistable) -> None:
        key = (record.session_id, record.type_id, record.worker_id)
        with self._lock:
            new_session = not any(
                k[0] == record.session_id for k in
                list(self._static) + list(self._updates))
            self._static[key] = record
        self._persist("static", record)
        if new_session:
            self._emit("new_session", record)
        self._emit("post_static", record)

    def put_update(self, record: Persistable) -> None:
        key = (record.session_id, record.type_id, record.worker_id)
        with self._lock:
            self._updates.setdefault(key, []).append(record)
        self._persist("update", record)
        self._emit("post_update", record)

    # -------------------------------------------------------------- reads
    def list_session_ids(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k in
                           list(self._static) + list(self._updates)})

    def list_type_ids(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted({k[1] for k in
                           list(self._static) + list(self._updates)
                           if k[0] == session_id})

    def list_worker_ids(self, session_id: str,
                        type_id: Optional[str] = None) -> List[str]:
        with self._lock:
            return sorted({k[2] for k in
                           list(self._static) + list(self._updates)
                           if k[0] == session_id
                           and (type_id is None or k[1] == type_id)})

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: str) -> Optional[Persistable]:
        with self._lock:
            return self._static.get((session_id, type_id, worker_id))

    def get_latest_update(self, session_id: str, type_id: str,
                          worker_id: str) -> Optional[Persistable]:
        with self._lock:
            ups = self._updates.get((session_id, type_id, worker_id))
            return ups[-1] if ups else None

    def get_all_updates(self, session_id: str, type_id: str,
                        worker_id: str) -> List[Persistable]:
        with self._lock:
            return list(self._updates.get(
                (session_id, type_id, worker_id), []))

    def get_all_updates_after(self, session_id: str, type_id: str,
                              worker_id: str, ts: float) -> List[Persistable]:
        """Reference: `StatsStorage.getAllUpdatesAfter`."""
        return [u for u in self.get_all_updates(session_id, type_id,
                                                worker_id)
                if u.timestamp > ts]

    def num_updates(self, session_id: str, type_id: str,
                    worker_id: str) -> int:
        with self._lock:
            return len(self._updates.get(
                (session_id, type_id, worker_id), []))

    # ---------------------------------------------------------- listeners
    def register_stats_storage_listener(
            self, fn: Callable[[StatsStorageEvent], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def deregister_stats_storage_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _emit(self, event_type: str, r: Persistable) -> None:
        ev = StatsStorageEvent(event_type, r.session_id, r.type_id,
                               r.worker_id, r.timestamp)
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(ev)

    # -------------------------------------------------------- persistence
    def _persist(self, kind: str, record: Persistable) -> None:
        pass  # in-memory: nothing to do

    def close(self) -> None:
        pass


class InMemoryStatsStorage(StatsStorage):
    """Reference: `ui-model/.../storage/InMemoryStatsStorage.java`."""


class FileStatsStorage(StatsStorage):
    """Append-only JSONL-file storage, replayed on open. Reference:
    `ui-model/.../storage/FileStatsStorage.java` (MapDB-backed there)."""

    def __init__(self, path: str):
        super().__init__()
        self._path = path
        self._file = None
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    obj = json.loads(line)
                    rec = Persistable(**obj["record"])
                    key = (rec.session_id, rec.type_id, rec.worker_id)
                    if obj["kind"] == "static":
                        self._static[key] = rec
                    else:
                        self._updates.setdefault(key, []).append(rec)
        self._file = open(path, "a")

    def _persist(self, kind: str, record: Persistable) -> None:
        if self._file is None:
            return
        self._file.write(json.dumps(
            {"kind": kind, "record": dataclasses.asdict(record)}) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
