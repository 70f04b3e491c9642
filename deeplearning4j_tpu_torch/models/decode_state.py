"""DecodeState — the lock-owning holder for a model's ambient decode
state (`rnn_time_step` carries + decode position).

The port's own copy of `deeplearning4j_tpu/models/decode_state.py` (the
port imports nothing of the JAX package). Two threads stepping the same
net would interleave their read-modify-write of the carries and corrupt
each other's state silently. Serving does not share at all
(serving/sessions.py threads carries through the step as ARGUMENTS);
this class guards the ambient path: every mutation happens under one
reentrant lock, and a caller that needs a multi-step critical section
(seed -> step -> advance) takes the same lock via `lock()` around the
whole sequence.

The lock is reentrant so the model's step method can hold it across the
read-modify-write while the individual accessors stay safe for external
callers. Pickling/deepcopy drops the lock (a fresh one is made on
restore) — locks don't serialize, model snapshots do.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict


class DecodeState:
    """Carries + decode position behind one reentrant lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._carries: Dict[str, Any] = {}
        self._pos: int = 0

    def lock(self):
        """The lock itself, for multi-step critical sections:
        ``with st.lock(): ...`` composes with the locked accessors
        (reentrant)."""
        return self._lock

    @property
    def carries(self) -> Dict[str, Any]:
        with self._lock:
            return self._carries

    @property
    def pos(self) -> int:
        with self._lock:
            return self._pos

    def seed(self, carries: Dict[str, Any]) -> None:
        with self._lock:
            self._carries = carries

    def update(self, carries: Dict[str, Any], advance: int = 0) -> None:
        """Install the post-step carries and advance the decode position
        (only after a successful step — a step that raised must not
        burn decode budget)."""
        with self._lock:
            self._carries = carries
            self._pos += advance

    def clear(self) -> None:
        with self._lock:
            self._carries = {}
            self._pos = 0

    def reorder(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]):
        """Replace the carries with `fn(carries)` atomically (beam-search
        parent gathers)."""
        with self._lock:
            self._carries = fn(self._carries)

    # locks don't pickle/deepcopy; state snapshots do
    def __getstate__(self):
        with self._lock:
            return {"carries": self._carries, "pos": self._pos}

    def __setstate__(self, state):
        self._lock = threading.RLock()
        with self._lock:
            self._carries = state["carries"]
            self._pos = state["pos"]
