"""Quantized gradient exchange — the GradientsAccumulator equivalent
(port of `deeplearning4j_tpu/parallel/accumulation.py`).

Mirrors the reference's SHARED_GRADIENTS machinery
(deeplearning4j-nn/.../optimize/solvers/accumulation/: GradientsAccumulator,
BasicGradientsAccumulator, EncodingHandler.java:26-102 threshold encoding,
LocalHandler). Data-parallel training exchanges dense gradients by
all-reduce (`ParallelWrapper`); this module keeps the asynchronous,
bandwidth-compressed exchange for host-to-host traffic. Encoding is the
port's own native C++ threshold codec (`deeplearning4j_tpu_torch.native`,
the same `.cpp` as the JAX package's), so the messages are JAX's bytes;
transport is pluggable via MessageHandler, defaulting to the in-process
LocalHandler.
"""

from __future__ import annotations

import queue
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch import native


class MessageHandler:
    """Transport SPI (reference MessageHandler.java): broadcast an encoded
    update to peers; deliver received updates into the accumulator."""

    accumulator: Optional["GradientsAccumulator"] = None

    def initialize(self, accumulator: "GradientsAccumulator") -> None:
        self.accumulator = accumulator

    def broadcast(self, packed: np.ndarray, threshold: float, n: int) -> None:
        raise NotImplementedError


class LocalHandler(MessageHandler):
    """In-process loopback (reference LocalHandler.java) — peers share one
    accumulator; used by tests and single-host multi-replica training."""

    def broadcast(self, packed, threshold, n):
        if self.accumulator is not None:
            self.accumulator.receive_update(packed, threshold, n)


class EncodingHandler:
    """Threshold-encodes a dense gradient into a sparse 1-bit message
    (reference EncodingHandler.java:57-102).

    The residual below the threshold stays in ``residual`` and is carried
    into later rounds, so no gradient mass is dropped, only delayed.
    """

    def __init__(self, threshold: float = 1e-3,
                 handler: Optional[MessageHandler] = None):
        self.threshold = float(threshold)
        self.handler = handler or LocalHandler()
        self.residual: Optional[np.ndarray] = None

    def broadcast_update(self, gradient: np.ndarray) -> int:
        """Accumulate gradient into the residual, encode everything above
        threshold, broadcast. Returns number of encoded elements."""
        flat = np.asarray(gradient, dtype=np.float32).reshape(-1)
        if self.residual is None:
            self.residual = np.zeros_like(flat)
        self.residual += flat
        idx, signs = native.threshold_encode(self.residual, self.threshold)
        if idx.size:
            packed = (idx.astype(np.int64) * 2 + signs).astype(np.int64)
            self.handler.broadcast(packed, self.threshold, flat.size)
        return int(idx.size)


def _unpack(packed: np.ndarray):
    idx = (packed // 2).astype(np.int32)
    signs = (packed % 2).astype(np.uint8)
    return idx, signs


class GradientsAccumulator:
    """Receives encoded peer updates and applies them to local params.

    Reference contract (GradientsAccumulator.java): workers call
    ``store_update`` (via EncodingHandler.broadcast) after each step and
    ``apply_update`` before their next step, folding peers' quantized
    gradients into their own view — allreduce-by-gossip without a barrier.
    """

    def __init__(self, n_params: int):
        self.n_params = int(n_params)
        self._queue: "queue.Queue" = queue.Queue()

    def receive_update(self, packed: np.ndarray, threshold: float,
                       n: int) -> None:
        if n != self.n_params:
            raise ValueError(
                f"update for {n} params, accumulator holds {self.n_params}")
        self._queue.put((packed, float(threshold)))

    def apply_updates(self, target: np.ndarray,
                      scale: float = 1.0) -> int:
        """Drains pending updates into ``target`` (flat float32, in place).
        Returns how many messages were applied."""
        if (not isinstance(target, np.ndarray)
                or target.dtype != np.float32
                or not target.flags["C_CONTIGUOUS"]):
            # reshape(-1) on a non-contiguous view would copy, and the
            # decode would land in the throwaway copy — reject instead.
            raise ValueError("target must be a C-contiguous float32 array")
        applied = 0
        flat = target.reshape(-1)
        while True:
            try:
                packed, threshold = self._queue.get_nowait()
            except queue.Empty:
                return applied
            idx, signs = _unpack(packed)
            native.threshold_decode(flat, threshold * scale, idx, signs)
            applied += 1

    @property
    def pending(self) -> int:
        return self._queue.qsize()


class SharedGradientsExchange:
    """N local workers exchanging threshold-quantized updates — the moral
    equivalent of ParallelWrapper SHARED_GRADIENTS wiring
    (SymmetricTrainer.java:82-84): every worker's broadcast lands in every
    OTHER worker's accumulator."""

    def __init__(self, n_workers: int, n_params: int,
                 threshold: float = 1e-3):
        self.accumulators = [GradientsAccumulator(n_params)
                             for _ in range(n_workers)]
        self.handlers: List[EncodingHandler] = []
        for w in range(n_workers):
            exchange = self

            class _Fanout(MessageHandler):
                def __init__(self, src: int):
                    self.src = src

                def broadcast(self, packed, threshold, n):
                    for j, acc in enumerate(exchange.accumulators):
                        if j != self.src:
                            acc.receive_update(packed, threshold, n)

            self.handlers.append(
                EncodingHandler(threshold, handler=_Fanout(w)))

    def publish(self, worker: int, gradient: np.ndarray) -> int:
        return self.handlers[worker].broadcast_update(gradient)

    def collect(self, worker: int, target: np.ndarray) -> int:
        return self.accumulators[worker].apply_updates(target)
