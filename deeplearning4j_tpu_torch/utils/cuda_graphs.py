"""CUDA graphs of the port's hot calls: the counterpart of one XLA
dispatch of the JAX package. `fit(steps_per_dispatch=K)`'s K train
steps, a serving decode window and an `rnn_time_step` call each go
through `NetGraphs.run`:

- the call's inputs are copied into static buffers made on its key's
  first call (a list of tensors is stacked into one [len, ...] buffer);
- on a CUDA device the first call of a key runs the function eagerly on
  the net's capture stream (a real call, and the warm-up capture needs),
  then captures it into the memory pool that the net's graphs share;
  later calls replay the graph. Capture itself runs nothing, so it does
  not advance the net's state;
- every output is cloned before it leaves the call, so an output a
  caller keeps never shows a later replay's values;
- a replay adds to the kernels' launch counts (`ops/*.LAUNCHES`, ...)
  what capture added to them: the counts are host bookkeeping, which a
  replay does not run.

A key's entry also holds the addresses of the tensors its function
reads in place (parameters, optimizer state, KV caches): a call whose
addresses differ drops the entry and captures anew rather than replay
a graph over freed memory.

On the CPU there are no graphs: the same static buffers are filled and
the function is called on them directly, so an output that aliases a
static buffer shows in a CPU test as it would on the card. A capture
that fails raises; nothing falls back to an eager call.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Hashable, List, Sequence

import torch

_COUNTS = ("LAUNCHES", "LAUNCHES_BY_DESIGN", "PLAIN_ON_CUDA")


def _count_dicts() -> List[dict]:
    from deeplearning4j_tpu_torch.ops import (
        attention, banded_attention, conv_fused, fused_update, lstm,
    )

    return [getattr(m, n) for m in (attention, banded_attention, conv_fused,
                                    fused_update, lstm)
            for n in _COUNTS if hasattr(m, n)]


def _tree_map(fn: Callable, tree):
    """Map `fn` over the tensors of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_clone(tree):
    return _tree_map(torch.Tensor.clone, tree)


def _static_like(a):
    """A static buffer for input `a`: a list of tensors is stacked."""
    if isinstance(a, list):
        return torch.empty((len(a), *a[0].shape), dtype=a[0].dtype,
                           device=a[0].device)
    if isinstance(a, dict):
        return {k: _static_like(v) for k, v in a.items()}
    if isinstance(a, tuple):
        return tuple(_static_like(v) for v in a)
    return None if a is None else torch.empty_like(a)


def _fill(static, a) -> None:
    if isinstance(a, list):
        torch.stack(a, out=static)
    elif isinstance(a, dict):
        for k in a:
            _fill(static[k], a[k])
    elif isinstance(a, tuple):
        for s, v in zip(static, a):
            _fill(s, v)
    elif a is not None and a is not static:
        static.copy_(a, non_blocking=True)


def _layout(a):
    """The shapes and dtypes of an input: part of every key."""
    if isinstance(a, list):
        return (len(a), _layout(a[0]))
    if isinstance(a, dict):
        return tuple(sorted((k, _layout(v)) for k, v in a.items()))
    if isinstance(a, tuple):
        return tuple(_layout(v) for v in a)
    return None if a is None else (tuple(a.shape), str(a.dtype))


class _Entry:
    __slots__ = ("static", "addresses", "graph", "out", "counts")

    def __init__(self, static, addresses):
        self.static = static
        self.addresses = addresses
        self.graph = None
        self.out = None
        self.counts: List[Dict[Any, int]] = []


class NetGraphs:
    """One net's graphs: a capture stream and a memory pool shared by all
    of them (made on a capture when no other graph lives), the entries by
    key, the counts by kind (a key's first element): `replays`, `eager`
    calls (warm-ups, and every call on the CPU), `captures`,
    `capture_ms`; and whether the latest call was a replay
    (`replayed`)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._entries: Dict[Hashable, _Entry] = {}
        self._stream = None
        self._pool = None
        self.last_key = None
        self.replayed = False
        self.stats: Dict[str, Dict[str, float]] = {}

    def _stat(self, key) -> Dict[str, float]:
        return self.stats.setdefault(key[0], {"replays": 0, "eager": 0,
                                              "captures": 0,
                                              "capture_ms": 0.0})

    def inputs(self, key):
        """The static buffers of `key`'s entry (`last_key`: the full key
        of the latest call)."""
        return self._entries[key].static

    def clear(self) -> None:
        self._entries.clear()

    def run(self, key: Hashable, fn: Callable, inputs: Sequence, *,
            addresses: tuple = (), generators: Sequence = ()):
        """`fn(*static)` over static copies of `inputs`, the graph of it
        on the card; returns clones of its outputs. `key` must fix every
        shape and dtype `fn` sees (the inputs' layout is added to it);
        `addresses` are the data pointers `fn` reads in place;
        `generators` the non-default CUDA generators `fn` draws from."""
        key = self.last_key = (*key, _layout(tuple(inputs)))
        e = self._entries.get(key)
        if e is not None and e.addresses != addresses:
            del self._entries[key]
            e = None
        if e is None:
            e = _Entry(_static_like(tuple(inputs)), addresses)
            self._entries[key] = e
        _fill(e.static, tuple(inputs))
        st = self._stat(key)
        self.replayed = False
        if self.device.type != "cuda":
            st["eager"] += 1
            return tree_clone(fn(*e.static))
        if e.graph is None:
            try:
                return self._warm_and_capture(e, fn, generators, st)
            except BaseException:
                del self._entries[key]
                raise
        e.graph.replay()
        for d, delta in zip(_count_dicts(), e.counts):
            for k, v in delta.items():
                d[k] += v
        st["replays"] += 1
        self.replayed = True
        return tree_clone(e.out)

    def _warm_and_capture(self, e: _Entry, fn, generators, st):
        cur = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if not any(x.graph is not None for x in self._entries.values()):
            # a pool lives as long as a graph uses it: once the last one
            # is dropped, its handle may not be captured into again
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = tree_clone(fn(*e.static))        # the eager warm-up
            st["eager"] += 1
            t0 = time.perf_counter()
            dicts = _count_dicts()
            before = [dict(d) for d in dicts]
            g = torch.cuda.CUDAGraph()
            for gen in generators:
                g.register_generator_state(gen)
            # no cyclic collection while capturing: freeing a dead net's
            # graph there is refused by CUDA and invalidates the capture
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(g, pool=self._pool, stream=side,
                                      capture_error_mode="thread_local"):
                    e.out = fn(*e.static)
            finally:
                if gc_on:
                    gc.enable()
                # capture launched nothing: its counts belong to replays
                e.counts = [{k: d[k] - b.get(k, 0) for k in d
                             if d[k] != b.get(k, 0)}
                            for d, b in zip(dicts, before)]
                for d, b in zip(dicts, before):
                    d.update(b)
        cur.wait_stream(side)
        _tree_map(lambda t: t.record_stream(cur), out)
        e.graph = g
        st["captures"] += 1
        st["capture_ms"] += (time.perf_counter() - t0) * 1e3
        return out
