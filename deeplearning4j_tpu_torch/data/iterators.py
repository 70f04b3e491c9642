"""DataSet iterators — port of `deeplearning4j_tpu/data/iterators.py`:
the base protocol, `ArrayDataSetIterator`, `IterableDataSetIterator`,
`as_iterator`, `DevicePrefetchIterator`, which keeps `depth` batches'
copies to the net's device in flight ahead of the step that consumes
them, the background-thread `AsyncDataSetIterator` (DL4J's, which
`MultiLayerNetwork.fit` wraps around its iterator), and the decorators
`MultipleEpochsIterator`, `EarlyTerminationDataSetIterator`,
`BenchmarkDataSetIterator` and `FileSplitDataSetIterator`. The
prefetching iterators carry `MultiDataSet` batches as well as
`DataSet`s.

On a CUDA device each copy is a `non_blocking` copy from pinned host
memory on a side stream of the iterator's own, so the copy of batch N+1
overlaps step N's kernels; the consumer's stream waits on the copy's
event only when it takes the batch.

The two compose: `AsyncDataSetIterator` hides host-side ETL (decoding,
collation) on its thread, `DevicePrefetchIterator` the copy. The async
pump thread makes no CUDA call at all (no pinning, no copy, no tensor on
the card): under `fit(steps_per_dispatch=K)` the main thread captures
CUDA graphs, and a CUDA call from another thread during a capture
invalidates it.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.observe import get_registry


class DataSetIterator:
    """Base protocol: a Python iterable with reset()."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        raise StopIteration

    def reset(self) -> None:
        pass

    @property
    def batch_size(self) -> Optional[int]:
        return None

    @property
    def num_outcomes(self) -> Optional[int]:
        return None

    def async_(self, prefetch: int = 2) -> "AsyncDataSetIterator":
        return AsyncDataSetIterator(self, prefetch)


class ArrayDataSetIterator(DataSetIterator):
    """Batches over in-memory arrays."""

    def __init__(self, features, labels=None, batch_size: int = 32,
                 features_mask=None, labels_mask=None,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self._data = DataSet(
            np.asarray(features),
            None if labels is None else np.asarray(labels),
            features_mask, labels_mask)
        self._bs = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._drop_last = drop_last
        self._pos = 0
        self._cur = self._data

    def reset(self):
        self._pos = 0
        if self._shuffle:
            self._cur = self._data.shuffle(self._seed + self._epoch)
            self._epoch += 1

    def __next__(self) -> DataSet:
        n = self._cur.num_examples()
        if self._pos >= n:
            raise StopIteration
        hi = min(self._pos + self._bs, n)
        if self._drop_last and hi - self._pos < self._bs:
            raise StopIteration
        lo = self._pos
        sl = lambda a: None if a is None else a[lo:hi]  # noqa: E731
        d = DataSet(self._cur.features[lo:hi], sl(self._cur.labels),
                    sl(self._cur.features_mask), sl(self._cur.labels_mask))
        self._pos = hi
        return d

    @property
    def batch_size(self):
        return self._bs

    @property
    def num_outcomes(self):
        if self._data.labels is not None and self._data.labels.ndim >= 2:
            return int(self._data.labels.shape[-1])
        return None


class IterableDataSetIterator(DataSetIterator):
    """Any Python iterable of DataSet batches as a DataSetIterator.
    Re-iterables get a fresh `iter()` every reset; a one-shot iterator is
    recorded on its first pass and replayed on later ones."""

    def __init__(self, source):
        self._replay = isinstance(source, Iterator)
        self._source = iter(source) if self._replay else source
        self._cache: List = []
        self._first_pass = True
        self._inner: Optional[Iterator] = None

    def reset(self):
        if self._replay:
            self._inner = (self._source if self._first_pass
                           else iter(self._cache))
        else:
            self._inner = iter(self._source)

    def __next__(self):
        if self._inner is None:
            self.reset()
        try:
            item = next(self._inner)
        except StopIteration:
            if self._replay and self._first_pass:
                self._first_pass = False
            raise
        if self._replay and self._first_pass:
            self._cache.append(item)
        return item


class DevicePrefetchIterator(DataSetIterator):
    """Run `depth` batches ahead of the consumer: each batch is fetched
    and moved to the device by `put(ds) -> ds` as soon as a place in the
    buffer frees (JAX's `depth=max(2, K)` under `fit(steps_per_dispatch=
    K)`).

    With a CUDA `device`, `put` runs on the iterator's side stream, and
    an event recorded after it is waited on by the consumer's stream when
    the batch is handed out; each tensor of the batch is marked used on
    that stream (`record_stream`), so the allocator does not hand its
    memory back to the side stream early. Counters (stage "device"):
    `prefetch_hits_total` (the batch was in the buffer when asked for),
    `prefetch_misses_total` (it was fetched in line) and
    `etl_batches_total`."""

    def __init__(self, base: DataSetIterator, put: Callable,
                 depth: int = 2, device=None):
        self._base = base
        self._put = put
        self._depth = max(1, int(depth))
        self._device = None if device is None else torch.device(device)
        self._stream = None
        self._inner: Optional[Iterator] = None
        self._buf: collections.deque = collections.deque()
        self._exhausted = False
        self._pending: Optional[BaseException] = None
        reg = get_registry()
        self._m_hits = reg.counter("prefetch_hits_total", stage="device")
        self._m_misses = reg.counter("prefetch_misses_total",
                                     stage="device")
        self._m_batches = reg.counter("etl_batches_total", stage="device")

    def reset(self):
        self._inner = iter(self._base)
        self._buf.clear()
        self._exhausted = False
        self._pending = None

    def _copy(self, ds: DataSet):
        """(batch on the device, its copy's event or None)."""
        dev = self._device
        if dev is None or dev.type != "cuda":
            return self._put(ds), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            out = self._put(ds)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return out, ev

    def _fill(self):
        while (not self._exhausted and self._pending is None
               and len(self._buf) < self._depth):
            try:
                self._buf.append(self._copy(next(self._inner)))
            except StopIteration:
                self._exhausted = True
            except BaseException as e:
                # a failed fetch AHEAD must not poison the batches in
                # hand: the error is raised when the consumer reaches its
                # position (a resume cursor then counts every batch that
                # trained), as in the JAX package
                self._pending = e

    def __next__(self):
        if self._inner is None:
            self.reset()
        ready = bool(self._buf)
        self._fill()
        if not self._buf:
            if self._pending is not None:
                e, self._pending = self._pending, None
                raise e
            raise StopIteration
        (self._m_hits if ready else self._m_misses).inc()
        self._m_batches.inc()
        item, ev = self._buf.popleft()
        if ev is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ev)
            for t in _batch_tensors(item):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(cur)
        self._fill()      # enqueue the replacement copy right away
        return item

    @property
    def batch_size(self):
        return self._base.batch_size

    @property
    def num_outcomes(self):
        return self._base.num_outcomes


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (reference: `AsyncDataSetIterator.java`): a
    pump thread iterates `base` and keeps up to `prefetch` batches in a
    queue ahead of the consumer. The pump is stop-aware (a `reset()` or
    `close()` stops it and it exits instead of blocking on a full queue;
    `reset()` joins it before the next pump touches `base`), always ends
    its pass with a sentinel, and an error it raises reaches the
    consumer on its next batch, before any batch still buffered (fail
    fast: no silently truncated epoch). `close()` (or leaving a `with`
    block) stops the pump and joins it.

    The pump only calls `base`'s iteration: it must yield host batches
    (numpy), as every dataset iterator of the port does; the copy to the
    card happens in the consumer's thread (`DevicePrefetchIterator`).
    Counters (stage "async"): `etl_batches_total`, `prefetch_hits_total`
    (a batch was waiting in the queue), `prefetch_misses_total` (the
    consumer waited for the pump) and the gauge
    `prefetch_queue_depth`."""

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, prefetch: int = 2):
        self._base = base
        self._prefetch = prefetch
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stop: Optional[threading.Event] = None
        reg = get_registry()
        self._m_batches = reg.counter("etl_batches_total", stage="async")
        self._m_hits = reg.counter("prefetch_hits_total", stage="async")
        self._m_misses = reg.counter("prefetch_misses_total", stage="async")
        self._m_depth = reg.gauge("prefetch_queue_depth", stage="async")

    def _put(self, q: queue.Queue, stop: threading.Event, item) -> bool:
        """A bounded put that gives up when `stop` is set."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _pump(self, q: queue.Queue, stop: threading.Event):
        try:
            for d in self._base:
                if not self._put(q, stop, d):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
        finally:
            # the sentinel must reach the consumer, or it waits forever
            self._put(q, stop, self._SENTINEL)

    def reset(self):
        # the previous pump is stopped and joined before a new one starts:
        # both would iterate the one `base`, and an orphaned pump could
        # take a batch of the new pass and drop it (`for ds in
        # iter(iterable)` resets twice before its first batch)
        self.close(timeout=None)
        self._queue = queue.Queue(maxsize=self._prefetch + 1)  # + sentinel
        self._error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._pump, args=(self._queue, self._stop), daemon=True,
            name="async-dataset-pump")
        self._thread.start()

    def __next__(self) -> DataSet:
        if self._queue is None:
            self.reset()
        if self._error is not None:
            err, self._error = self._error, None
            self.close()
            raise err
        # non-empty before the get: the pump stayed ahead (a hit)
        depth = self._queue.qsize()
        self._m_depth.set(depth)
        item = self._queue.get()
        if item is self._SENTINEL:
            self._queue = None
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise StopIteration
        (self._m_hits if depth > 0 else self._m_misses).inc()
        self._m_batches.inc()
        return item

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Stop the pump and join its thread (waiting at most `timeout`
        seconds; `reset` waits as long as it takes); safe to call
        twice."""
        if self._stop is not None:
            self._stop.set()
        q, t = self._queue, self._thread
        if q is not None:
            # drain, so a pump blocked on a full queue sees the stop
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
        self._queue = None
        self._thread = None

    def __enter__(self) -> "AsyncDataSetIterator":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    @property
    def batch_size(self):
        return self._base.batch_size

    @property
    def num_outcomes(self):
        return self._base.num_outcomes


class MultipleEpochsIterator(DataSetIterator):
    """`base` repeated `epochs` times as one pass (reference:
    `MultipleEpochsIterator`)."""

    def __init__(self, base: DataSetIterator, epochs: int):
        self._base = base
        self._epochs = epochs
        self._epoch = 0
        self._inner: Optional[Iterator] = None

    def reset(self):
        self._epoch = 0
        self._inner = iter(self._base)

    def __next__(self) -> DataSet:
        if self._inner is None:
            self.reset()
        while True:
            try:
                return next(self._inner)
            except StopIteration:
                self._epoch += 1
                if self._epoch >= self._epochs:
                    raise
                self._inner = iter(self._base)


class EarlyTerminationDataSetIterator(DataSetIterator):
    """At most `max_batches` batches of `base` a pass (reference:
    `EarlyTerminationDataSetIterator`)."""

    def __init__(self, base: DataSetIterator, max_batches: int):
        self._base = base
        self._max = max_batches
        self._count = 0
        self._inner: Optional[Iterator] = None

    def reset(self):
        self._count = 0
        self._inner = iter(self._base)

    def __next__(self) -> DataSet:
        if self._inner is None:
            self.reset()
        if self._count >= self._max:
            raise StopIteration
        self._count += 1
        return next(self._inner)


class BenchmarkDataSetIterator(DataSetIterator):
    """The same synthetic batch `num_batches` times, for throughput
    measurement (reference: `BenchmarkDataSetIterator`): features
    standard normal of `feature_shape` (its first axis the batch),
    one-hot labels over `num_classes` unless `label_shape` asks for
    normal ones; numpy draws from `seed`, as the JAX package's."""

    def __init__(self, feature_shape, num_classes: int, num_batches: int,
                 seed: int = 0, label_shape=None):
        rng = np.random.default_rng(seed)
        self._features = rng.standard_normal(feature_shape, dtype=np.float32)
        b = feature_shape[0]
        if label_shape is None:
            labels = np.zeros((b, num_classes), dtype=np.float32)
            labels[np.arange(b), rng.integers(0, num_classes, b)] = 1.0
        else:
            labels = rng.standard_normal(label_shape).astype(np.float32)
        self._labels = labels
        self._n = num_batches
        self._i = 0

    def reset(self):
        self._i = 0

    def __next__(self) -> DataSet:
        if self._i >= self._n:
            raise StopIteration
        self._i += 1
        return DataSet(self._features, self._labels)

    @property
    def batch_size(self):
        return int(self._features.shape[0])

    @property
    def num_outcomes(self):
        return int(self._labels.shape[-1])


class FileSplitDataSetIterator(DataSetIterator):
    """One saved DataSet file a batch (reference:
    `FileSplitDataSetIterator`): `files` is an iterable of paths or a
    directory (its `*.npz`, sorted); `loader` defaults to
    `DataSet.load`."""

    def __init__(self, files, loader=None):
        if isinstance(files, (str, os.PathLike)):
            d = os.fspath(files)
            self.files = [os.path.join(d, n) for n in sorted(os.listdir(d))
                          if n.endswith(".npz")]
        else:
            self.files = [os.fspath(f) for f in files]
        if not self.files:
            raise ValueError("FileSplitDataSetIterator: no files")
        self.loader = loader or DataSet.load
        self._i = 0

    def reset(self):
        self._i = 0

    def __next__(self):
        if self._i >= len(self.files):
            raise StopIteration
        ds = self.loader(self.files[self._i])
        self._i += 1
        return ds


def _batch_tensors(ds) -> list:
    """Every array of a DataSet or MultiDataSet (None where absent)."""
    if isinstance(ds, MultiDataSet):
        return [*ds.features, *ds.labels, *(ds.features_masks or ()),
                *(ds.labels_masks or ())]
    return [ds.features, ds.labels, ds.features_mask, ds.labels_mask]


def as_iterator(data, labels=None, batch_size: int = 32) -> DataSetIterator:
    """Coerce arrays / a DataSet / a MultiDataSet (one batch) / an
    iterable of DataSets or MultiDataSets / an iterator into a
    DataSetIterator."""
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, MultiDataSet):
        return IterableDataSetIterator([data])
    if isinstance(data, DataSet):
        return ArrayDataSetIterator(data.features, data.labels, batch_size,
                                    data.features_mask, data.labels_mask)
    if labels is None and _is_dataset_iterable(data):
        return IterableDataSetIterator(data)
    return ArrayDataSetIterator(data, labels, batch_size)


def _is_dataset_iterable(data) -> bool:
    if isinstance(data, Iterator):
        return True
    if isinstance(data, np.ndarray) or hasattr(data, "shape"):
        return False
    if isinstance(data, (list, tuple)):
        return bool(data) and hasattr(data[0], "features")
    return hasattr(data, "__iter__")
