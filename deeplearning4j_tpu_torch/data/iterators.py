"""DataSet iterators — port of the training half of
`deeplearning4j_tpu/data/iterators.py`: the base protocol,
`ArrayDataSetIterator`, `IterableDataSetIterator`, `as_iterator`, and
`DevicePrefetchIterator`, which keeps `depth` batches' copies to the
net's device in flight ahead of the step that consumes them. The last
three carry `MultiDataSet` batches as well as `DataSet`s.

On a CUDA device each copy is a `non_blocking` copy from pinned host
memory on a side stream of the iterator's own, so the copy of batch N+1
overlaps step N's kernels; the consumer's stream waits on the copy's
event only when it takes the batch. (The background-thread
`AsyncDataSetIterator` comes later.)
"""

from __future__ import annotations

import collections
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
        reg = get_registry()
        self._m_hits = reg.counter("prefetch_hits_total", stage="device")
        self._m_misses = reg.counter("prefetch_misses_total",
                                     stage="device")
        self._m_batches = reg.counter("etl_batches_total", stage="device")

    def reset(self):
        self._inner = iter(self._base)
        self._buf.clear()
        self._exhausted = False

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
        while not self._exhausted and len(self._buf) < self._depth:
            try:
                self._buf.append(self._copy(next(self._inner)))
            except StopIteration:
                self._exhausted = True

    def __next__(self):
        if self._inner is None:
            self.reset()
        ready = bool(self._buf)
        self._fill()
        if not self._buf:
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
