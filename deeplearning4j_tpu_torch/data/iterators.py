"""DataSet iterators — port of the training half of
`deeplearning4j_tpu/data/iterators.py`: the base protocol,
`ArrayDataSetIterator`, `IterableDataSetIterator`, `as_iterator`, and
`DevicePrefetchIterator`, which moves each batch to the net's device one
batch ahead of the step that consumes it.

The device copy is a `non_blocking` copy from pinned host memory on the
current stream, so the host enqueues batch N+1's transfer while batch
N's step is still running and never waits for it. (JAX's iterator
relies on async `device_put`; a copy on a side stream of its own, and
the background-thread `AsyncDataSetIterator`, come later.)
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


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
    """Run one batch ahead of the consumer: when batch N is handed out,
    batch N+1 is fetched and moved to the device by `put(ds) -> ds`.

    Only the host's work is ahead. The `non_blocking` copy is issued on
    the current stream, before step N's kernels are enqueued, so on the
    device it runs in stream order ahead of step N and does not overlap
    its compute; that overlap needs the side-stream copy (ROADMAP A1)."""

    def __init__(self, base: DataSetIterator, put: Callable):
        self._base = base
        self._put = put
        self._inner: Optional[Iterator] = None
        self._next: Optional[DataSet] = None

    def reset(self):
        self._inner = iter(self._base)
        self._next = None
        self._fetch()

    def _fetch(self):
        try:
            self._next = self._put(next(self._inner))
        except StopIteration:
            self._next = None

    def __next__(self):
        if self._inner is None:
            self.reset()
        item = self._next
        if item is None:
            raise StopIteration
        self._fetch()      # enqueue the next batch's copy right away
        return item

    @property
    def batch_size(self):
        return self._base.batch_size

    @property
    def num_outcomes(self):
        return self._base.num_outcomes


def as_iterator(data, labels=None, batch_size: int = 32) -> DataSetIterator:
    """Coerce arrays / a DataSet / an iterable of DataSets / an iterator
    into a DataSetIterator."""
    if isinstance(data, DataSetIterator):
        return data
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
