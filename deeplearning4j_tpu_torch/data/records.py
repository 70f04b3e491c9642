"""Record readers — the DataVec-bridge equivalent (the port's copy of
`deeplearning4j_tpu/data/records.py`, over the port's own `DataSet`,
`MultiDataSet` and `DataSetIterator`). Batches are host numpy arrays;
`fit` moves them to the card. `ImageRecordReader` imports PIL only when
it reads.

Reference parity: DataVec RecordReaders consumed through
`datasets/datavec/RecordReaderDataSetIterator.java`,
`SequenceRecordReaderDataSetIterator.java` (SURVEY §2.2): CSV, CSV
sequences, and images → DataSet batches with label one-hotting.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator


class RecordReader:
    """Reference: DataVec RecordReader — iterable of records (value lists)."""

    def __iter__(self) -> Iterator[List]:
        raise NotImplementedError

    def reset(self):
        pass

    def load_from_meta_data(self, metas) -> List[List]:
        """Re-read the ORIGINAL records behind RecordMetaData entries
        (locations are record indices assigned by the consuming iterator).
        Reference: DataVec `RecordReader.loadFromMetaData` — what powers
        `Prediction.getRecord()`-style 'show me the misclassified
        example' workflows."""
        src = str(getattr(self, "path", type(self).__name__))
        wrong = [m for m in metas if m.source != src]
        if wrong:
            # index-only matching against a DIFFERENT source would silently
            # return unrelated records (DataVec matches by URI)
            raise ValueError(
                f"RecordMetaData source {wrong[0].source!r} does not match "
                f"this reader ({src!r})")
        wanted = {int(m.location) for m in metas}
        found: Dict[int, List] = {}
        for i, rec in enumerate(self):
            if i in wanted:
                found[i] = rec
                if len(found) == len(wanted):
                    break
        missing = wanted - found.keys()
        if missing:
            raise KeyError(
                f"records {sorted(missing)} not found in {self!r}")
        return [found[int(m.location)] for m in metas]


class CSVRecordReader(RecordReader):
    """Reference: DataVec CSVRecordReader."""

    def __init__(self, path: str, *, skip_lines: int = 0,
                 delimiter: str = ","):
        self.path = path
        self.skip = skip_lines
        self.delimiter = delimiter

    def __iter__(self):
        with open(self.path, newline="") as f:
            r = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(r):
                if i < self.skip or not row:
                    continue
                yield row


class CollectionRecordReader(RecordReader):
    """Reference: CollectionRecordReader (in-memory records)."""

    def __init__(self, records: Sequence[Sequence]):
        self.records = [list(r) for r in records]

    def __iter__(self):
        return iter(self.records)


class CSVSequenceRecordReader(RecordReader):
    """One CSV file per sequence in a directory. Reference: DataVec
    CSVSequenceRecordReader."""

    def __init__(self, directory: str, *, skip_lines: int = 0,
                 delimiter: str = ","):
        self.directory = directory
        self.skip = skip_lines
        self.delimiter = delimiter

    def __iter__(self):
        for fn in sorted(os.listdir(self.directory)):
            rows = []
            with open(os.path.join(self.directory, fn), newline="") as f:
                for i, row in enumerate(csv.reader(f, delimiter=self.delimiter)):
                    if i < self.skip or not row:
                        continue
                    rows.append(row)
            yield rows


class ImageRecordReader(RecordReader):
    """Directory-per-class images → (pixels..., label) records.
    Reference: DataVec ImageRecordReader (labels from parent dir)."""

    def __init__(self, root: str, *, height: int, width: int,
                 channels: int = 3):
        self.root = root
        self.h, self.w, self.c = height, width, channels
        self.labels = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))

    def __iter__(self):
        from PIL import Image

        for li, label in enumerate(self.labels):
            d = os.path.join(self.root, label)
            for fn in sorted(os.listdir(d)):
                try:
                    img = Image.open(os.path.join(d, fn))
                except Exception:
                    continue
                img = img.convert("RGB" if self.c == 3 else "L")
                img = img.resize((self.w, self.h))
                arr = np.asarray(img, np.float32) / 255.0
                if self.c == 1:
                    arr = arr[..., None]
                yield [arr, li]


class RecordReaderDataSetIterator(DataSetIterator):
    """Reference: `datasets/datavec/RecordReaderDataSetIterator.java` —
    records → (features, one-hot labels) DataSet batches."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False, collect_meta: bool = False):
        self.reader = reader
        self.bs = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        # remember whether the caller pinned the width: pinned widths are
        # validated in _to_dataset (a corrupt label raises rather than
        # silently widening the one-hot / confusion-matrix width);
        # inferred widths stay sticky-growing
        self._num_classes_pinned = num_classes is not None
        self.regression = regression
        # reference: RecordReaderDataSetIterator.setCollectMetaData(true) —
        # each batch then exposes per-example RecordMetaData via
        # `last_meta` for Evaluation.eval(..., record_meta=...)
        self.collect_meta = collect_meta
        self.last_meta: Optional[list] = None
        self._record_index = 0
        self._it: Optional[Iterator] = None

    def set_collect_meta_data(self, v: bool) -> None:
        """Reference: setCollectMetaData."""
        self.collect_meta = v

    def reset(self):
        self._it = iter(self.reader)
        self._record_index = 0

    def __next__(self) -> DataSet:
        if self._it is None:
            self.reset()
        feats, labs = [], []
        metas = [] if self.collect_meta else None
        if metas is not None:
            from deeplearning4j_tpu_torch.eval.meta import RecordMetaData

            src = str(getattr(self.reader, "path",
                              type(self.reader).__name__))
        for _ in range(self.bs):
            try:
                rec = next(self._it)
            except StopIteration:
                break
            if metas is not None:
                metas.append(RecordMetaData(src, self._record_index))
            self._record_index += 1
            self._append_parsed(rec, feats, labs)
        if not feats:
            self._it = None
            raise StopIteration
        self.last_meta = metas
        return self._to_dataset(feats, labs)

    def _append_parsed(self, rec, feats, labs):
        if isinstance(rec[0], np.ndarray):  # image record
            feats.append(rec[0])
            labs.append(rec[1])
        else:
            vals = [float(v) for v in rec]
            li = self.label_index if self.label_index >= 0 \
                else len(vals) - 1
            labs.append(vals[li])
            feats.append(vals[:li] + vals[li + 1:])

    def _to_dataset(self, feats, labs) -> DataSet:
        x = np.asarray(feats, np.float32)
        if self.regression:
            y = np.asarray(labs, np.float32).reshape(len(labs), -1)
        else:
            idx = np.asarray(labs, np.int64)
            if int(idx.min()) < 0:
                raise ValueError(
                    f"negative class label {int(idx.min())} — labels must "
                    "be non-negative integers")
            if self._num_classes_pinned and int(idx.max()) >= self.num_classes:
                raise ValueError(
                    f"label {int(idx.max())} out of range for the "
                    f"explicitly configured num_classes={self.num_classes}")
            # sticky width: once a class is seen, every later batch (and
            # load_from_meta_data subsets) one-hots to the same width
            n = max(self.num_classes or 0, int(idx.max()) + 1)
            self.num_classes = n
            y = np.eye(n, dtype=np.float32)[idx]
        return DataSet(x, y)

    def load_from_meta_data(self, metas) -> DataSet:
        """Rebuild the exact (features, labels) DataSet for specific
        RecordMetaData entries — e.g. `ev.get_prediction_errors()` →
        inspect the misclassified inputs. Reference:
        `RecordReaderDataSetIterator.loadFromMetaData`."""
        feats, labs = [], []
        for rec in self.reader.load_from_meta_data(metas):
            self._append_parsed(rec, feats, labs)
        return self._to_dataset(feats, labs)

    @property
    def batch_size(self):
        return self.bs


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Reference: SequenceRecordReaderDataSetIterator — per-sequence CSVs →
    padded [batch, time, features] with per-timestep masks."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self.bs = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self._it = None

    def reset(self):
        self._it = iter(self.reader)

    def __next__(self) -> DataSet:
        if self._it is None:
            self.reset()
        seqs = []
        for _ in range(self.bs):
            try:
                seqs.append(next(self._it))
            except StopIteration:
                break
        if not seqs:
            self._it = None
            raise StopIteration
        T = max(len(s) for s in seqs)
        first = seqs[0][0]
        li = self.label_index if self.label_index >= 0 else len(first) - 1
        F = len(first) - 1
        B = len(seqs)
        x = np.zeros((B, T, F), np.float32)
        mask = np.zeros((B, T), np.float32)
        lab_raw = np.zeros((B, T), np.float32)
        for b, s in enumerate(seqs):
            for t, row in enumerate(s):
                vals = [float(v) for v in row]
                lab_raw[b, t] = vals[li]
                x[b, t] = vals[:li] + vals[li + 1:]
                mask[b, t] = 1.0
        if self.regression:
            y = lab_raw[..., None]
        else:
            n = self.num_classes or int(lab_raw.max()) + 1
            y = np.eye(n, dtype=np.float32)[lab_raw.astype(np.int64)]
            y = y * mask[..., None]
        return DataSet(x, y, mask, mask)

    @property
    def batch_size(self):
        return self.bs


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Multi-input/multi-output DataVec bridge — flexible column mappings
    from one or more readers into MultiDataSet batches. Reference:
    `datasets/datavec/RecordReaderMultiDataSetIterator.java` (Builder:
    addReader / addInput(reader, from, to) / addOutput /
    addOutputOneHot), the iterator ComputationGraph training feeds from.

    Usage (builder-style, mirroring the reference):
        it = (RecordReaderMultiDataSetIterator.builder(batch_size)
              .add_reader("csv", reader)
              .add_input("csv", 0, 3)           # columns 0..3 inclusive
              .add_output_one_hot("csv", 4, 3)  # column 4 as 3-class 1-hot
              .build())
    """

    def __init__(self, batch_size: int, readers, inputs, outputs):
        self.bs = batch_size
        self._readers = readers      # name -> RecordReader
        self._inputs = inputs        # list of (reader, lo, hi)
        self._outputs = outputs      # list of (reader, lo, hi, one_hot_n)
        self._its: Optional[Dict[str, Iterator]] = None

    # ------------------------------------------------------------ builder
    class Builder:
        def __init__(self, batch_size: int):
            self._bs = batch_size
            self._readers: Dict[str, RecordReader] = {}
            self._inputs = []
            self._outputs = []

        def add_reader(self, name: str, reader: RecordReader):
            self._readers[name] = reader
            return self

        def add_input(self, reader: str, col_from: int, col_to: int):
            self._inputs.append((reader, col_from, col_to, None))
            return self

        def add_output(self, reader: str, col_from: int, col_to: int):
            self._outputs.append((reader, col_from, col_to, None))
            return self

        def add_output_one_hot(self, reader: str, column: int,
                               num_classes: int):
            self._outputs.append((reader, column, column, num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            if not self._readers or not self._inputs:
                raise ValueError("need at least one reader and one input")
            for reader, *_ in self._inputs + self._outputs:
                if reader not in self._readers:
                    raise ValueError(f"unknown reader {reader!r}")
            return RecordReaderMultiDataSetIterator(
                self._bs, self._readers, self._inputs, self._outputs)

    @staticmethod
    def builder(batch_size: int) -> "RecordReaderMultiDataSetIterator.Builder":
        return RecordReaderMultiDataSetIterator.Builder(batch_size)

    # ----------------------------------------------------------- iterate
    def reset(self):
        self._its = {n: iter(r) for n, r in self._readers.items()}

    def __next__(self):
        from deeplearning4j_tpu_torch.data.dataset import MultiDataSet

        if self._its is None:
            self.reset()
        rows: Dict[str, list] = {n: [] for n in self._readers}
        for _ in range(self.bs):
            batch_row = {}
            try:
                for n, it in self._its.items():
                    batch_row[n] = list(next(it))   # raw values; only
                    # MAPPED columns get converted (mixed-type CSVs with
                    # unmapped string columns must work, like DataVec)
            except StopIteration:
                break    # readers must align; stop at the shortest
            for n, vals in batch_row.items():
                rows[n].append(vals)
        if not next(iter(rows.values())):
            self._its = None
            raise StopIteration

        # validate mapped ranges against the actual record width ONCE per
        # batch — Python slices would silently truncate out-of-range cols
        for reader, lo, hi, _ in self._inputs + self._outputs:
            width = len(rows[reader][0])
            if lo < 0 or hi >= width:
                raise ValueError(
                    f"column range [{lo}, {hi}] out of bounds for reader "
                    f"{reader!r} records of width {width}")

        def slab(spec):
            reader, lo, hi, one_hot = spec
            arr = np.asarray(
                [[float(v) for v in r[lo:hi + 1]] for r in rows[reader]],
                np.float32)
            if one_hot:
                idx = arr[:, 0].astype(np.int64)
                if ((idx < 0) | (idx >= one_hot)).any():
                    raise ValueError(
                        f"one-hot column {lo} of reader {reader!r} has "
                        f"labels outside [0, {one_hot})")
                arr = np.eye(one_hot, dtype=np.float32)[idx]
            return arr

        feats = [slab(s) for s in self._inputs]
        labs = [slab(s) for s in self._outputs]
        return MultiDataSet(feats, labs)

    @property
    def batch_size(self):
        return self.bs
