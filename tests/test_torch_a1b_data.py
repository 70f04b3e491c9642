"""The port's data plumbing of DL4J's fit path against the JAX
package's, on the CPU: `AsyncDataSetIterator` (order, reset, an error
surfaced before buffered batches, the pump joined on `close()`, its
counters, composed with `fit` and `DevicePrefetchIterator`), the
decorator iterators, `DataSet.save` / `FileSplitDataSetIterator`, the
record readers on temporary CSV files (PNG images only where PIL is
installed), `InMemoryBroker` streaming, and the time sources against a
UDP responder on 127.0.0.1. Every batch is compared bit for bit with the
JAX package's."""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.data import iterators as jit
from deeplearning4j_tpu.data import records as jrec
from deeplearning4j_tpu.data import streaming as jstr
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu_torch.data import iterators as pit
from deeplearning4j_tpu_torch.data import records as prec
from deeplearning4j_tpu_torch.data import streaming as pstr
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.observe import get_registry
from deeplearning4j_tpu_torch.utils import timesource as pts


def _same(pb, jb):
    """Two lists of batches (DataSet or MultiDataSet) bit for bit."""
    assert len(pb) == len(jb)
    for p, j in zip(pb, jb):
        for a, b in ((p.features, j.features), (p.labels, j.labels),
                     (getattr(p, "features_mask", None),
                      getattr(j, "features_mask", None))):
            if isinstance(a, list):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            elif a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)


def _arrays(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3)).astype(np.float32), \
        np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]


# ------------------------------------------------------------ async
def test_async_iterator_order_reset_counters_and_close():
    x, y = _arrays()
    reg = get_registry()
    batches = reg.counter("etl_batches_total", stage="async")
    hits = reg.counter("prefetch_hits_total", stage="async")
    misses = reg.counter("prefetch_misses_total", stage="async")
    b0, h0, m0 = batches.value, hits.value, misses.value
    with pit.AsyncDataSetIterator(pit.ArrayDataSetIterator(x, y, 3),
                                  prefetch=2) as it:
        for _ in range(2):       # two epochs: reset restarts the pump
            _same(list(it), list(jit.ArrayDataSetIterator(x, y, 3)))
        assert it.batch_size == 3 and it.num_outcomes == 2
        thread = it._thread
        next(iter(it))           # a pass left half read
    assert it._thread is None and not thread.is_alive()
    assert batches.value - b0 == 9
    assert (hits.value - h0) + (misses.value - m0) == 9
    assert pit.ArrayDataSetIterator(x, y, 3).async_(4)._prefetch == 4


def test_async_iterator_reset_twice_loses_no_batch():
    """`for ds in iter(iterable)` (the fit loop) resets the iterator
    twice before its first batch. The second reset joins the first pump
    before a new one touches the shared base, so no batch of the pass is
    taken and dropped by an orphaned pump, and every pass equals the
    bare shuffled iterator's (ROADMAP C11: JAX's pump drops one)."""
    x = np.arange(512 * 4, dtype=np.float32).reshape(512, 4)
    for trial in range(10):
        bare = pit.ArrayDataSetIterator(x, x, 64, shuffle=True, seed=trial)
        it = pit.AsyncDataSetIterator(
            pit.ArrayDataSetIterator(x, x, 64, shuffle=True, seed=trial),
            prefetch=2)
        for _ in range(3):
            _same(list(iter(iter(it))), list(iter(iter(bare))))
        it.close()


class _Failing(pit.DataSetIterator):
    def __init__(self, good):
        self.good = good

    def reset(self):
        self.i = 0

    def __next__(self):
        self.i += 1
        if self.i > self.good:
            raise RuntimeError("etl broke")
        return DataSet(np.zeros((1, 2), np.float32))


def test_async_iterator_surfaces_pump_errors_first():
    it = pit.AsyncDataSetIterator(_Failing(3), prefetch=4)
    it.reset()
    deadline = time.time() + 5
    while it._error is None and time.time() < deadline:
        time.sleep(0.01)
    # the pump died with 3 batches still buffered: the error comes first
    with pytest.raises(RuntimeError, match="etl broke"):
        next(it)
    assert it._thread is None
    got = []
    with pytest.raises(RuntimeError, match="etl broke"):
        for ds in pit.AsyncDataSetIterator(_Failing(2), prefetch=1):
            got.append(ds)
    assert len(got) <= 2


def test_async_iterator_close_joins_a_blocked_pump():
    x, y = _arrays(40)
    it = pit.AsyncDataSetIterator(pit.ArrayDataSetIterator(x, y, 1),
                                  prefetch=1)
    next(iter(it))
    time.sleep(0.1)              # the pump now waits on a full queue
    t = it._thread
    it.close()
    it.close()
    assert not t.is_alive()
    assert not [th for th in threading.enumerate()
                if th.name == "async-dataset-pump" and th is t]


def test_async_iterator_feeds_fit_like_the_bare_iterator():
    """`fit` through the async pump and the device prefetch takes the
    same batches in the same order: the same weights bit for bit."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(4).updater(Adam(1e-2))
            .list(DenseLayer(n_out=4, activation="tanh"),
                  OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(3)).build())
    x, y = _arrays(24, 5)
    nets = []
    for wrap in (lambda b: b, lambda b: pit.AsyncDataSetIterator(b, 2)):
        for k in (1, 4):
            net = MultiLayerNetwork(conf, device="cpu").init()
            net.fit(wrap(pit.ArrayDataSetIterator(x, y, 4)), epochs=2,
                    steps_per_dispatch=k)
            nets.append(net)
    for net in nets[1:]:
        assert net.iteration == 12
        assert np.array_equal(net.params().numpy(), nets[0].params().numpy())


# ------------------------------------------------------- decorators
def test_multiple_epochs_early_termination_and_benchmark_match_jax():
    x, y = _arrays(7, 1)

    def both(make):
        return (list(make(pit, pit.ArrayDataSetIterator(x, y, 3))),
                list(make(jit, jit.ArrayDataSetIterator(x, y, 3))))

    p, j = both(lambda m, b: m.MultipleEpochsIterator(b, 3))
    assert len(p) == 9
    _same(p, j)
    p, j = both(lambda m, b: m.EarlyTerminationDataSetIterator(b, 2))
    assert len(p) == 2
    _same(p, j)
    pb = pit.BenchmarkDataSetIterator((5, 4), 3, 4, seed=2)
    jb = jit.BenchmarkDataSetIterator((5, 4), 3, 4, seed=2)
    _same(list(pb), list(jb))
    assert (pb.batch_size, pb.num_outcomes) == (5, 3)
    _same(list(pit.BenchmarkDataSetIterator((2, 3), 0, 2, label_shape=(2, 6))),
          list(jit.BenchmarkDataSetIterator((2, 3), 0, 2, label_shape=(2, 6))))


def test_dataset_files_and_file_split_iterator(tmp_path):
    x, y = _arrays(6, 2)
    paths = []
    for i in range(3):
        m = np.ones((2, 3), np.float32) if i == 1 else None
        paths.append(DataSet(x[2 * i:2 * i + 2], y[2 * i:2 * i + 2],
                             m).save(tmp_path / f"b{i}"))
    assert all(p.endswith(".npz") for p in paths)
    j = JaxDataSet.load(paths[1])
    np.testing.assert_array_equal(j.features_mask, np.ones((2, 3)))
    p_it = pit.FileSplitDataSetIterator(tmp_path)
    _same(list(p_it), list(jit.FileSplitDataSetIterator(str(tmp_path))))
    _same(list(p_it), list(pit.FileSplitDataSetIterator(paths)))
    with pytest.raises(ValueError, match="no files"):
        pit.FileSplitDataSetIterator([])


# ---------------------------------------------------------- records
def _csv(path, rows):
    path.write_text("\n".join(",".join(str(v) for v in r) for r in rows))
    return str(path)


def test_record_readers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    rows = [[*np.round(rng.standard_normal(3), 4), int(c)]
            for c in rng.integers(0, 3, 11)]
    path = _csv(tmp_path / "d.csv", [["a", "b", "c", "label"]] + rows)
    for kw in (dict(), dict(regression=True), dict(num_classes=4),
               dict(label_index=1, regression=True)):
        p = prec.RecordReaderDataSetIterator(
            prec.CSVRecordReader(path, skip_lines=1), 4, **kw)
        j = jrec.RecordReaderDataSetIterator(
            jrec.CSVRecordReader(path, skip_lines=1), 4, **kw)
        _same(list(p), list(j))
    it = prec.RecordReaderDataSetIterator(
        prec.CollectionRecordReader(rows), 5, collect_meta=True)
    first = next(iter(it))
    assert [m.location for m in it.last_meta] == [0, 1, 2, 3, 4]
    back = it.load_from_meta_data(it.last_meta[1:3])
    np.testing.assert_array_equal(back.features, first.features[1:3])
    bad = prec.RecordReaderDataSetIterator(
        prec.CollectionRecordReader([[0.5, 5]]), 2, num_classes=3)
    with pytest.raises(ValueError, match="out of range"):
        next(iter(bad))

    seqdir = tmp_path / "seq"
    seqdir.mkdir()
    for i, t in enumerate((3, 5, 2)):
        _csv(seqdir / f"s{i}.csv",
             [[*np.round(rng.standard_normal(2), 3), int(rng.integers(0, 2))]
              for _ in range(t)])
    p = prec.SequenceRecordReaderDataSetIterator(
        prec.CSVSequenceRecordReader(str(seqdir)), 2, num_classes=2)
    j = jrec.SequenceRecordReaderDataSetIterator(
        jrec.CSVSequenceRecordReader(str(seqdir)), 2, num_classes=2)
    pb, jb = list(p), list(j)
    _same(pb, jb)
    assert pb[0].features.shape == (2, 5, 2)

    def multi(m):
        return (m.RecordReaderMultiDataSetIterator.builder(4)
                .add_reader("csv", m.CSVRecordReader(path, skip_lines=1))
                .add_input("csv", 0, 1).add_input("csv", 2, 2)
                .add_output_one_hot("csv", 3, 3).build())

    pm, jm = list(multi(prec)), list(multi(jrec))
    assert type(pm[0]).__name__ == "MultiDataSet"
    assert type(pm[0]).__module__.startswith("deeplearning4j_tpu_torch")
    _same(pm, jm)
    with pytest.raises(ValueError, match="unknown reader"):
        (prec.RecordReaderMultiDataSetIterator.builder(2)
         .add_reader("a", prec.CollectionRecordReader(rows))
         .add_input("b", 0, 1).build())


def test_image_record_reader_and_lfw_directory(tmp_path, monkeypatch):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    for person, n in (("ann", 3), ("bob", 2)):
        d = tmp_path / "lfw" / person
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (10, 8, 3), dtype=np.uint8)
                            ).save(d / f"{person}_{i:04d}.png")
    p = list(prec.ImageRecordReader(str(tmp_path / "lfw"), height=6,
                                    width=4))
    j = list(jrec.ImageRecordReader(str(tmp_path / "lfw"), height=6,
                                    width=4))
    assert len(p) == 5 and [r[1] for r in p] == [r[1] for r in j]
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a[0], b[0])
    from deeplearning4j_tpu.data import datasets as jds
    from deeplearning4j_tpu_torch.data import datasets as pds

    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    got = pds.load_lfw(height=6, width=4, num_labels=2)
    want = jds.load_lfw(height=6, width=4, num_labels=2)
    assert not got[3] and got[2] == want[2] == ["ann", "bob"]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# -------------------------------------------------------- streaming
def test_in_memory_broker_streaming_matches_jax():
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(3).astype(np.float32) for _ in range(5)]
    ys = [np.eye(2, dtype=np.float32)[i % 2] for i in range(5)]
    out = []
    for m in (pstr, jstr):
        broker = m.InMemoryBroker()
        px, py = m.NDArrayPublisher(broker, "x"), \
            m.NDArrayPublisher(broker, "y")
        producer = threading.Thread(target=lambda: [
            (px.publish(a), py.publish(b)) for a, b in zip(xs, ys)])
        producer.start()
        producer.join()
        it = m.StreamingDataSetIterator(broker, features_topic="x",
                                        labels_topic="y", batch_size=2,
                                        timeout=0.2)
        out.append(list(it))
        # a feature whose label has not arrived waits for its label
        px.publish_record([1, 2, 3])
        assert list(it) == []
        py.publish(np.ones(2, np.float32))
        last = list(it)
        np.testing.assert_array_equal(last[0].features, [[1.0, 2.0, 3.0]])
    _same(*out)
    assert [b.num_examples() for b in out[0]] == [2, 2, 1]
    a = np.arange(6, dtype=np.int16).reshape(2, 3)
    np.testing.assert_array_equal(
        pstr.bytes_to_ndarray(jstr.ndarray_to_bytes(a)), a)
    assert pstr.ndarray_to_bytes(a) == jstr.ndarray_to_bytes(a)
    consumer = pstr.NDArrayConsumer(pstr.InMemoryBroker(), "none", 0.05)
    assert consumer.get() is None and list(consumer) == []


def test_kafka_broker_needs_kafka():
    try:
        import kafka  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="kafka-python"):
            pstr.KafkaBroker("127.0.0.1:9")


# ------------------------------------------------------- timesource
class _Sntp:
    """A one-reply-per-datagram SNTP responder on 127.0.0.1 whose clock
    runs `offset_s` ahead of this host's."""

    def __init__(self, offset_s):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.offset = offset_s
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while not self.stop.is_set():
            try:
                _, addr = self.sock.recvfrom(64)
            except socket.timeout:
                continue
            t = time.time() + self.offset + pts._NTP_EPOCH_DELTA
            sec, frac = int(t), int((t % 1) * 2 ** 32)
            reply = bytearray(48)
            reply[0] = 0x1C
            reply[32:40] = struct.pack("!II", sec, frac)
            reply[40:48] = struct.pack("!II", sec, frac)
            self.sock.sendto(bytes(reply), addr)

    def close(self):
        self.stop.set()
        self.thread.join()
        self.sock.close()


def test_time_sources_against_a_local_sntp_responder(monkeypatch):
    srv = _Sntp(offset_s=2.5)
    try:
        off = pts.sntp_offset_ms("127.0.0.1", port=srv.port, timeout=2.0)
        assert abs(off - 2500.0) < 200.0
        monkeypatch.setattr(pts, "sntp_offset_ms",
                            lambda server, timeout: off)
        src = pts.NTPTimeSource("127.0.0.1", update_freq_ms=60_000)
        assert src.synchronized_ and src.offset_ms == off
        assert abs(src.current_time_millis()
                   - (time.time() * 1000 + off)) < 100
        src.close()
        src._thread.join(timeout=5)
        assert not src._thread.is_alive()
    finally:
        srv.close()

    def fail(server, timeout):
        raise OSError("unreachable")

    monkeypatch.setattr(pts, "sntp_offset_ms", fail)
    src = pts.NTPTimeSource("127.0.0.1")
    assert not src.synchronized_ and src.offset_ms == 0.0
    src.close()
    sys_src = pts.SystemClockTimeSource()
    assert abs(sys_src.current_time_millis() - time.time() * 1000) < 100
    monkeypatch.setattr(pts.TimeSourceProvider, "_instance", None)
    monkeypatch.delenv("DL4J_TPU_TIME_SOURCE", raising=False)
    assert isinstance(pts.TimeSourceProvider.get_instance(),
                      pts.SystemClockTimeSource)
    pts.TimeSourceProvider.set_instance(src)
    assert pts.TimeSourceProvider.get_instance() is src
