"""Streaming ingestion — dl4j-streaming parity (Kafka/Camel NDArray
routes); the port's copy of `deeplearning4j_tpu/data/streaming.py`, over
the port's own `DataSet` and `DataSetIterator`. Everything here is host
side: the arrays are numpy until `fit` moves a batch to the card.

Reference parity: `dl4j-streaming/` (SURVEY §2.4) — `NDArrayConsumer` /
`NDArrayPublisher` move serialized NDArrays through Kafka topics
(`streaming/kafka/NDArrayPubSubRoute.java`), `conversion/` turns DataVec
records into NDArrays, and tests run against an in-JVM
`EmbeddedKafkaCluster` (SURVEY §4 "embedded-infra fixtures").

The transport is an SPI (`Broker`). The default
`InMemoryBroker` is the embedded-cluster equivalent (and the right tool for
single-host pipelines: a lock-free-enough queue per topic). A Kafka broker
can be slotted in where the environment provides `kafka-python`; the codec
and iterator layers are transport-agnostic. The consumer side terminates in
`StreamingDataSetIterator`, a standard DataSetIterator that a training loop
can drink from while a producer publishes concurrently — the host-side
analogue of the reference's Camel route into Spark Streaming.
"""

from __future__ import annotations

import io
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator


# ------------------------------------------------------------------ codec
def ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """Serialize one ndarray (reference: NDArrayMessage binary format —
    ours is the npy container: self-describing dtype + shape)."""
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def bytes_to_ndarray(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


def record_to_ndarray(record: Sequence) -> np.ndarray:
    """DataVec-record → ndarray (reference: `conversion/` writable lists)."""
    return np.asarray([float(v) for v in record], np.float32)


# ------------------------------------------------------------------ broker
class Broker:
    """Transport SPI: named topics carrying opaque byte messages."""

    def publish(self, topic: str, payload: bytes) -> None:
        raise NotImplementedError

    def poll(self, topic: str, timeout: float) -> Optional[bytes]:
        raise NotImplementedError


class InMemoryBroker(Broker):
    """Embedded single-process broker (the EmbeddedKafkaCluster analogue)."""

    def __init__(self, max_queue: int = 1024):
        self._topics: Dict[str, queue.Queue] = {}
        self._lock = threading.Lock()
        self._max = max_queue

    def _q(self, topic: str) -> queue.Queue:
        with self._lock:
            if topic not in self._topics:
                self._topics[topic] = queue.Queue(self._max)
            return self._topics[topic]

    def publish(self, topic: str, payload: bytes) -> None:
        self._q(topic).put(payload)

    def poll(self, topic: str, timeout: float) -> Optional[bytes]:
        try:
            return self._q(topic).get(timeout=timeout)
        except queue.Empty:
            return None


class KafkaBroker(Broker):
    """Kafka transport — gated on kafka-python being installed (it is not
    part of the baked image; construct raises ImportError otherwise)."""

    def __init__(self, bootstrap_servers: str):
        try:
            from kafka import KafkaConsumer, KafkaProducer  # noqa: F401
        except ImportError as e:  # pragma: no cover - env-dependent
            raise ImportError(
                "KafkaBroker requires the kafka-python package") from e
        from kafka import KafkaProducer

        self._servers = bootstrap_servers
        self._producer = KafkaProducer(bootstrap_servers=bootstrap_servers)
        self._consumers: Dict[str, object] = {}

    def publish(self, topic, payload):  # pragma: no cover - env-dependent
        self._producer.send(topic, payload)

    def poll(self, topic, timeout):  # pragma: no cover - env-dependent
        from kafka import KafkaConsumer

        if topic not in self._consumers:
            self._consumers[topic] = KafkaConsumer(
                topic, bootstrap_servers=self._servers,
                consumer_timeout_ms=int(timeout * 1000))
        for msg in self._consumers[topic]:
            return msg.value
        return None


# ------------------------------------------------------------ pub/sub ends
class NDArrayPublisher:
    """Reference: `streaming/kafka/NDArrayPublisher` — push arrays to a
    topic."""

    def __init__(self, broker: Broker, topic: str):
        self.broker = broker
        self.topic = topic

    def publish(self, arr: np.ndarray) -> None:
        self.broker.publish(self.topic, ndarray_to_bytes(arr))

    def publish_record(self, record: Sequence) -> None:
        self.publish(record_to_ndarray(record))


class NDArrayConsumer:
    """Reference: `streaming/kafka/NDArrayConsumer.java` — pull arrays."""

    def __init__(self, broker: Broker, topic: str, timeout: float = 5.0):
        self.broker = broker
        self.topic = topic
        self.timeout = timeout

    def get(self) -> Optional[np.ndarray]:
        payload = self.broker.poll(self.topic, self.timeout)
        return None if payload is None else bytes_to_ndarray(payload)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            arr = self.get()
            if arr is None:
                return
            yield arr


class StreamingDataSetIterator(DataSetIterator):
    """Drain (features, labels) array pairs from two topics into DataSets.

    The training-loop end of the route (reference: the Camel route feeding
    `pipeline/spark/`): blocks up to `timeout` per batch; a None/timeout
    ends the epoch, so `fit` completes when the stream goes quiet."""

    def __init__(self, broker: Broker, *, features_topic: str,
                 labels_topic: str, batch_size: int = 32,
                 timeout: float = 2.0):
        self._consumer_x = NDArrayConsumer(broker, features_topic, timeout)
        self._consumer_y = NDArrayConsumer(broker, labels_topic, timeout)
        self._batch = batch_size
        # A feature whose label hasn't arrived yet is parked here, NOT
        # dropped — dropping would permanently desync the two topics.
        self._pending_x: Optional[np.ndarray] = None

    @property
    def batch_size(self):
        return self._batch

    def reset(self):  # a stream has no rewind
        pass

    def __iter__(self):
        return self

    def __next__(self) -> DataSet:
        xs: List[np.ndarray] = []
        ys: List[np.ndarray] = []
        while len(xs) < self.batch_size:
            if self._pending_x is not None:
                x, self._pending_x = self._pending_x, None
            else:
                x = self._consumer_x.get()
                if x is None:
                    break
            y = self._consumer_y.get()
            if y is None:
                self._pending_x = x  # keep pairing intact for the next batch
                break
            xs.append(x)
            ys.append(y)
        if not xs:
            raise StopIteration
        return DataSet(np.stack(xs), np.stack(ys))
