"""The port's `ParallelInference` on the CPU: the collector's batches and
C14, the race between a request failed by `output()` (a shutdown) and
the collector completing the batch it sits in.

C14: the collector checks `fut.done()` and then calls `set_result`. If
`output()` sets the future's exception between the two, `set_result`
raises `InvalidStateError`; before the repair the collector's `except
Exception` then failed every later future of the batch, though their
rows were computed. The test forces the interleaving with a future whose
`done()` has its exception set just after answering False.

Tolerance: a request's rows equal the net's own `output()` on the same
rows within 1e-6 (one float32 forward of a dense net on the CPU; the
padded batch may take another BLAS blocking)."""

import threading
from concurrent.futures import Future

import numpy as np
import pytest

from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.parallel.inference import (
    InferenceMode, ParallelInference,
)


def _net():
    conf = (NeuralNetConfiguration.builder().seed(3)
            .list(DenseLayer(n_out=6, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


class _StoppedBetweenCheckAndSet(Future):
    """A request whose caller fails it (as `output()` does at a shutdown)
    just after the collector's `done()` check answered False."""

    def __init__(self):
        super().__init__()
        self.fired = False

    def done(self):
        d = super().done()
        if not d and not self.fired:
            self.fired = True
            self.set_exception(RuntimeError("ParallelInference is shut down"))
            return False
        return d


def _enqueue_batch(pi, futures, rows):
    """Hand the collector one batch of requests directly (the queue
    `output()` feeds), each `rows` rows."""
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((rows, 4)).astype(np.float32)
          for _ in futures]
    for x, fut in zip(xs, futures):
        pi._queue.put((x, fut))
    return xs


def test_c14_a_stopped_request_does_not_fail_the_rest_of_its_batch():
    net = _net()
    pi = ParallelInference(net, mode=InferenceMode.BATCHED,
                           max_batch_size=64, max_wait_ms=500.0)
    try:
        racy = _StoppedBetweenCheckAndSet()
        others = [Future(), Future()]
        xs = _enqueue_batch(pi, [racy] + others, rows=2)
        for x, fut in zip(xs[1:], others):
            got = fut.result(timeout=30)
            np.testing.assert_allclose(got, net.output(x).numpy(), rtol=0,
                                       atol=1e-6)
        assert racy.fired
        with pytest.raises(RuntimeError, match="shut down"):
            racy.result(timeout=30)
    finally:
        pi.shutdown()


def test_batched_requests_get_their_own_rows():
    net = _net()
    pi = ParallelInference(net, mode=InferenceMode.BATCHED,
                           max_batch_size=16, max_wait_ms=50.0)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((n, 4)).astype(np.float32) for n in (1, 3, 5)]
    out = [None] * len(xs)

    def ask(i):
        out[i] = pi.output(xs[i])

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(xs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for x, y in zip(xs, out):
            np.testing.assert_allclose(y, net.output(x).numpy(), rtol=0,
                                       atol=1e-6)
        assert pi.drain(timeout=5)
    finally:
        pi.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        pi.output(xs[0])


def test_a_failing_batch_fails_each_of_its_requests():
    net = _net()
    pi = ParallelInference(net, mode=InferenceMode.BATCHED,
                           max_batch_size=64, max_wait_ms=200.0)
    try:
        futs = [Future(), Future()]
        rng = np.random.default_rng(2)
        # rows of the wrong width: the batch's forward raises
        for fut in futs:
            pi._queue.put((rng.standard_normal((2, 5)).astype(np.float32),
                           fut))
        for fut in futs:
            with pytest.raises(Exception):
                fut.result(timeout=30)
    finally:
        pi.shutdown()
