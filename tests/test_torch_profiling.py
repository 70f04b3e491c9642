"""`utils/profiling.py` of the PyTorch port, on the CPU: a train step's
flop count against the analytic count and against JAX's `step_flops` on
the same 2-block transformer, the peak table, `trace()` and
`ProfilerListener` writing trace directories, and `PerformanceListener`'s
MFU and syncs a step.

The count is `FlopCounterMode` over the kernels' plain versions on fake
tensors. Its matrix products are exactly 6 · params · tokens (every
weight product forward, its input and its weight gradient backward);
its attention products are the plain version's full T x T squares, the
forward's two, the backward's four and the backward's recompute of
Q·Kᵀ: 7 squares a layer, where the analytic count of the causal step is
6 half squares. So the count is exact against that decomposition, and
stands at 1.0952 of the analytic count here (1.33 at `chip_smoke`'s
T 2048, where attention weighs more). XLA's cost analysis also counts
elementwise work: the port's count is 0.80-0.95 of JAX's on this
model."""

import glob
import logging

import numpy as np
import pytest

import jax.numpy as jnp

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.utils.profiling import step_flops as jax_step_flops
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
import deeplearning4j_tpu_torch.observe as P
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.optim.listeners import PerformanceListener
from deeplearning4j_tpu_torch.utils import profiling
from deeplearning4j_tpu_torch.utils.profiling import (
    ProfilerListener, peak_flops, peak_hbm_bytes, peak_ici_bytes, step_cost,
    step_flops, trace,
)
from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

B, T, V, D, H, L = 4, 32, 64, 32, 4, 2


def _jax_net(monkeypatch):
    """JAX's net of the same configuration. A flop count reads shapes
    alone, so its initializers draw zeros from numpy: JAX's random ones
    compile a program a shape (about 5 s here)."""
    from deeplearning4j_tpu.nn import initializers as jinit

    def zeros(key, shape, dtype=jnp.float32):
        return jnp.asarray(np.zeros(shape, np.dtype(dtype)))

    for name in ("normal", "uniform", "xavier", "xavier_uniform",
                 "xavier_fan_in", "relu", "he", "relu_uniform",
                 "lecun_normal", "lecun_uniform"):
        monkeypatch.setitem(jinit._REGISTRY, name, zeros)
    monkeypatch.setattr(jinit, "xavier", zeros)
    return JaxNet(JaxTGT(num_classes=V, input_shape=(T, 1), d_model=D,
                         num_heads=H, num_blocks=L, seed=1).conf()).init()


def _port_net():
    """The same model on the port alone (its own initial weights)."""
    return MultiLayerNetwork(TextGenerationTransformer(
        num_classes=V, input_shape=(T, 1), d_model=D, num_heads=H,
        num_blocks=L, seed=1).conf(), device="cpu").init()


def _batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, V, (B, T, 1)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    return x, y


def test_step_flops_against_the_analytic_count_and_jax(monkeypatch):
    jnet, pnet = _jax_net(monkeypatch), _port_net()
    assert pnet.conf.to_json() == jnet.conf.to_json()
    x, y = _batch()
    report = step_cost(pnet, x, y)
    tokens = B * T
    # weights that enter a product: 4 projections and the two FFN
    # matrices a block, and the output layer (embeddings are lookups)
    n_mm = L * (4 * D * D + 2 * D * 4 * D) + D * V
    square = 2 * B * H * T * T * (D // H)     # one T x T product's flops
    assert report.by_op == {"aten.mm": 6 * n_mm * tokens,
                            "aten.bmm": 7 * square * L}
    analytic = 6 * n_mm * tokens + 6 * (square // 2) * L
    assert report.flops == step_flops(pnet, x, y)
    assert report.flops / analytic == pytest.approx(1.0952, abs=1e-4)
    ratio = report.flops / jax_step_flops(jnet, x, y)
    assert 0.80 <= ratio <= 0.95, ratio
    # counting changed nothing of the live net
    assert pnet.iteration == 0
    assert all(not t.is_meta for t in pnet.params_tree[
        "layer4_rnnoutputlayer"].values())


def test_step_flops_failure_is_counted_not_raised():
    reg = P.MetricsRegistry()
    prev = P.set_registry(reg)
    try:
        pnet = _port_net()
        x, _ = _batch()
        assert step_flops(pnet, x, np.zeros((3,), np.float32)) is None
        assert reg.counter("profiling_cost_analysis_failures").value == 1
    finally:
        P.set_registry(prev)


def test_peak_table_and_unknown_cards(caplog):
    h100 = "NVIDIA H100 80GB HBM3"
    assert peak_flops(h100) == 989e12
    assert peak_flops(h100, "tf32") == 495e12
    assert peak_flops(h100, "fp32") == 67e12
    assert peak_hbm_bytes(h100) == 3.35e12
    assert peak_ici_bytes(h100) == 450e9
    with pytest.raises(ValueError):
        peak_flops(h100, "fp8")
    profiling._warned.clear()
    with caplog.at_level(logging.WARNING):
        assert peak_flops("NVIDIA H100 PCIe") is None
        assert peak_flops("NVIDIA H100 PCIe") is None
        assert peak_flops() is None            # no card here: "cpu"
    warned = [r for r in caplog.records if "PCIe" in r.getMessage()]
    assert len(warned) == 1


def test_trace_and_profiler_listener_write_trace_directories(tmp_path):
    pnet = _port_net()
    x, y = _batch()
    with trace(str(tmp_path / "block")) as d:
        pnet.output(x)
    assert glob.glob(f"{d}/*.json")
    log = str(tmp_path / "spans.jsonl")
    P.install_span_log(log)
    try:
        lst = ProfilerListener(str(tmp_path / "fit"), start_iteration=1,
                               num_iterations=2)
        pnet.set_listeners(lst)
        pnet.fit(np.concatenate([x] * 4), np.concatenate([y] * 4),
                 batch_size=B)
    finally:
        P.uninstall_span_log()
    assert lst.captured
    assert glob.glob(str(tmp_path / "fit" / "*.json"))
    spans = [s for s in P.read_spans(log)
             if s["name"] == "torch.profiler.trace"]
    assert len(spans) == 1
    assert spans[0]["attrs"]["start_iteration"] == 1
    assert spans[0]["attrs"]["end_iteration"] == 3


def test_performance_listener_mfu_device_ms_and_syncs():
    reg = P.MetricsRegistry()
    prev = P.set_registry(reg)
    try:
        pnet = _port_net()
        x, y = _batch()
        flops = step_flops(pnet, x, y)
        msgs = []
        lst = PerformanceListener(frequency=2, report=msgs.append,
                                  flops_per_step=flops, peak_flops=1e9)
        assert PerformanceListener(flops_per_step=flops).peak_flops is None
        pnet.set_listeners(lst)
        with P.HostSyncMonitor(device="cpu"):
            pnet.fit(np.concatenate([x] * 6), np.concatenate([y] * 6),
                     batch_size=B, epochs=2)
        assert lst.last_device_step_ms and lst.last_device_step_ms > 0
        want = flops / (lst.last_device_step_ms / 1e3) / 1e9
        assert lst.last_mfu == pytest.approx(want)
        assert reg.gauge("train_mfu").value == pytest.approx(want)
        # the second epoch's reports: the first epoch's loss read fell
        # into a window of 2 steps
        assert lst.last_syncs_per_step in (0.0, 0.5)
        assert "MFU" in msgs[-1] and "syncs/step" in msgs[-1]
    finally:
        P.set_registry(prev)
