#!/usr/bin/env python3
"""Where the time of the PyTorch port's training step goes, on one card.

    python3 tools/torch_train_profile.py [--path t|w|l|g|r|m|i|ir]
                                         [--dtype float32|bfloat16]
                                         [--steps-per-dispatch K]

Builds one of `chip_smoke.py`'s paths, warms it untraced, then runs it
under `torch.profiler` and reads the kernels off its Chrome trace, with
the same method as `tools/torch_decode_profile.py`:

- `--path t` (default), `path_t`: the 6-block GPT-style
  `TextGenerationTransformer` at d_model 512, 8 heads, T 2048, batch 8,
  float32, its default Adam(3e-4); two traced train steps. With
  `--dtype bfloat16`, `path_t_bf16`: the same model at `bench.py`'s
  dtype, B3a-c on design 2 (`wgmma`). `--dtype` is refused with the
  other paths, whose dtype is fixed (float32; `--path r` bfloat16) and
  reported as such;
- `--path w`, `path_w`: the same width as the 6-block Llama-shaped
  sliding-window model (RoPE, RMSNorm, SwiGLU, 2 KV heads, window 256);
  two traced train steps, B4 forward and the dense band-masked recompute
  backward (every kernel launched inside `BandedAttention.backward`'s
  profiler range is classed as the recompute);
- `--path l`, `path_l`: the LSTM bench model (GravesLSTM(512) x 2 +
  RnnOutputLayer(64), T 128, batch 64, float32, Nesterovs(0.01, 0.9));
  six traced train steps (two batches, one of them masked, three
  epochs), so that what `fit` does once weighs little;
- `--path g`, `path_g`'s stepping loop: `TextGenerationLSTM` at its own
  width, 50 traced greedy `rnn_time_step` calls for 32 streams;
- `--path r`, `path_r`: the fused ResNet-50 ComputationGraph at 224x224,
  1000 classes, bfloat16, batch 128, Nesterovs(0.01, 0.9); two traced
  train steps (B7a 36 and B7b 16 launches a step, B1b once);
- `--path m`, `path_m`: the zoo's LeNet, bfloat16, batch 1024, its
  default Adam(1e-3) (B1a once a step), on the synthetic MNIST
  surrogate; six traced train steps (two batches, three epochs);
- `--path i`, `path_i`'s GoogLeNet at 224x224, 1000 classes, float32,
  batch 32, its default Nesterovs(0.01, 0.9) (B1b once a step); `--path
  ir`, its InceptionResNetV1 at 160x160, batch 32, Adam(1e-3) (B1a);
  two traced train steps each.

`--steps-per-dispatch K` (paths t, m, i and ir) trains through
`fit(steps_per_dispatch=K)`, K steps one CUDA graph replay: the warm-up
fit runs one window (eager, then captured) and the traced window is
replayed windows of K batches (t, i, ir: one window; m: three epochs of
one).

Prints one JSON line: the traced window's wall time, the time the card
was busy (the union of kernel intervals), the idle share, kernels
launched a step (or a call), and device time by kernel class (the flash
kernels B3a and B3b + B3c by design (`ops/attention.b3_design`: wgmma
or ffma), the banded kernel B4 and the banded backward's
dense recompute, the LSTM kernels B2a and B2b by design
(`ops/lstm.b2_design`: persistent or cluster) and B2c's recurrence
and weight-gradient launch by design (`ops/lstm.b2c_design`: persistent
or cluster; pipelined or tiled), the fused updates B1a and B1b, the conv+BN
statistics kernels B7a and B7b by design (`ops/conv_fused.b7_design`:
wgmma or ffma) and their reduction, cuDNN convolutions,
matrix products, elementwise passes (the batch-norm epilogues among
them), reductions, everything else) and for the ten costliest kernels.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from torch_decode_profile import busy_us, kernel_events  # noqa: E402


# the dtype each path trains or runs in (`--dtype` changes path t's only)
PATH_DTYPES = {"t": "float32", "w": "float32", "l": "float32",
               "g": "float32", "r": "bfloat16", "m": "bfloat16",
               "i": "float32", "ir": "float32"}


def recompute_correlations(trace_path):
    """Correlation ids of the kernels launched inside the banded
    backward's profiler range (`ops/banded_attention.RECOMPUTE_RANGE`):
    the runtime launch calls on the range's thread within its span."""
    import json

    from deeplearning4j_tpu_torch.ops.banded_attention import RECOMPUTE_RANGE

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name") == RECOMPUTE_RANGE]
    return {e["args"]["correlation"] for e in events
            if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
            and "correlation" in e.get("args", {})
            and any(tid == e["tid"] and t0 <= e["ts"] <= t1
                    for tid, t0, t1 in spans)}


def kernel_class(name):
    if "banded_fwd" in name:
        return "banded (B4)"
    if "flash_fwd" in name or "fwd_wgmma" in name:
        # design 2 (bfloat16 on the tensor cores) is `tc::fwd_wgmma_kernel`
        return "flash_fwd (B3a) " + ("wgmma" if "wgmma" in name else "ffma")
    if "flash_bwd" in name or "bwd_dkdv_wgmma" in name or \
            "bwd_dq_wgmma" in name:
        # design 2 (bfloat16 on the tensor cores) is `tc::bwd_*_wgmma`
        return "flash_bwd (B3b + B3c) " + (
            "wgmma" if "wgmma" in name else "ffma")
    if "AdamRule" in name:
        return "fused_adam (B1a)"
    if "NesterovRule" in name:
        return "fused_nesterov (B1b)"
    if "lstm_fwd_kernel" in name or "lstm_fwd_persistent" in name:
        # the (last) template argument: true keeps the residuals (B2a);
        # design 2 is `persist::lstm_fwd_persistent_kernel`
        return ("lstm_fwd (B2a)" if "true>" in name
                else "lstm_fwd_inference (B2b)") + (
            " persistent" if "persistent" in name else " cluster")
    if "lstm_bwd_kernel" in name or "lstm_bwd_persistent" in name:
        # design 2 is `persist::lstm_bwd_persistent_kernel`
        return "lstm_bwd recurrence (B2c)" + (
            " persistent" if "persistent" in name else " cluster")
    if "lstm_drw_kernel" in name or "lstm_drw_pipelined" in name:
        # design 2 is `pipe::lstm_drw_pipelined_kernel`
        return "lstm_bwd weights (B2c)" + (
            " pipelined" if "pipelined" in name else " tiled")
    if "lstm_dp_reduce" in name:
        return "lstm_bwd weights (B2c) dP"
    if "stats_gemm_kernel" in name or "tc_stats_kernel" in name:
        # the templates' last argument: true is the 3x3 conv (B7b); design
        # 2 (bfloat16 on the tensor cores) is `tc::tc_stats_kernel`
        kind = ("conv3x3_bn_stats (B7b)" if "true>" in name
                else "conv1x1_bn_stats (B7a)")
        return kind + (" wgmma" if "tc_stats_kernel" in name else " ffma")
    if "stats_reduce_kernel" in name:
        return "B7 statistics reduction"
    low = name.lower()
    if any(t in low for t in ("conv", "cudnn", "dgrad", "wgrad", "fprop",
                              "nchwtonhwc", "nhwctonchw")):
        return "convolution (cuDNN)"
    if any(t in low for t in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "ampere_sgemm", "cublas", "nvjet")):
        return "matmul"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduction"
    return "other"


def inception_net(path):
    """(net on the card, input size): `path_i`'s GoogLeNet at 224 ("i")
    or InceptionResNetV1 at 160 ("ir"), 1000 classes."""
    from deeplearning4j_tpu_torch import zoo

    model, size = ((zoo.GoogLeNet, 224) if path == "i"
                   else (zoo.InceptionResNetV1, 160))
    return model(num_classes=1000, input_shape=(size, size, 3)).init(
        device="cuda"), size


def traced_window(path, dtype="float32", k=1):
    """(run, units, unit name, work a unit): `run()` drives the traced
    window; the warm-up has been done when this returns. `dtype` is
    `path_t`'s; `k` > 1 trains paths t, m, i and ir K steps a dispatch."""
    rng = np.random.default_rng(0)
    if path in ("i", "ir"):
        net, size = inception_net(path)
    if k > 1:
        if path in ("i", "ir"):
            data = cs.image_batches(rng, k, 32, size, 1000)
            units, work, epochs = k, 32, 1
        elif path == "m":
            from deeplearning4j_tpu_torch.data import MnistDataSetIterator
            from deeplearning4j_tpu_torch.models import MultiLayerNetwork

            net = MultiLayerNetwork(cs.lenet_conf(), device="cuda").init()
            data = MnistDataSetIterator(1024, num_examples=k * 1024, seed=0)
            units, work, epochs = 3 * k, 1024, 3
        else:
            net = cs.build_net("cuda", num_blocks=6, seed=5, dtype=dtype)
            data = cs.lm_batches(rng, k, 8, 2048)
            units, work, epochs = k, 8 * 2048, 1
        net.fit(data, epochs=1, steps_per_dispatch=k)   # warm, captured
        return (lambda: net.fit(data, epochs=epochs, steps_per_dispatch=k)
                ), units, "step", work
    if path == "m":
        from deeplearning4j_tpu_torch.data import MnistDataSetIterator
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork

        net = MultiLayerNetwork(cs.lenet_conf(), device="cuda").init()
        it = MnistDataSetIterator(1024, num_examples=2048, seed=0)
        net.fit(it, epochs=1)                       # warm, untraced
        return (lambda: net.fit(it, epochs=3)), 6, "step", 1024
    if path in ("i", "ir"):
        batches = cs.image_batches(rng, 3, 32, size, 1000)
        net.fit(batches[:1], epochs=1)              # warm, untraced
        return (lambda: net.fit(batches[1:], epochs=1)), 2, "step", 32
    if path == "r":
        from deeplearning4j_tpu_torch.models import ComputationGraph

        net = ComputationGraph(cs.resnet_conf(), device="cuda").init()
        batches = cs.image_batches(rng, 3, 128, 224, 1000)
        net.fit(batches[:1], epochs=1)              # warm, untraced
        return (lambda: net.fit(batches[1:], epochs=1)), 2, "step", 128
    if path in ("t", "w"):
        kw = dict(window=256, **cs.LLAMA) if path == "w" else {}
        if path == "t":
            kw["dtype"] = dtype
        net = cs.build_net("cuda", num_blocks=6, seed=5, **kw)
        batches = cs.lm_batches(rng, 3, 8, 2048)
        tokens = 8 * 2048
    elif path == "l":
        net = cs.build_lstm_net("cuda", seed=5)
        batches = cs.seq_batches(rng, 3, 64, 128, 128, 64, masked=(2,))
        net.fit(batches[:1], epochs=1)              # warm, untraced
        return (lambda: net.fit(batches[1:], epochs=3)), 6, "step", 64 * 128
    else:
        from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

        net = TextGenerationLSTM(input_shape=(200, 77),
                                 seed=9).init(device="cuda")
        eye = torch.eye(77, device=net.device)
        tok = [torch.as_tensor(rng.integers(0, 77, 32), device=net.device)]

        def steps(n):
            for _ in range(n):
                out = net.rnn_time_step(eye[tok[0]])
                tok[0] = torch.argmax(out[:, -1, :], dim=-1)

        steps(5)                                    # warm, untraced
        return (lambda: steps(50)), 50, "call", 32
    net.fit(batches[:1], epochs=1)                  # warm, untraced
    return (lambda: net.fit(batches[1:], epochs=1)), 2, "step", tokens


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("t", "w", "l", "g", "r", "m", "i",
                                       "ir"),
                    default="t")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    help="path_t's dtype (--path t only; default float32)")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K train steps a CUDA graph (--path t, m, i, ir)")
    args = ap.parse_args()
    if args.dtype is not None and args.path != "t":
        ap.error(f"--dtype applies to --path t only: --path {args.path} "
                 f"runs in {PATH_DTYPES[args.path]}")
    k = args.steps_per_dispatch
    if k > 1 and args.path not in ("t", "m", "i", "ir"):
        ap.error("--steps-per-dispatch applies to --path t, m, i and ir "
                 "only")
    dtype = args.dtype or PATH_DTYPES[args.path]
    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, units, unit, tokens = traced_window(args.path, dtype, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels = kernel_events(path)
        recompute = recompute_correlations(path)
    cs.check(bool(kernels), "the profiler saw no device kernels")
    by_class, by_name = {}, {}
    for e in kernels:
        c = ("banded backward recompute"
             if e.get("args", {}).get("correlation") in recompute
             else kernel_class(e["name"]))
        by_class[c] = by_class.get(c, 0.0) + e["dur"]
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"])
    busy = busy_us(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    cs.emit({
        "phase": f"profile_path_{args.path}"
                 + ("_bf16" if args.path == "t" and dtype == "bfloat16"
                    else ""),
        "dtype": dtype, "steps_per_dispatch": k,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.gpu_name_and_limit(), f"{unit}s": units,
        f"{'images' if args.path in ('r', 'm', 'i', 'ir') else 'tokens'}"
        f"_per_{unit}": tokens,
        f"wall_ms_per_{unit}": wall_us / 1e3 / units,
        f"device_busy_ms_per_{unit}": busy / 1e3 / units,
        "idle_share": 1.0 - busy / wall_us,
        f"kernels_per_{unit}": len(kernels) / units,
        f"device_ms_per_{unit}_by_class": {
            c: t / 1e3 / units for c, t in sorted(by_class.items())},
        "top_kernels": [{"name": n[:120], "count": c, "ms": t / 1e3}
                        for n, (c, t) in top],
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
