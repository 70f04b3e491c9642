#!/usr/bin/env python3
"""Where the time of the PyTorch port's training step goes, on one card.

    python3 tools/torch_train_profile.py [--path t|w|l|g|r]

Builds one of `chip_smoke.py`'s paths, warms it untraced, then runs it
under `torch.profiler` and reads the kernels off its Chrome trace, with
the same method as `tools/torch_decode_profile.py`:

- `--path t` (default), `path_t`: the 6-block GPT-style
  `TextGenerationTransformer` at d_model 512, 8 heads, T 2048, batch 8,
  float32, its default Adam(3e-4); two traced train steps;
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
  train steps (B7a 36 and B7b 16 launches a step, B1b once).

Prints one JSON line: the traced window's wall time, the time the card
was busy (the union of kernel intervals), the idle share, kernels
launched a step (or a call), and device time by kernel class (the flash
kernels B3a and B3b + B3c, the banded kernel B4 and the banded backward's
dense recompute, the LSTM kernels B2a, B2b and B2c with its
weight-gradient launch, the fused updates B1a and B1b, the conv+BN
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
    if "flash_fwd" in name:
        return "flash_fwd (B3a)"
    if "flash_bwd" in name:
        return "flash_bwd (B3b + B3c)"
    if "AdamRule" in name:
        return "fused_adam (B1a)"
    if "NesterovRule" in name:
        return "fused_nesterov (B1b)"
    if "lstm_fwd_kernel" in name:
        # the template argument: true keeps the residuals (B2a)
        return ("lstm_fwd (B2a)" if "<true>" in name
                else "lstm_fwd_inference (B2b)")
    if "lstm_bwd_kernel" in name:
        return "lstm_bwd recurrence (B2c)"
    if "lstm_drw_kernel" in name or "lstm_dp_reduce" in name:
        return "lstm_bwd weights (B2c)"
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
                              "ampere_sgemm", "cublas")):
        return "matmul"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduction"
    return "other"


def traced_window(path):
    """(run, units, unit name, work a unit): `run()` drives the traced
    window; the warm-up has been done when this returns."""
    rng = np.random.default_rng(0)
    if path == "r":
        from deeplearning4j_tpu_torch.models import ComputationGraph

        net = ComputationGraph(cs.resnet_conf(), device="cuda").init()
        batches = cs.image_batches(rng, 3, 128, 224, 1000)
        net.fit(batches[:1], epochs=1)              # warm, untraced
        return (lambda: net.fit(batches[1:], epochs=1)), 2, "step", 128
    if path in ("t", "w"):
        kw = dict(window=256, **cs.LLAMA) if path == "w" else {}
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
    ap.add_argument("--path", choices=("t", "w", "l", "g", "r"),
                    default="t")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, units, unit, tokens = traced_window(args.path)
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
        "phase": f"profile_path_{args.path}",
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.gpu_name_and_limit(), f"{unit}s": units,
        f"{'images' if args.path == 'r' else 'tokens'}_per_{unit}": tokens,
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
