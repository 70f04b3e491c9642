#!/usr/bin/env python3
"""Where the time of the PyTorch port's training step goes, on one card.

    python3 tools/torch_train_profile.py

Builds `chip_smoke.py`'s training path (`path_t`: the 6-block GPT-style
`TextGenerationTransformer` at d_model 512, 8 heads, T 2048, batch 8,
float32, its default Adam(3e-4)), runs one untraced step to warm it,
then two steps under `torch.profiler` and reads the kernels off its
Chrome trace, with the same method as `tools/torch_decode_profile.py`.
Prints one JSON line: the traced steps' wall time, the time the card was
busy (the union of kernel intervals), the idle share, kernels launched a
step, and device time by kernel class (B3a, B3b + B3c, B1a, matrix
products, everything else) and for the ten costliest kernels. Needs a
CUDA card.
"""

from __future__ import annotations

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


def kernel_class(name):
    if "flash_fwd" in name:
        return "flash_fwd (B3a)"
    if "flash_bwd" in name:
        return "flash_bwd (B3b + B3c)"
    if "adam_multi" in name:
        return "fused_adam (B1a)"
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "ampere_sgemm", "cublas")):
        return "matmul"
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    net = cs.build_net("cuda", num_blocks=6, seed=5)
    batches = cs.lm_batches(rng, 3, 8, 2048)
    net.fit(batches[:1], epochs=1)                  # warm, untraced
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(batches[1:], epochs=1)              # two traced steps
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels = kernel_events(path)
    cs.check(bool(kernels), "the profiler saw no device kernels")
    steps = 2
    by_class, by_name = {}, {}
    for e in kernels:
        c = kernel_class(e["name"])
        by_class[c] = by_class.get(c, 0.0) + e["dur"]
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"])
    busy = busy_us(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    cs.emit({
        "phase": "profile_path_t", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.gpu_name_and_limit(), "steps": steps,
        "tokens_per_step": 8 * 2048,
        "wall_ms_per_step": wall_us / 1e3 / steps,
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "idle_share": 1.0 - busy / wall_us,
        "kernels_per_step": len(kernels) / steps,
        "device_ms_per_step_by_class": {c: t / 1e3 / steps
                                        for c, t in sorted(by_class.items())},
        "top_kernels": [{"name": n[:120], "count": c, "ms": t / 1e3}
                        for n, (c, t) in top],
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
