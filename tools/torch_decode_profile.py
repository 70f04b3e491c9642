#!/usr/bin/env python3
"""Where the time of the PyTorch port's decode serving goes, on one card.

    python3 tools/torch_decode_profile.py [--kv-dtype native|int8|fp8]
                                          [--b6-design auto|ffma|both]
                                          [--b5-design auto|ffma|both]
                                          [--window-graphs on|off|both]

Builds the two serving paths of `chip_smoke.py` (Path A: the 6-block
GPT-style transformer at d_model 512 on the paged pool and kernel B6;
Path B: the 2-block Llama-shaped variant on the rolling slot pool and
kernel B5), serves one untraced wave to warm them, then serves one wave
under `torch.profiler` and reads the kernels off its Chrome trace. For
each path it prints one JSON line: the wave's wall time, the time the
card was busy (the union of kernel intervals), the idle share, kernel
launches per generated token, and device time by kernel class
(the decode-attention kernels, their quantized variants B5q/B6q,
each with `_split` where design 2 ran, matrix products, everything
else) and for the ten costliest kernels.
`--kv-dtype int8` or `fp8` serves both paths from a quantized pool (int8
or e4m3 codes with float32 scale rows), so B5q and B6q carry the decode
steps. `--b6-design ffma` keeps B6/B6q on design 1 where `b6_design`
would pick design 2; `both` profiles Path A on design 2 and then on
design 1 in the same run (Path B has no B6). `--b5-design` does the same
for B5/B5q on Path B (`b5_design`). Each decode window is one CUDA graph
replay (`--window-graphs on`, the default); `off` runs the windows'
steps eagerly (`cuda_graphs` off), `both` profiles each path both ways in
the same run. Needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def kernel_events(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def busy_us(kernels):
    """Length of the union of the kernel intervals, in microseconds."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_class(name):
    if "decode_attention" in name:
        # the cache type is a template argument; design 2 of B6/B6q is
        # `split::paged_decode_attention_split_kernel`, of B5/B5q
        # `split::decode_attention_split_kernel`
        quant = "signed char" in name or "fp8" in name
        return "decode_attention" + ("_q" if quant else "") \
            + ("_split" if "split" in name else "")
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "ampere_sgemm", "cublas")):
        return "matmul"
    return "other"


def profile_path(name, net, prompts, greedy, max_tokens, kv_dtype=None,
                 designs=None):
    from torch.profiler import ProfilerActivity, profile

    # a new pool may land at a dropped one's addresses: capture anew, so
    # a forced design is the one the window graph runs
    net._graphs.clear()
    registry, sched, mgr = cs.control_plane(net, slots=8, chunk=128, k=8,
                                            kv_dtype=kv_dtype)
    try:
        cs.serve_wave(mgr, prompts, greedy, max_tokens, mgr.vocab)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wave = cs.serve_wave(mgr, prompts, greedy, max_tokens,
                                    mgr.vocab)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            kernels = kernel_events(path)
    finally:
        sched.shutdown()
        registry.close()
    cs.check(bool(kernels), f"{name}: the profiler saw no device kernels")
    by_class, by_name = {}, {}
    for e in kernels:
        c = kernel_class(e["name"])
        by_class[c] = by_class.get(c, 0.0) + e["dur"]
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"])
    wall_us = wave["wall_s"] * 1e6
    busy = busy_us(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    row = {
        "phase": f"profile_{name}", "kv_dtype": mgr.kv_dtype,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.gpu_name_and_limit(),
        "sessions": wave["sessions"], "new_tokens": wave["new_tokens"],
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / wall_us,
        "kernels": len(kernels),
        "kernels_per_token": len(kernels) / wave["new_tokens"],
        "device_ms_by_class": {c: t / 1e3 for c, t in by_class.items()},
        "top_kernels": [{"name": n[:120], "count": c, "ms": t / 1e3}
                        for n, (c, t) in top],
        "tokens_per_s_traced": wave["tokens_per_s"],
        "window_graphs": net.cuda_graphs,
        **(designs or {}),
    }
    cs.emit(row)
    return row


@contextlib.contextmanager
def forced(chooser, design):
    """`ba.<chooser>` (`b6_design` or `b5_design`) answering "ffma" for
    every call (design 1), or left as it is ("auto")."""
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    saved = getattr(ba, chooser)
    if design == "ffma":
        setattr(ba, chooser, lambda *a, **k: "ffma")
    try:
        yield
    finally:
        setattr(ba, chooser, saved)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-dtype", choices=("native", "int8", "fp8"),
                    default="native")
    for flag in ("--b6-design", "--b5-design"):
        ap.add_argument(flag, choices=("auto", "ffma", "both"),
                        default="auto")
    ap.add_argument("--window-graphs", choices=("on", "off", "both"),
                    default="on")
    args = ap.parse_args()
    graphs = {"on": [True], "off": [False],
              "both": [True, False]}[args.window_graphs]
    kv = args.kv_dtype
    if not torch.cuda.is_available():
        print("torch_decode_profile: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    greedy = [True] * 6 + [False] * 2
    net_a = cs.build_net("cuda", num_blocks=6, seed=7)
    stem = rng.integers(0, 256, 1024)
    warm = [np.concatenate([stem, rng.integers(0, 256, 8)])
            for _ in range(8)]
    designs = {"auto": ["auto"], "ffma": ["ffma"], "both": ["auto", "ffma"]}
    for design in designs[args.b6_design]:
        for on in graphs:
            net_a.cuda_graphs = on
            with forced("b6_design", design):
                profile_path("path_a", net_a, warm, greedy, 32, kv,
                             {"b6_design": design})
    del net_a
    net_b = cs.build_path_b_net("cuda")
    long = [rng.integers(0, 256, 2240) for _ in range(8)]
    for design in designs[args.b5_design]:
        for on in graphs:
            net_b.cuda_graphs = on
            with forced("b5_design", design):
                profile_path("path_b", net_b, long, greedy, 32, kv,
                             {"b5_design": design})
    return 0


if __name__ == "__main__":
    sys.exit(main())
