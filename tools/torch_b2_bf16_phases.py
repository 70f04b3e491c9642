#!/usr/bin/env python3
"""Where the bfloat16 design-2 LSTM kernels' time goes, on one card.

    python3 tools/torch_b2_bf16_phases.py [--shape T,B,H]

The forward (`persist::lstm_fwd_persistent_bf16_kernel`, B2a with
residuals) and the recurrence of the backward
(`persist::lstm_bwd_persistent_bf16_kernel`, B2c's dxw, dh0, dc0):
builds `csrc/lstm.cu` six times, each a copy of the package under
`deeplearning4j_tpu_torch/_build/phases_bf16/<variant>/` with edits of
both kernels' source:

- `full`: as it is;
- `no_product`: the step's `mma.sync` loop runs no iteration (both);
- `no_copy`: the forward's step copies no h tile from the global buffer,
  the backward's exchange reads no partial;
- `no_barrier`: the step's tile barrier is a block barrier
  (`__syncthreads`; both);
- `none`: all three (the cell, the stores and the block barriers left);
- `no_stage`: neither kernel stages its strip of RW (the 16-byte copy
  loop, taken where H is a multiple of 8, runs no iteration).

The knocked-out kernels compute wrong outputs: they are timed, never
used. Each variant, in a process of its own, times `launch_fwd(...,
"persistent")` and `launch_bwd_recurrence(..., "persistent")` (CUDA
events around each launch after a 256 MB L2 flush, 20 launches after 3)
at the shape (default path_l's, T 128, B 64, H 512, unmasked) and at T
8; `full` also at T 1. A step's cost is (ms at T - ms at 8) / (T - 8);
the launch's fixed cost is ms at 8 less 8 steps, and the strip's
staging is `full` less `no_stage` at T.

The weight product (`wg::lstm_drw_wgmma_kernel`, B2c's dRW): the clusters
of each size (1-8 blocks) the card runs at once
(`ops/lstm.wgmma_clusters`), the slices `b2c_wgmma_splits` takes at the
shape, and the launch's time at every slice count from 1 to 8 (the same
timing, through `dl4j_lstm_bwd_weights_wgmma` with the count given), with
one bfloat16 `torch.matmul` of the same product beside it.

Prints one JSON line, then the card's name and power limit. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "deeplearning4j_tpu_torch"
WORK = PKG / "_build" / "phases_bf16"

EDITS = {
    # the forward
    "product": ("    for (int s0 = 0; s0 < ksteps; s0 += 4) {",
                "    for (int s0 = 0; s0 < 0; s0 += 4) {"),
    "copy": ("    for (int idx = threadIdx.x; idx < BR * chunks; "
             "idx += kThreads) {",
             "    for (int idx = threadIdx.x; idx < 0; idx += kThreads) {"),
    "barrier": ("    tile_barrier(counter, target);   // h_t is complete in "
                "hbuf\n  }\n  if (col_ok && row_ok) {\n    a.hT[(size_t)b * "
                "H + j] = E::st",
                "    __syncthreads();\n  }\n  if (col_ok && row_ok) {\n    "
                "a.hT[(size_t)b * H + j] = E::st"),
    "stage": ("    for (int idx = threadIdx.x; idx < HK / 2 * CH; "
              "idx += kThreads) {",
              "    for (int idx = threadIdx.x; idx < 0; idx += kThreads) {"),
    # the backward's recurrence
    "b_product": ("    for (int i0 = warp; i0 < tiles; i0 += 4 * kWarps) {",
                  "    for (int i0 = warp; i0 < 0; i0 += 4 * kWarps) {"),
    "b_exchange": ("    if (col_ok) {\n      const float* in = a.part + "
                   "((size_t)(t & 1) * S * Bp + b) * HK + j;",
                   "    if (false) {\n      const float* in = a.part + "
                   "((size_t)(t & 1) * S * Bp + b) * HK + j;"),
    "b_barrier": ("    tile_barrier(counter, target);   // every block's "
                  "bf16 partial is out",
                  "    __syncthreads();"),
    "b_stage": ("    for (int idx = threadIdx.x; idx < HK * CH; "
                "idx += kThreads) {",
                "    for (int idx = threadIdx.x; idx < 0; "
                "idx += kThreads) {"),
}
VARIANTS = {
    "full": (),
    "no_product": ("product", "b_product"),
    "no_copy": ("copy", "b_exchange"),
    "no_barrier": ("barrier", "b_barrier"),
    "none": ("product", "copy", "barrier", "b_product", "b_exchange",
             "b_barrier"),
    "no_stage": ("stage", "b_stage"),
}

# run in each variant's copy: prints {"fwd": {T: ms}, "bwd": {T: ms}} for
# the lengths given
TIMER = r"""
import json, sys, torch
from deeplearning4j_tpu_torch.ops import lstm as lk
B, H = int(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda")
flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

def time_ms(fn, iters=20):
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters

out = {"fwd": {}, "bwd": {}}
for t in (int(v) for v in sys.argv[3:]):
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=g)).to(
        dev, torch.bfloat16)
    rw, p = rnd(H, 4 * H, scale=H ** -0.5), rnd(3, H, scale=.5)
    c0, mask = rnd(B, H, scale=.5), torch.ones(t, B, device=dev,
                                               dtype=torch.bfloat16)
    ins = (rnd(t, B, 4 * H), rw, p, rnd(B, H, scale=.5), c0, mask)
    out["fwd"][t] = time_ms(lambda: lk.launch_fwd(*ins, True, "persistent"))
    # the backward's residuals: gates in (0, 1), cells and cotangents
    gates = torch.sigmoid(rnd(t, B, 4 * H))
    bw = (rw, p, mask, rnd(t, B, H, scale=.5), gates, c0, rnd(t, B, H),
          rnd(B, H), rnd(B, H))
    out["bwd"][t] = time_ms(
        lambda: lk.launch_bwd_recurrence(*bw, "persistent"))
print(json.dumps(out))
"""

# run in the tree itself: the weight product by slice count
WEIGHTS = r"""
import ctypes, json, sys, torch
from deeplearning4j_tpu_torch.ops import cuda_build, lstm as lk
T, B, H = (int(v) for v in sys.argv[1:4])
dev = torch.device("cuda")
flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

def time_ms(fn, iters=20):
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters

lib = cuda_build.library("lstm")
g = torch.Generator().manual_seed(1)
rnd = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=g)).to(
    dev, torch.bfloat16)
hs, h0, dxw = rnd(T, B, H, scale=.5), rnd(B, H, scale=.5), rnd(T, B, 4 * H)
dp_part = torch.zeros(1, 3, H, device=dev)
drw = torch.empty(H, 4 * H, dtype=torch.bfloat16, device=dev)
dp = torch.empty(3, H, dtype=torch.bfloat16, device=dev)

def launch(splits):
    rc = lib.dl4j_lstm_bwd_weights_wgmma(
        hs.data_ptr(), h0.data_ptr(), dxw.data_ptr(), dp_part.data_ptr(),
        drw.data_ptr(), dp.data_ptr(), T, B, H, 1, splits,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    cuda_build.check(lib, rc, "dl4j_lstm_bwd_weights_wgmma")

clusters = lk.wgmma_clusters(dev)
hprev = torch.cat([h0[None], hs[:-1]]).reshape(T * B, H)
flat = dxw.reshape(T * B, 4 * H)
print(json.dumps({
    "clusters": {s: clusters(s) for s in range(1, lk.WGMMA_MAX_SPLITS + 1)},
    "splits_chosen": lk.b2c_wgmma_splits(
        T, B, H, lk.card_limits(dev)[0], clusters),
    "ms_by_splits": {s: time_ms(lambda: launch(s))
                     for s in range(1, lk.WGMMA_MAX_SPLITS + 1)},
    "matmul_ms": time_ms(lambda: torch.matmul(hprev.t(), flat))}))
"""


def make_variant(name: str, edits) -> Path:
    dst = WORK / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(PKG, dst / PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dst / PKG.name / "csrc" / "lstm.cu"
    text = src.read_text()
    for key in edits:
        old, new = EDITS[key]
        if text.count(old) != 1:
            raise SystemExit(f"torch_b2_bf16_phases: the kernel no longer "
                             f"has {old!r} exactly once; update EDITS")
        text = text.replace(old, new)
    src.write_text(text)
    return dst


def run(code: str, cwd: Path, *args) -> dict:
    proc = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                          cwd=cwd, capture_output=True, text=True)
    if proc.returncode:
        print(proc.stderr, file=sys.stderr)
        raise SystemExit(proc.returncode)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="128,64,512",
                    help="T,B,H of the timed calls (T > 8)")
    args = ap.parse_args()
    T, B, H = (int(v) for v in args.shape.split(","))
    if T <= 8:
        raise SystemExit("torch_b2_bf16_phases: T must exceed 8")
    import torch

    if not torch.cuda.is_available():
        print("torch_b2_bf16_phases: needs a CUDA card", file=sys.stderr)
        return 2
    dirs = {name: make_variant(name, edits)
            for name, edits in VARIANTS.items()}
    # the six builds at once, one nvcc each
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from deeplearning4j_tpu_torch.ops import "
         "cuda_build; cuda_build.build(['lstm'])"], cwd=d)
        for d in dirs.values()]
    if any(b.wait() for b in builds):
        return 1
    ms = {k: {} for k in ("fwd", "bwd")}
    for name, d in dirs.items():
        lengths = (T, 8, 1) if name == "full" else (T, 8)
        got = run(TIMER, d, B, H, *lengths)
        for k in ms:
            ms[k][name] = {int(t): v for t, v in got[k].items()}

    def split(kernel, copy):
        m = ms[kernel]
        step_us = {name: (m[name][T] - m[name][8]) / (T - 8) * 1e3
                   for name in m}
        full = step_us["full"]
        return {"ms": m, "step_us": step_us,
                "fixed_us": m["full"][8] * 1e3 - 8 * full,
                "staging_us": (m["full"][T] - m["no_stage"][T]) * 1e3,
                "share_us": {"product": full - step_us["no_product"],
                             copy: full - step_us["no_copy"],
                             "barrier": full - step_us["no_barrier"],
                             "rest": step_us["none"]}}

    print(json.dumps({
        "T": T, "B": B, "H": H,
        "forward": split("fwd", "copy"),
        "backward": split("bwd", "exchange"),
        "weights": run(WEIGHTS, ROOT, T, B, H)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
