#!/usr/bin/env python3
"""Where a step of B2c's design-2 recurrence goes, by knocking out its
phases, on one card.

    python3 tools/torch_b2c_phases.py [--shape T,B,H]

Builds `csrc/lstm.cu` five times, each a copy of the package under
`deeplearning4j_tpu_torch/_build/phases/<variant>/` with one edit of
`persist::lstm_bwd_persistent_kernel`'s source:

- `full`: as it is;
- `no_product`: the partial dh_prev's loop over the block's gate
  columns runs no iteration (the partials are still stored);
- `no_barrier`: the tile barrier is a block barrier (`__syncthreads`);
- `no_exchange`: the exchange reads no partial (dh_prev is the mask's
  pass-through);
- `none`: all three.

The knocked-out kernels compute wrong gradients: they are timed, never
used. Each variant, in a process of its own, times the recurrence on
"persistent" (`launch_bwd_recurrence`, CUDA events around each launch
after a 256 MB L2 flush, 30 launches after 3) at the shape (default
path_l's, T 128, B 64, H 512, unmasked) and at T 8. A step's cost is
(ms at T - ms at 8) / (T - 8), which leaves out the launch's fixed cost
(the strip's staging); a phase's share is the full step less the step
without it. Prints one JSON line, then the card's name and power limit.
Needs a CUDA card.
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
WORK = PKG / "_build" / "phases"

EDITS = {
    "product": ("for (int c = c_lo; c < c_hi; ++c) {",
                "for (int c = c_lo; c < c_lo; ++c) {"),
    "barrier": ("    tile_barrier(counter, target);   // every block's "
                "partial is written",
                "    __syncthreads();"),
    "exchange": ("v[sb] = sb < S ? __ldcg(in + sb * step) : 0.f;",
                 "v[sb] = 0.f;"),
    "exchange_tail": ("for (int sb = 32; sb < S; ++sb) s += __ldcg(in + sb "
                      "* step);", ""),
}
VARIANTS = {
    "full": (),
    "no_product": ("product",),
    "no_barrier": ("barrier",),
    "no_exchange": ("exchange", "exchange_tail"),
    "none": ("product", "barrier", "exchange", "exchange_tail"),
}

# run in each variant's copy: prints {T: ms} for the two lengths
TIMER = r"""
import json, sys, torch
from deeplearning4j_tpu_torch.ops import lstm as lk
T, B, H = (int(v) for v in sys.argv[1:4])
dev = torch.device("cuda")
flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

def time_ms(fn, iters=30):
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

out = {}
for t in (T, 8):
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=g)).to(dev)
    xw, rw = rnd(t, B, 4 * H), rnd(H, 4 * H, scale=H ** -0.5)
    p, h0, c0 = rnd(3, H, scale=.5), rnd(B, H, scale=.5), rnd(B, H, scale=.5)
    mask = torch.ones(t, B, device=dev)
    hs, cs, gates, _, _ = lk.lstm_fwd(xw, rw, p, h0, c0, mask)
    dhs, dhT, dcT = rnd(t, B, H), rnd(B, H), rnd(B, H)
    out[t] = time_ms(lambda: lk.launch_bwd_recurrence(
        rw, p, mask, cs, gates, c0, dhs, dhT, dcT, "persistent"))
print(json.dumps(out))
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
            raise SystemExit(f"torch_b2c_phases: the kernel no longer has "
                             f"{old!r} exactly once; update EDITS")
        text = text.replace(old, new)
    src.write_text(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="128,64,512",
                    help="T,B,H of the timed call (T > 8)")
    args = ap.parse_args()
    T, B, H = (int(v) for v in args.shape.split(","))
    if T <= 8:
        raise SystemExit("torch_b2c_phases: T must exceed 8")
    import torch

    if not torch.cuda.is_available():
        print("torch_b2c_phases: needs a CUDA card", file=sys.stderr)
        return 2
    ms, step_us = {}, {}
    for name, edits in VARIANTS.items():
        dst = make_variant(name, edits)
        proc = subprocess.run(
            [sys.executable, "-c", TIMER, str(T), str(B), str(H)],
            cwd=dst, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        ms[name] = {int(k): v for k, v in got.items()}
        step_us[name] = (ms[name][T] - ms[name][8]) / (T - 8) * 1e3
    full = step_us["full"]
    print(json.dumps({
        "T": T, "B": B, "H": H, "ms": ms, "step_us": step_us,
        "share_us": {"product": full - step_us["no_product"],
                     "barrier": full - step_us["no_barrier"],
                     "exchange": full - step_us["no_exchange"],
                     "rest": step_us["none"]}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
