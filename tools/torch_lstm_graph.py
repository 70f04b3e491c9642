#!/usr/bin/env python3
"""Whether the LSTM kernels' design 2 runs inside a CUDA graph.

    python3 tools/torch_lstm_graph.py

At `path_l`'s shape (T 128, B 64, H 512, masked, peepholes) and at
`path_g`'s tBPTT chunk (T 50, B 32, H 256), captures one forward with
residuals (B2a) and one backward (B2c: its recurrence and its weight
product), each launch in the design the wrappers pick (`b2_design`,
`b2c_design`: the cooperative persistent grids and the pipelined SGEMM),
into a `torch.cuda.CUDAGraph`, replays it, and checks the replay's
outputs bit-equal to the same calls run eagerly. Then times both ways
(CUDA events around 30 calls, after 3 untimed ones; no L2 flush, since a
graph replays back to back). Prints one JSON line a shape, then the
card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def inputs(T, B, H, dev, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)

    xw, rw = rnd(T, B, 4 * H), rnd(H, 4 * H, scale=H ** -0.5)
    p, h0, c0 = rnd(3, H, scale=0.5), rnd(B, H, scale=0.5), rnd(B, H,
                                                               scale=0.5)
    lens = torch.randint(T // 4, T, (B,), generator=g)
    mask = (torch.arange(T)[:, None] < lens[None, :]).float().to(dev)
    dhs, dhT, dcT = rnd(T, B, H), rnd(B, H), rnd(B, H)
    return (xw, rw, p, h0, c0, mask), (dhs, dhT, dcT)


def mean_ms(fn, iters=30):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lstm_graph: needs a CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import lstm as lk

    dev = torch.device("cuda")
    ok = True
    for T, B, H in ((128, 64, 512), (50, 32, 256)):
        ins, (dhs, dhT, dcT) = inputs(T, B, H, dev)
        rw, p, mask, h0, c0 = ins[1], ins[2], ins[5], ins[3], ins[4]

        def step():
            hs, cs, gates, _, _ = lk.lstm_fwd(*ins, with_residuals=True)
            return (hs,) + lk.lstm_bwd(rw, p, mask, hs, cs, gates, h0, c0,
                                       dhs, dhT, dcT)

        eager = step()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm the side stream's pool
            step()
        torch.cuda.current_stream().wait_stream(side)
        lk.reset_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = step()
        captured_launches = dict(lk.LAUNCHES_BY_DESIGN)
        graph.replay()
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(eager, captured))
        ok = ok and equal
        row = {"T": T, "B": B, "H": H,
               "designs": {"lstm_fwd": lk.b2_design(
                   T, B, H, *lk.card_limits(dev)),
                   "lstm_bwd": lk.b2c_design(T, B, H,
                                             *lk.card_limits(dev)),
                   "lstm_bwd_weights": "pipelined"},
               "captured_launches": {f"{k}/{d}": n for (k, d), n in
                                     captured_launches.items() if n},
               "replay_bit_equal_to_eager": equal,
               "eager_ms": mean_ms(step),
               "graph_ms": mean_ms(graph.replay)}
        print(json.dumps(row), flush=True)
        del graph
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
