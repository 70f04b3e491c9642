#!/usr/bin/env python3
"""Design 2 of the slot-pool decode kernels B5 / B5q against design 1,
by split size, on one card.

    python3 tools/torch_b5_splits.py

At Path B's shape (S 8, H 8, Hkv 2, Dh 64, a rolling ring of 2303,
window 256) over float32, int8 and e4m3 caches, each timed with a cold
L2 as `chip_smoke.time_ms` times the kernels, and again replayed from a
CUDA graph (`chip_smoke.graph_ms`: the device time alone, without the
host's launch path): design 1; design 2 at the split size `b5_splits`
picks and at other sizes C (positions a block). Positions: `chip_smoke`'s
spread over the ring (before, at and past its length), every slot where
Path B's decode steps find it (2240-2368), every slot empty (end -1:
every block returns at once, the floor), and one slot alone. One JSON
line each, then the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def host_us(fn, n=200):
    """Host microseconds a call takes to enqueue (no sync inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_b5_splits: needs a CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.nn.layers.attention import quantize_kv
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    card = cs.gpu_name_and_limit()
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    S, H, hkv, Dh, L, w = 8, 8, 2, 64, 2303, 256
    q = torch.randn(S, H, Dh, generator=gen).to("cuda")
    spread = torch.tensor([0, 5, 255, 1000, 2302, 2303, 2900, 5000],
                          device="cuda", dtype=torch.int32)
    positions = {"spread": spread,
                 "path_b": torch.arange(2240, 2368, 16).to(spread),
                 "empty": torch.full_like(spread, -1),
                 "one_slot": torch.full_like(spread, -1).index_fill_(
                     0, torch.tensor([S - 1], device="cuda"), 5000)}
    for kv in (torch.float32, torch.int8, torch.float8_e4m3fn):
        k, v = (torch.randn(S, L, hkv, Dh, generator=gen).to("cuda")
                for _ in range(2))
        sk = sv = None
        if kv != torch.float32:
            (k, sk), (v, sv) = quantize_kv(k, kv), quantize_kv(v, kv)
        chosen, _ = ba.b5_splits(S, hkv, L, w, ba._sm_count(flush.device),
                                 ba.split_tile_keys(Dh, kv))
        for where, qpos in positions.items():
            def run(design=None, qpos=qpos):
                return ba.banded_decode_attention(
                    q, k, v, qpos, qpos, window=w, rolling=True, scale_k=sk,
                    scale_v=sv, design=design)
            ref = ba.decode_attention_plain(q, k, v, qpos, qpos, w, True,
                                            scale_k=sk, scale_v=sv)
            live = qpos >= 0
            row = {"phase": "b5_splits", "kv_dtype":
                   str(kv).replace("torch.", ""), "positions": where,
                   "chosen_split_keys": chosen,
                   "ffma_ms": cs.time_ms(lambda: run("ffma"), flush),
                   "ffma_graph_ms": cs.graph_ms(lambda: run("ffma"), flush,
                                                side),
                   "ffma_host_us": host_us(lambda: run("ffma"))}
            by_c, graph_c = {}, {}
            for c in sorted({32, 64, chosen, 128, 256}):
                saved = ba.b5_splits
                n = -(-w // c) + 1
                ba.b5_splits = lambda *a, c=c, n=n: (c, n)
                try:
                    out = run()
                    torch.cuda.synchronize()
                    err = (out[live] - ref[live]).abs().max().item() \
                        if live.any() else out.abs().max().item()
                    cs.check(err <= 2e-5, f"{kv} {where} C {c}: err {err}")
                    by_c[c] = cs.time_ms(run, flush)
                    graph_c[c] = cs.graph_ms(run, flush, side)
                    if c == chosen:
                        row["split_host_us"] = host_us(run)
                finally:
                    ba.b5_splits = saved
            row.update(split_ms_by_keys=by_c, split_graph_ms_by_keys=graph_c,
                       split_ms=by_c[chosen],
                       speedup_over_ffma=row["ffma_ms"] / by_c[chosen])
            cs.emit(row)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
