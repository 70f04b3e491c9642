#!/usr/bin/env python3
"""Design 2 of the paged decode kernels B6 / B6q against design 1, and
what sets its time, on one card.

    python3 tools/torch_b6_splits.py

At `chip_smoke.py`'s main case (S 8, H 8, Hkv 8, Dh 64, L 2048 in pages
of 128, positions spread over the table, a shared prefix chain) over
float32, int8 and e4m3 pages, each timed with a cold L2 as
`chip_smoke.time_ms` times the kernels: design 1; design 2 at the split
size `b6_splits` picks and at other split sizes C (pages a block); design
2 with every slot at position -1 (every block empty: the launch, the
workspace writes and the merge, with no K/V read: the floor); and with
every slot at the table's end (all 2048 keys of every slot: the
bandwidth-bound case, reported as GB/s of K/V rows read); and with the
slots at 1032-1060, about where Path A's decode steps find them; and
with one slot at the table's end and the rest empty (the NSPLIT blocks of
each KV head of that slot alone, one an SM: a block's own latency). One
JSON line each, then the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_b6_splits: needs a CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.nn.layers.attention import quantize_kv
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    card = cs.gpu_name_and_limit()
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    S, H, hkv, Dh, lp, npg = 8, 8, 8, 64, 128, 16
    chosen = ba.b6_splits(S, hkv, npg, lp, ba._sm_count(flush.device))
    pt = torch.randperm(S * npg, generator=gen).reshape(S, npg)
    pt[1:, : npg // 4] = pt[0, : npg // 4]
    pt = pt.to("cuda", torch.int32)
    q = torch.randn(S, H, Dh, generator=gen).to("cuda")
    spread = torch.linspace(0, lp * npg - 1, S).round().to("cuda",
                                                           torch.int32)
    positions = {"spread": spread, "empty": torch.full_like(spread, -1),
                 "full": torch.full_like(spread, lp * npg - 1),
                 "half": torch.arange(1032, 1032 + 4 * S, 4).to(spread),
                 "one_slot": torch.full_like(spread, -1).index_fill_(
                     0, torch.tensor([S - 1], device="cuda"), lp * npg - 1)}
    for kv in (torch.float32, torch.int8, torch.float8_e4m3fn):
        k, v = (torch.randn(S * npg, lp, hkv, Dh, generator=gen).to("cuda")
                for _ in range(2))
        sk = sv = None
        if kv != torch.float32:
            (k, sk), (v, sv) = quantize_kv(k, kv), quantize_kv(v, kv)
        row_bytes = 2 * hkv * Dh * k.element_size() \
            + (0 if sk is None else 2 * hkv * 4)
        for where, qpos in positions.items():
            def run(design=None, qpos=qpos):
                return ba.paged_decode_attention(q, k, v, pt, qpos,
                                                 scale_k=sk, scale_v=sv,
                                                 design=design)
            ref = ba.paged_decode_attention_plain(q, k, v, pt, qpos,
                                                  scale_k=sk, scale_v=sv)
            row = {"phase": "b6_splits", "kv_dtype":
                   str(kv).replace("torch.", ""), "positions": where,
                   "chosen_split_pages": chosen,
                   "ffma_ms": cs.time_ms(lambda: run("ffma"), flush)}
            by_c = {}
            for c in sorted({1, 2, chosen, 4, 8, npg}):
                ba.b6_splits.cache_clear()
                saved = ba.b6_splits
                ba.b6_splits = lambda *a, c=c: c
                try:
                    out = run()
                    torch.cuda.synchronize()
                    live = qpos >= 0
                    err = (out[live] - ref[live]).abs().max().item() \
                        if live.any() else out.abs().max().item()
                    cs.check(err <= 2e-5, f"{kv} {where} C {c}: err {err}")
                    by_c[c] = cs.time_ms(run, flush)
                finally:
                    ba.b6_splits = saved
            row["split_ms_by_pages"] = by_c
            row["split_ms"] = by_c[chosen]
            row["speedup_over_ffma"] = row["ffma_ms"] / by_c[chosen]
            if where == "full":
                nbytes = S * npg * lp * row_bytes
                row["kv_bytes"] = nbytes
                row["gb_per_s"] = nbytes / by_c[chosen] / 1e6
                row["ffma_gb_per_s"] = nbytes / row["ffma_ms"] / 1e6
            cs.emit(row)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
