"""The float32 flash forward B3a and backward B3b/B3c in design 3
("tf32x3": 3xTF32 on the tensor cores) beside design 1 ("ffma") and
SDPA's float32 forward and backward, on the card.

At `path_t`'s shape (BH 64, T 2048, Dh 64, causal), `path_x`'s (BH 64,
Tq 2048, Tk 1024, not causal) and at Dh 128 (BH 64, T 1024, causal), on
seeded inputs, for each kernel and
design: the time (CUDA events, a 256 MB L2 flush before each launch,
`chip_smoke.time_ms`), its share of the design's bound
(`chip_smoke.flash_bound`: FMA at 67 TFLOP/s, 3xTF32 at 495 / 3), the
largest error against the plain float32 forward (o, lse) or backward
and, the guard, against the plain forward or backward in float64 on the
same inputs (a share of the largest |ref|; design 3 must stay within
twice design 1's); SDPA's float32 forward (timed as the kernels are) and
backward (dq, dk, dv, from a CUDA graph of the autograd call), each with
the names of the kernels it ran (`torch.profiler`). One JSON line a
shape, the card's name and power limit first.

    python tools/torch_b3_tf32.py [--root DIR] [--label NAME]

`--root` imports `deeplearning4j_tpu_torch` from another tree (an older
version unpacked beside this one), so two versions compare in one call.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SHAPES = {"path_t": dict(bh=64, tq=2048, tk=2048, dh=64, causal=True),
          "path_x": dict(bh=64, tq=2048, tk=1024, dh=64, causal=False),
          "dh128": dict(bh=64, tq=1024, tk=1024, dh=128, causal=True)}
KERNELS = ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


def sdpa_backward(q, k, v, do, causal, flush, cs):
    """(graph ms, kernel names) of SDPA's float32 backward for dq, dk, dv
    of [B, 8, T, Dh] views of the folded inputs."""
    import torch.nn.functional as F

    b = q.shape[0] // 8
    q4, k4, v4, do4 = (t.reshape(b, 8, t.shape[1], t.shape[2])
                       for t in (q, k, v, do))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q4, k4, v4))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    torch.cuda.current_stream().wait_stream(side)

    def bwd():
        return torch.autograd.grad(og, (qg, kg, vg), do4, retain_graph=True)

    return cs.graph_ms(bwd, flush, side), cs.cuda_kernel_names(bwd, side)


def sdpa_forward(q, k, v, causal, flush, cs):
    """(ms, kernel names) of SDPA's float32 forward on [B, 8, T, Dh]
    views of the folded inputs."""
    import torch.nn.functional as F

    b = q.shape[0] // 8
    q4, k4, v4 = (t.reshape(b, 8, t.shape[1], t.shape[2]) for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    return (cs.time_ms(fwd, flush),
            cs.cuda_kernel_names(fwd, torch.cuda.current_stream()))


def forward_rows(q, k, v, causal, c, row, flush, cs, fa):
    """B3a in both designs: time, bound share, error against the plain
    forward, the guard on o and lse, a repeat bit-equal; then SDPA."""
    kern = "flash_attention_fwd"
    ref = fa.flash_attention_plain(q, k, v, causal)
    ref64 = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                     causal)
    for design in ("tf32x3", "ffma"):
        def call(design=design):
            return fa.launch_fwd(q, k, v, causal, design=design)

        got = call()
        torch.cuda.synchronize()
        bms, by = cs.flash_bound(kern, c, design)
        ms = cs.time_ms(call, flush)
        row[f"{kern}/{design}"] = {
            "ms": ms, "tflops": cs.flash_flops(kern, c) / ms / 1e9,
            "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
            "max_abs_err": {n: (a - r).abs().max().item()
                            for n, a, r in zip(("o", "lse"), got, ref)},
            "f64_share": {n: cs.f64_share((a,), (r,))
                          for n, a, r in zip(("o", "lse"), got, ref64)},
            "bit_equal_repeat": all(torch.equal(a, b) for a, b in
                                    zip(got, call()))}
    row[f"{kern}/guard_ratio"] = {
        n: row[f"{kern}/tf32x3"]["f64_share"][n]
        / row[f"{kern}/ffma"]["f64_share"][n] for n in ("o", "lse")}
    row["sdpa_fwd_ms"], row["sdpa_fwd_kernels"] = sdpa_forward(
        q, k, v, causal, flush, cs)
    del ref64
    return ref


def run(name, shape, label, flush, cs, fa):
    g = torch.Generator().manual_seed(23)
    bh, tq, tk, dh, causal = (shape[k] for k in
                              ("bh", "tq", "tk", "dh", "causal"))
    q, do = (torch.randn(bh, tq, dh, generator=g).cuda() for _ in range(2))
    k, v = (torch.randn(bh, tk, dh, generator=g).cuda() for _ in range(2))
    c = dict(shape, dtype=torch.float32)
    row = {"label": label, "shape": name, **shape}
    o, lse = forward_rows(q, k, v, causal, c, row, flush, cs, fa)
    delta = (do * o).sum(dim=-1)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    ref64 = fa.flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v, o, lse, do)), causal)
    launch = {"flash_attention_bwd_dkdv": fa.launch_bwd_dkdv,
              "flash_attention_bwd_dq": fa.launch_bwd_dq}
    pick = {"flash_attention_bwd_dkdv": slice(1, 3),
            "flash_attention_bwd_dq": slice(0, 1)}
    for kern in KERNELS:
        for design in ("tf32x3", "ffma"):
            def call(kern=kern, design=design):
                out = launch[kern](q, k, v, do, lse, delta, causal,
                                   design=design)
                return out if isinstance(out, tuple) else (out,)

            got = call()
            torch.cuda.synchronize()
            sl = pick[kern]
            err = max((a - r).abs().max().item()
                      for a, r in zip(got, ref[sl]))
            big = max(r.abs().max().item() for r in ref[sl])
            bms, by = cs.flash_bound(kern, c, design)
            ms = cs.time_ms(call, flush)
            row[f"{kern}/{design}"] = {
                "ms": ms, "bound_ms": bms, "bound_by": by,
                "bound_share": bms / ms, "max_abs_err": err,
                "err_share": err / big,
                "f64_share": cs.f64_share(got, ref64[sl]),
                "bit_equal_repeat": all(torch.equal(a, b) for a, b in
                                        zip(got, call()))}
        row[f"{kern}/guard_ratio"] = (row[f"{kern}/tf32x3"]["f64_share"]
                                      / row[f"{kern}/ffma"]["f64_share"])
    del ref64
    row["pair_ms"] = {d: sum(row[f"{kk}/{d}"]["ms"] for kk in KERNELS)
                      for d in ("tf32x3", "ffma")}
    row["sdpa_bwd_ms"], row["sdpa_bwd_kernels"] = sdpa_backward(
        q, k, v, do, causal, flush, cs)
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_b3_tf32: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_and_limit(), flush=True)
    print(json.dumps({"label": args.label, "package": fa.__file__}),
          flush=True)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for name, shape in SHAPES.items():
        run(name, shape, args.label, flush, cs, fa)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
