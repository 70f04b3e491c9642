#!/usr/bin/env python3
"""Drive the PyTorch port (`deeplearning4j_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero with no result line:

1. device: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of every CUDA kernel from `csrc/` (one
   nvcc a source, all at once);
2. kernels: every kernel of the port against its plain PyTorch version
   on the card, each with its time (cold L2), its bound, the plain
   version's time and one PyTorch library call's time as a yardstick
   (the port never calls it):
   - the decode-attention kernels B5 (slot pool) and B6 (paged pool)
     over GQA ratios, visibility modes, page lengths, shared pages and
     dtypes, against `F.scaled_dot_product_attention` over the gathered
     cache;
   - the flash-attention forward B3a and backward B3b/B3c at the
     training path's shape (B 8, H 8, T 2048, Dh 64, causal) and at
     ragged, cross, narrow, wide and bfloat16 variants, against SDPA's
     forward and backward;
   - the fused Adam B1a over the training path's leaves and odd sizes,
     float32 and bfloat16, steps 1 and 1000, against
     `torch.optim.Adam(fused=True)` (which puts ε inside the bias
     correction: a time yardstick, not the same function);
3. path_a: decode serving of `TextGenerationTransformer` at the width
   of the repo's largest transformer (d_model 512, 8 heads, 6 blocks,
   T 2048) through `DecodeSessionManager`, prefix cache on, so the
   paged pool and B6 carry every decode step; a second wave shares a
   1024-token stem and hits the prefix cache;
4. path_b: the Llama-shaped variant (RoPE, RMSNorm, SwiGLU, 2 KV heads
   under 8, window 256, rolling cache) at 2 blocks; the rolling ring
   cannot page, so the slot pool and B5 carry it, and the streams run
   past the ring's length so it wraps;
5. cpu_parity: the port on the card against the port on the CPU, same
   weights, one short greedy prompt;
6. path_t: training of the same model at full width (6 blocks, T 2048,
   batch 8, float32, its default Adam(3e-4)) through `net.fit`: 4 fixed
   batches of random tokens, 3 epochs, 12 steps; B3a/B3b/B3c carry the
   attention and B1a the update; steps 2-12 run under
   `torch.cuda.set_sync_debug_mode("error")`, and the losses are read
   after the steps;
7. train_parity: two Adam steps of a 2-block model at T 256 on the card
   against the same on the CPU, same weights and batch.

Weights are random, from fixed seeds. Each path resets the kernels'
launch counts just before it runs and reads them just after; a kernel
of the path that was never launched, or a plain version called on a
CUDA tensor, fails the run. The last lines are the kernels' summary, the
card's name and power limit, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# (atol, rtol) of a kernel against its plain version, in the working
# dtype. Both compute in float32 and round once; in bfloat16 they may
# then land one bf16 step apart, at most 2**-7 of the value.
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -7)}
REPLACES = {
    "banded_decode_attention":
        "deeplearning4j_tpu/ops/banded_attention.py:314 (_decode_kernel)",
    "paged_decode_attention":
        "deeplearning4j_tpu/ops/banded_attention.py:487 "
        "(_paged_decode_kernel)",
    "flash_attention_fwd":
        "deeplearning4j_tpu/ops/attention.py:64 (_flash_kernel)",
    "flash_attention_bwd_dkdv":
        "deeplearning4j_tpu/ops/attention.py:211 (_flash_bwd_dkdv_kernel)",
    "flash_attention_bwd_dq":
        "deeplearning4j_tpu/ops/attention.py:251 (_flash_bwd_dq_kernel)",
    "adam_update":
        "deeplearning4j_tpu/ops/fused_update.py:46 (_adam_kernel)",
}
SOURCES = {
    "banded_decode_attention":
        "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
    "paged_decode_attention":
        "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
    "flash_attention_fwd": "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkdv":
        "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq":
        "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
    "adam_update": "deeplearning4j_tpu_torch/csrc/fused_update.cu",
}
# products a kernel computes over each visible (query, key) pair, 2 Dh
# flops each: forward S and PV; dK/dV kernel S, dP, dV, dK; dQ kernel
# S, dP, dQ
FLASH_PRODUCTS = {"flash_attention_fwd": 2, "flash_attention_bwd_dkdv": 4,
                  "flash_attention_bwd_dq": 3}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ timing
def time_ms(fn, flush: torch.Tensor, iters: int = 30) -> float:
    """Mean device time of `fn` over `iters` launches, each preceded by
    a write of `flush` (larger than the 50 MB L2) so every launch finds
    the cache cold, as a decode step does after the other layers'."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


# ------------------------------------------------------- phase 2: kernels
def kv_rows(vis, page_table=None, page_len=None):
    """Distinct K/V rows the visible keys live in. A slot-pool slot owns
    its rows; slots whose page tables share a page read its rows once."""
    if page_table is None:
        return int(vis.sum())
    s_idx, j = vis.nonzero(as_tuple=True)
    phys = page_table.long()[s_idx, j // page_len] * page_len + j % page_len
    return int(torch.unique(phys).numel())


def bound(vis, rows, q, hkv, dtype, extra_bytes):
    """(bound_ms, bound_by): the larger of the bytes this call must move
    (the `rows` distinct visible K and V rows, q, out, indices) over HBM
    bandwidth and its operations (QK and PV, 4 flops per slot's visible
    key, head and head dim) over the peak rate of its dtype."""
    esize = torch.tensor([], dtype=dtype).element_size()
    S, H, Dh = q.shape
    nbytes = rows * 2 * hkv * Dh * esize + 2 * q.numel() * esize \
        + extra_bytes
    flops = int(vis.sum()) * 4 * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k_log, v_log, vis):
    """One `scaled_dot_product_attention` over the logical [S, L, Hkv,
    Dh] cache with the same boolean mask: the library yardstick."""
    import torch.nn.functional as F

    qh = q[:, :, None, :]                       # [S, H, 1, Dh]
    kh = k_log.transpose(1, 2)                  # [S, Hkv, L, Dh]
    vh = v_log.transpose(1, 2)
    mask = vis[:, None, None, :]
    gqa = q.shape[1] != k_log.shape[2]
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=gqa)


def kernel_cases():
    """The slice's own shapes (S 8, H 8, Dh 64) over the variations the
    kernels must hold; the two `main` cases are exactly what Path A (B6)
    and Path B (B5) hand the kernels."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for hkv in (8, 2):
            for mode in ("linear", "window", "rolling"):
                cases.append(dict(kernel="banded_decode_attention", dtype=dt,
                                  hkv=hkv, mode=mode,
                                  L=2303 if mode == "rolling" else 2048,
                                  main=(dt == torch.float32 and hkv == 2
                                        and mode == "rolling")))
            for lp in (128, 16):
                cases.append(dict(kernel="paged_decode_attention", dtype=dt,
                                  hkv=hkv, mode="paged", L=2048,
                                  page_len=lp,
                                  main=(dt == torch.float32 and hkv == 8
                                        and lp == 128)))
    return cases


def run_kernel_case(c, flush, gen):
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    dev = flush.device
    dt, hkv, L, S, H, Dh = c["dtype"], c["hkv"], c["L"], 8, 8, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dt)

    q = rnd(S, H, Dh)
    window = None if c["mode"] in ("linear", "paged") else 256
    rolling = c["mode"] == "rolling"
    if rolling:
        # spread over the first pass and well past it: the ring wraps
        qpos = torch.tensor([0, 5, 255, 1000, 2302, 2303, 2900, 5000])
    else:
        # spread across the cache, first and last position included
        qpos = torch.linspace(0, L - 1, S).round().long()
    qpos = qpos.to(dev, torch.int32)
    end = qpos.clone()
    pt = lp = None
    if c["kernel"] == "paged_decode_attention":
        lp = c["page_len"]
        npg = L // lp
        P = S * npg
        kc, vc = rnd(P, lp, hkv, Dh), rnd(P, lp, hkv, Dh)
        pt = torch.randperm(P, generator=gen).reshape(S, npg)
        pt[1:, : npg // 4] = pt[0, : npg // 4]    # a shared prefix chain
        pt = pt.to(dev, torch.int32)
        run = lambda: ba.paged_decode_attention(q, kc, vc, pt, qpos)  # noqa
        plain = lambda: ba.paged_decode_attention_plain(  # noqa: E731
            q, kc, vc, pt, qpos)
        k_log = kc[pt.long()].reshape(S, L, hkv, Dh)
        v_log = vc[pt.long()].reshape(S, L, hkv, Dh)
        extra = pt.numel() * 4 + S * 4
    else:
        kc, vc = rnd(S, L, hkv, Dh), rnd(S, L, hkv, Dh)
        run = lambda: ba.banded_decode_attention(  # noqa: E731
            q, kc, vc, qpos, end, window=window, rolling=rolling)
        plain = lambda: ba.decode_attention_plain(  # noqa: E731
            q, kc, vc, qpos, end, window=window, rolling=rolling)
        k_log, v_log = kc, vc
        extra = 2 * S * 4
    vis = ba.visibility(qpos, end, L, window, rolling)
    live = vis.any(dim=1)        # rows with no visible key are garbage
    out, ref = run(), plain()
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    diff = (out[live].float() - ref[live].float()).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * ref[live].float().abs()).all())
    check(ok, f"{c['kernel']} {c} disagrees with its plain version: "
          f"max abs err {err}, tolerance atol {atol} + rtol {rtol} * |ref|")
    ms = time_ms(run, flush)
    plain_ms = time_ms(plain, flush)
    library_ms = time_ms(sdpa_call(q, k_log, v_log, vis), flush)
    rows = kv_rows(vis, pt, lp)
    bms, by = bound(vis, rows, q, hkv, dt, extra)
    row = {"phase": "kernels", "kernel": c["kernel"],
           "dtype": str(dt).replace("torch.", ""), "S": S, "H": H,
           "Hkv": hkv, "Dh": Dh, "L": L, "mode": c["mode"],
           "page_len": c.get("page_len"), "window": window,
           "visible_keys": int(vis.sum()), "kv_rows": rows,
           "max_abs_err": err, "atol": atol, "rtol": rtol, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
           "main_path_shape": c["main"]}
    emit(row)
    return row


# --------------------------------------------- kernels: flash (B3a-c)
def flash_cases():
    """The training path's shape (B 8 x H 8 = BH 64, T 2048, Dh 64,
    causal, float32), and the variants the kernels must hold: a ragged
    T, Tq != Tk, head dims 32 and 128, bfloat16."""
    f32, bf16 = torch.float32, torch.bfloat16
    base = dict(bh=64, causal=True, dtype=f32, main=False, dh=64)
    return [dict(base, tq=2048, tk=2048, main=True),
            dict(base, tq=1000, tk=1000),
            dict(base, tq=512, tk=768, causal=False),
            dict(base, tq=1024, tk=1024, dh=32),
            dict(base, tq=1024, tk=1024, dh=128),
            dict(base, tq=2048, tk=2048, dtype=bf16)]


def flash_bound(name, c):
    """(bound_ms, bound_by) of one flash kernel: its products over the
    visible (query, key) pairs (causal: the lower triangle) at the peak
    rate of the dtype, or the bytes it must move (inputs read once,
    outputs written once, row statistics float32) over HBM bandwidth."""
    es = torch.tensor([], dtype=c["dtype"]).element_size()
    bh, tq, tk, dh = c["bh"], c["tq"], c["tk"], c["dh"]
    pairs = bh * tq * (tq + 1) // 2 if c["causal"] else bh * tq * tk
    flops = FLASH_PRODUCTS[name] * 2 * dh * pairs
    qe, ke = bh * tq * dh, bh * tk * dh
    nbytes = {"flash_attention_fwd": (2 * qe + 2 * ke) * es + 4 * bh * tq,
              "flash_attention_bwd_dkdv": (2 * qe + 4 * ke) * es
              + 8 * bh * tq,
              "flash_attention_bwd_dq": (3 * qe + 2 * ke) * es
              + 8 * bh * tq}[name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[c["dtype"]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_err(got, ref, dtype, atol):
    """(max abs error, within tolerance): float32 within `atol`; bfloat16
    within `atol` plus one bf16 step of the reference."""
    d = (got.float() - ref.float()).abs()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    return d.max().item(), bool((d <= atol + rtol * ref.float().abs())
                                .all())


def run_flash_case(c, flush, gen):
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import attention as fa

    dev, dt, causal = flush.device, c["dtype"], c["causal"]
    bh, tq, tk, dh = c["bh"], c["tq"], c["tk"], c["dh"]

    def rnd(t):
        return torch.randn(bh, t, dh, generator=gen).to(dev, dt)

    q, k, v, do = rnd(tq), rnd(tk), rnd(tk), rnd(tq)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal)
    # the backward kernels and the plain backward from the same residuals
    grads = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal)
    g_ref = fa.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    e_o, ok_o = flash_err(o, o_ref, dt, 2e-5)
    e_l, ok_l = flash_err(lse, lse_ref, torch.float32, 2e-5)
    errs = {}
    for name, g_, r_ in zip(("dq", "dk", "dv"), grads, g_ref):
        atol = 1e-4 * r_.float().abs().max().item()
        errs[name] = flash_err(g_, r_, dt, atol) + (atol,)
    shape = {kk: c[kk] for kk in ("bh", "tq", "tk", "dh", "causal")}
    check(ok_o and ok_l, f"flash_attention_fwd {shape} {dt}: o err {e_o}, "
          f"lse err {e_l} (tolerance 2e-5, bf16 + one bf16 step)")
    for name, (err, ok, atol) in errs.items():
        check(ok, f"flash backward {shape} {dt}: {name} err {err}, "
              f"tolerance {atol} (1e-4 of the largest |ref|)")

    delta = (do.float() * o_ref.float()).sum(dim=-1)
    runs = {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(
            q, k, v, causal, with_lse=True),
        "flash_attention_bwd_dkdv": lambda: fa.launch_bwd_dkdv(
            q, k, v, do, lse_ref, delta, causal),
        "flash_attention_bwd_dq": lambda: fa.launch_bwd_dq(
            q, k, v, do, lse_ref, delta, causal)}
    errs_of = {"flash_attention_fwd": max(e_o, e_l),
               "flash_attention_bwd_dkdv": max(errs["dk"][0], errs["dv"][0]),
               "flash_attention_bwd_dq": errs["dq"][0]}
    timed_plain = c["main"] or dt == torch.bfloat16
    plain = lib = {}
    if timed_plain:
        plain_fwd = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                             causal), flush,
                            iters=10)
        plain_bwd = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o_ref, lse_ref, do, causal), flush, iters=10)
        plain = {"flash_attention_fwd": plain_fwd,
                 "flash_attention_bwd_dkdv": plain_bwd,
                 "flash_attention_bwd_dq": plain_bwd}
        b = bh // 8
        q4, k4, v4, do4 = (t.reshape(b, 8, t.shape[1], dh).detach()
                           for t in (q, k, v, do))
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), flush)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q4, k4, v4))
        og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            og, (qg, kg, vg), do4, retain_graph=True), flush)
        lib = {"flash_attention_fwd": lib_fwd,
               "flash_attention_bwd_dkdv": lib_bwd,
               "flash_attention_bwd_dq": lib_bwd}
    rows = []
    for name, fn in runs.items():
        bms, by = flash_bound(name, c)
        row = {"phase": "kernels", "kernel": name,
               "dtype": str(dt).replace("torch.", ""), **shape,
               "max_abs_err": errs_of[name], "ms": time_ms(fn, flush),
               "plain_ms": plain.get(name), "library_ms": lib.get(name),
               "bound_ms": bms, "bound_by": by, "main_path_shape": c["main"]}
        emit(row)
        rows.append(row)
    return rows


# ------------------------------------------------- kernels: Adam (B1a)
def adam_bound(n, esize):
    """Bytes bound: read p, g, m, v and write p, m, v once (7 tensors of
    n elements) over HBM bandwidth; ~12 flops an element is far below."""
    return 7 * n * esize / HBM_BYTES_PER_S * 1e3, "bytes"


def run_adam_phase(flush, gen):
    """B1a against its plain version over the training path's real
    leaves (default hyperparameters) and odd sizes (non-default ones),
    float32 and bfloat16, at steps 1 and 1000."""
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    from deeplearning4j_tpu_torch.optim.updaters import tree_leaves

    dev = flush.device
    net = build_net("cuda", num_blocks=6, seed=3)
    real = [tuple(p.shape) for p in tree_leaves(net.params_tree)]
    del net
    odd = [(1,), (127,), (4097,), ((1 << 20) + 3,)]
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for step in (1, 1000):
            for leafset, hyper in (("real", (0.9, 0.999, 1e-8)),
                                   ("odd", (0.8, 0.99, 1e-6))):
                shapes = real if leafset == "real" else odd
                b1, b2, eps = hyper
                t = step + 1
                lrbc = torch.tensor(3e-4 * (1 - b2 ** t) ** 0.5
                                    / (1 - b1 ** t), device=dev)
                leaves = [(torch.randn(s, generator=gen).to(dev, dt),
                           torch.randn(s, generator=gen).to(dev, dt),
                           (0.1 * torch.randn(s, generator=gen)).to(dev, dt),
                           torch.rand(s, generator=gen).to(dev, dt))
                          for s in shapes]
                ref = [fu.adam_update_plain(*leaf, lrbc, beta1=b1, beta2=b2,
                                            eps=eps) for leaf in leaves]
                fu.adam_update(*zip(*leaves), lrbc, beta1=b1, beta2=b2,
                               eps=eps)
                torch.cuda.synchronize()
                rtol = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -22
                err, ok = 0.0, True
                for (p, _, m, v), r in zip(leaves, ref):
                    for got, want in zip((p, m, v), r):
                        d = (got.float() - want.float()).abs()
                        err = max(err, d.max().item())
                        ok = ok and bool((d <= rtol * want.float().abs())
                                         .all())
                check(ok, f"adam_update {leafset} {dt} step {step}: max "
                      f"abs err {err} past {rtol} of |ref|")
                n = sum(p.numel() for p, *_ in leaves)
                main = leafset == "real" and dt == torch.float32 \
                    and step == 1000
                row = {"phase": "kernels", "kernel": "adam_update",
                       "dtype": str(dt).replace("torch.", ""), "step": step,
                       "leaves": leafset, "n_leaves": len(leaves),
                       "elements": n, "beta1": b1, "beta2": b2, "eps": eps,
                       "max_abs_err": err, "rtol": rtol,
                       "main_path_shape": main}
                row["bound_ms"], row["bound_by"] = adam_bound(
                    n, leaves[0][0].element_size())
                lists = list(zip(*leaves))
                row["ms"] = time_ms(lambda: fu.adam_update(
                    *lists, lrbc, beta1=b1, beta2=b2, eps=eps), flush)
                if leafset == "real":
                    row["plain_ms"] = time_ms(lambda: [
                        fu.adam_update_plain(*leaf, lrbc, beta1=b1,
                                             beta2=b2, eps=eps)
                        for leaf in leaves], flush, iters=10)
                    ps = [torch.nn.Parameter(p) for p, *_ in leaves]
                    for prm, (_, g, _, _) in zip(ps, leaves):
                        prm.grad = g
                    opt = torch.optim.Adam(ps, lr=3e-4, betas=(b1, b2),
                                           eps=eps, fused=True)
                    row["library_ms"] = time_ms(opt.step, flush)
                    del opt, ps
                emit(row)
                rows.append(row)
                del leaves, ref, lists
    return rows


# ------------------------------------------------------ serving phases
def build_net(device, *, num_blocks, seed, t=2048, **kw):
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    return TextGenerationTransformer(
        input_shape=(t, 1), d_model=512, num_heads=8,
        num_blocks=num_blocks, seed=seed, **kw).init(device=device)


def control_plane(net, *, slots, chunk, k):
    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, DecodeSessionManager, ModelRegistry,
        ServingStats,
    )

    registry = ModelRegistry()
    registry.deploy("default", 1, net)
    stats = ServingStats()
    sched = ContinuousBatchingScheduler(registry, stats,
                                        max_batch_size=2 * slots)
    mgr = DecodeSessionManager(registry, sched, "default", slots=slots,
                               prefill_chunk=chunk, fused_k=k,
                               metrics=stats.registry)
    return registry, sched, mgr


def pct(vals, q):
    return float(np.percentile(np.asarray(vals, np.float64), q)) \
        if vals else None


def serve_wave(mgr, prompts, greedy, max_tokens, vocab):
    """Open every session at once, wait for all; returns the streams and
    the wave's end-to-end numbers (host clock)."""
    itl_before = len(mgr._h_itl.values())
    t0 = time.perf_counter()
    sessions = [mgr.open_session(p, max_tokens=max_tokens, greedy=g,
                                 temperature=0.8, top_k=40, seed=1000 + i)
                for i, (p, g) in enumerate(zip(prompts, greedy))]
    streams = [s.result(timeout=600) for s in sessions]
    wall = time.perf_counter() - t0
    for s, toks in zip(sessions, streams):
        check(len(toks) == max_tokens,
              f"session {s.id} returned {len(toks)} of {max_tokens}")
        check(all(0 <= t < vocab for t in toks),
              f"session {s.id} produced an out-of-vocabulary token")
    ttft = [s.ttft_ms for s in sessions]
    itl = mgr._h_itl.values()[itl_before:]
    n_tok = sum(len(t) for t in streams)
    return streams, {
        "sessions": len(sessions), "prompt_tokens": int(
            sum(len(p) for p in prompts)),
        "new_tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
        "ttft_samples": len(ttft), "itl_ms_p50": pct(itl, 50),
        "itl_samples": len(itl)}


def drive_path(net, name, kernel, prompts_waves, greedy, max_tokens, *,
               slots, chunk, k):
    """Serve each wave through the session manager with every launch
    count zeroed just before and read just after; returns the streams
    and the path's summary line."""
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    registry, sched, mgr = control_plane(net, slots=slots, chunk=chunk, k=k)
    try:
        torch.cuda.synchronize()
        ba.reset_counts()
        waves, streams = [], []
        for prompts in prompts_waves:
            s, w = serve_wave(mgr, prompts, greedy, max_tokens, mgr.vocab)
            streams.append(s)
            waves.append(w)
        torch.cuda.synchronize()
        launches = dict(ba.LAUNCHES)
        plain_on_cuda = dict(ba.PLAIN_ON_CUDA)
        snap = mgr.snapshot()
    finally:
        sched.shutdown()
        registry.close()
    check(launches[kernel] > 0, f"{name}: {kernel} was never launched")
    check(sum(plain_on_cuda.values()) == 0,
          f"{name}: plain versions ran on CUDA tensors: {plain_on_cuda}")
    row = {"phase": name, "kernel": kernel, "launches": launches,
           "plain_on_cuda": plain_on_cuda, "waves": waves,
           "prefix_cache": snap["prefix_cache"],
           "decode_loop": snap["decode_loop"],
           "dispatches": snap["dispatches"],
           "kernel_policy": snap["kernel_policy"]}
    return streams, row


def path_a(device, rng):
    """Full width, 6 blocks, prefix cache on: B6 on every decode step."""
    net = build_net(device, num_blocks=6, seed=7)
    prompts = [rng.integers(0, 256, 1024) for _ in range(8)]
    stem = prompts[0]
    # wave 2: the wave-1 prompt 0 itself (warm, must equal its cold
    # stream), then the same 1024-token stem with distinct suffixes
    wave2 = [stem] + [np.concatenate([stem, rng.integers(0, 256, 8)])
                      for _ in range(7)]
    greedy = [True] * 6 + [False] * 2
    (w1, w2), row = drive_path(net, "path_a", "paged_decode_attention",
                               [prompts, wave2], greedy, 64, slots=8,
                               chunk=128, k=8)
    check(row["prefix_cache"]["enabled"], "path_a: prefix cache is off")
    check(row["prefix_cache"]["hits"] >= 8,
          f"path_a: wave 2 missed the prefix cache: {row['prefix_cache']}")
    check(w2[0] == w1[0], "path_a: a warm-prefix session's greedy stream "
          "differs from the cold one")
    row["warm_vs_cold_ttft_p50"] = (row["waves"][1]["ttft_ms_p50"]
                                    / row["waves"][0]["ttft_ms_p50"])
    emit(row)
    return row


def path_b(device, rng):
    """Llama-shaped, 2 blocks, rolling ring (L = 2048 + 256 - 1 = 2303):
    B5 on every decode step; prompts of 2240 + 128 new tokens run past
    the ring's length, so it wraps."""
    net = build_net(device, num_blocks=2, seed=11, pos_encoding="rope",
                    norm="rms", ffn_activation="swiglu", num_kv_heads=2,
                    window=256, rolling_cache=True)
    prompts = [rng.integers(0, 256, 2240) for _ in range(8)]
    greedy = [True] * 6 + [False] * 2
    _, row = drive_path(net, "path_b", "banded_decode_attention",
                        [prompts], greedy, 128, slots=8, chunk=128, k=8)
    check(not row["prefix_cache"]["enabled"],
          "path_b: a rolling ring cannot page, yet the prefix cache is on")
    emit(row)
    return row


def cpu_parity(rng, steps=8, tol=1e-3):
    """Path A's model at 2 blocks on the card and on the CPU, same seed
    and so the same weights: one 64-token greedy prompt, then `steps`
    single-token steps fed the CPU's greedy tokens. Output probabilities
    agree within `tol`; the card's greedy token equals the CPU's wherever
    the CPU's top-2 margin exceeds `tol`; the fused window's greedy
    tokens on the card equal the stepwise CPU stream."""
    nets = {d: build_net(d, num_blocks=2, seed=7) for d in ("cuda", "cpu")}
    prompt = rng.integers(0, 256, 64)

    def prefill(net):
        carries = net.session_carries(1, page_len=128)
        stem = prompt[:-1].astype(np.float32)[None, :, None]
        _, carries = net.session_step(stem, carries,
                                      valid=np.ones((1, stem.shape[1]),
                                                    np.float32))
        return carries

    carries = {d: prefill(n) for d, n in nets.items()}
    tok = int(prompt[-1])
    max_err, checked, cpu_stream, clear = 0.0, 0, [], steps
    for i in range(steps):
        probs = {}
        for d, net in nets.items():
            x = np.full((1, 1, 1), tok, np.float32)
            out, carries[d] = net.session_step(x, carries[d])
            probs[d] = out[0, -1].float().cpu()
        err = (probs["cuda"] - probs["cpu"]).abs().max().item()
        max_err = max(max_err, err)
        check(err <= tol, f"cpu_parity: probabilities differ by {err}")
        top2 = torch.topk(probs["cpu"], 2).values
        tok = int(torch.argmax(probs["cpu"]))
        if float(top2[0] - top2[1]) > tol:
            check(int(torch.argmax(probs["cuda"])) == tok,
                  "cpu_parity: greedy tokens differ at a clear margin")
            checked += 1
        else:
            clear = min(clear, i)
        cpu_stream.append(tok)
    # the fused window on the card feeds back its own tokens, so its
    # stream must equal the CPU's up to the first step whose top-2
    # margin is too small to call
    S = 1
    win = nets["cuda"].session_decode_window(
        np.array([prompt[-1]]), prefill(nets["cuda"]),
        active=np.ones(S, bool), k=steps,
        temperature=np.ones(S, np.float32), top_k=np.full(S, 256, np.int32),
        top_p=np.ones(S, np.float32), greedy=np.ones(S, bool),
        keys=np.zeros((S, 2), np.uint32), offsets=np.zeros(S, np.int32),
        budgets=np.full(S, steps, np.int32),
        eos_ids=np.full(S, -1, np.int32))
    window_stream = win[0][0].cpu().tolist()
    check(window_stream[:clear + 1] == cpu_stream[:clear + 1],
          f"cpu_parity: fused window {window_stream} != CPU stepwise "
          f"{cpu_stream} within the first {clear + 1} tokens")
    row = {"phase": "cpu_parity", "max_abs_err": max_err, "tol": tol,
           "steps": steps, "greedy_checked": checked,
           "window_checked": min(clear + 1, steps), "tokens": cpu_stream}
    emit(row)
    return row


# ------------------------------------------------------ training phases
def lm_batches(rng, n, batch, t, vocab=256):
    """`n` fixed DataSets of random tokens [batch, t, 1] with next-token
    one-hot labels (the last position's target is random too)."""
    from deeplearning4j_tpu_torch.data import DataSet

    eye = np.eye(vocab, dtype=np.float32)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (batch, t + 1))
        out.append(DataSet(toks[:, :t, None].astype(np.float32),
                           eye[toks[:, 1:]]))
    return out


def path_t(rng, epochs=3):
    """Full width training: 6 blocks, T 2048, batch 8, float32, the zoo's
    default Adam(3e-4), 4 fixed batches x 3 epochs = 12 steps through
    `net.fit`. Step times come from CUDA events recorded after each step
    is enqueued; steps 2-12 run with host syncs made errors; the losses
    stay on the device until the fit has returned."""
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    from deeplearning4j_tpu_torch.optim.listeners import TrainingListener
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    B, T = 8, 2048
    net = build_net("cuda", num_blocks=6, seed=5)
    check(net.conf.updater == Adam(3e-4),
          f"path_t: zoo updater is {net.conf.updater}, not Adam(3e-4)")
    batches = lm_batches(rng, 4, B, T)

    class Clock(TrainingListener):
        def __init__(self):
            self.events, self.losses = [], []

        def _mark(self):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

        def on_fit_start(self, model):
            self._mark()

        def iteration_done(self, model, iteration, epoch, score):
            self._mark()
            self.losses.append(score)      # a device tensor: not read here

    clock = Clock()
    net.listeners.append(clock)
    step_once = net._fit_batch

    def guarded(ds):
        # every step after the first: any host sync inside raises
        if net.iteration >= 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return step_once(ds)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    net._fit_batch = guarded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (fa, fu, ba):
        mod.reset_counts()
    t0 = time.perf_counter()
    net.fit(batches, epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**fa.LAUNCHES, **fu.LAUNCHES}
    plain_on_cuda = {**fa.PLAIN_ON_CUDA, **fu.PLAIN_ON_CUDA,
                     **ba.PLAIN_ON_CUDA}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in clock.losses]       # read after the steps
    steps = len(losses)
    ev = clock.events
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    tok_s = (steps - 2) * B * T / (ev[2].elapsed_time(ev[steps]) / 1e3)
    per_epoch = len(batches)
    epoch_loss = [float(np.mean(losses[i:i + per_epoch]))
                  for i in range(0, steps, per_epoch)]
    check(steps == epochs * per_epoch, f"path_t: {steps} steps ran")
    check(all(np.isfinite(losses)), f"path_t: losses {losses}")
    check(epoch_loss[-1] < epoch_loss[0],
          f"path_t: mean loss did not fall: {epoch_loss}")
    blocks = 6
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"):
        check(launches[name] == blocks * steps,
              f"path_t: {name} launched {launches[name]} times, want "
              f"{blocks} a step x {steps}")
    check(launches["adam_update"] == steps,
          f"path_t: adam_update launched {launches['adam_update']} times, "
          f"want one a step x {steps}")
    check(sum(plain_on_cuda.values()) == 0,
          f"path_t: plain versions ran on CUDA tensors: {plain_on_cuda}")
    row = {"phase": "path_t", "model": "TextGenerationTransformer",
           "d_model": 512, "heads": 8, "blocks": blocks, "T": T,
           "batch": B, "dtype": "float32", "updater": str(net.conf.updater),
           "steps": steps, "tokens_per_s_steps_3_12": tok_s,
           "step_ms_p50": float(np.median(step_ms[1:])),
           "step_ms_max": max(step_ms[1:]), "step_ms_first": step_ms[0],
           "step_ms": step_ms, "wall_s": wall,
           "max_memory_allocated_bytes": peak, "epoch_mean_loss": epoch_loss,
           "losses": losses, "launches": launches,
           "plain_on_cuda": plain_on_cuda,
           "sync_debug_mode": "error in steps 2-12"}
    emit(row)
    return row


def train_parity(rng, steps=2, tol_loss=1e-5, tol_param=1e-5):
    """The port's train step on the card against the CPU: a 2-block model
    at T 256, batch 2, the same seed (so the same weights) and batch,
    `steps` Adam steps. Adam's ε is 1e-3 here so that a near-zero
    gradient's first update (≈ lr·sign(g) at ε 1e-8) cannot flip with the
    last bits of a sum; losses agree within `tol_loss` relative and
    every parameter within `tol_param` absolute."""
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Adam, tree_leaves

    batch = lm_batches(rng, 1, 2, 256)
    losses, leaves = {}, {}
    for d in ("cuda", "cpu"):
        net = build_net(d, num_blocks=2, seed=17, t=256,
                        updater=Adam(3e-4, epsilon=1e-3))
        scores = CollectScoresIterationListener()
        net.listeners.append(scores)
        net.fit(batch, epochs=steps)
        losses[d] = [sc for _, sc in scores.scores]
        leaves[d] = [p.float().cpu() for p in tree_leaves(net.params_tree)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    dp = max((a - b).abs().max().item()
             for a, b in zip(leaves["cuda"], leaves["cpu"]))
    check(rel <= tol_loss, f"train_parity: losses {losses} differ by {rel} "
          f"relative")
    check(dp <= tol_param, f"train_parity: parameters differ by {dp}")
    row = {"phase": "train_parity", "steps": steps, "losses": losses,
           "loss_rel_err": rel, "tol_loss_rel": tol_loss,
           "max_param_abs_err": dp, "tol_param_abs": tol_param}
    emit(row)
    return row


# ------------------------------------------------------------------ main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = cuda_build.build()
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0, "built": built})

    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rows = [run_kernel_case(c, flush, gen) for c in kernel_cases()]
    for c in flash_cases():
        rows += run_flash_case(c, flush, gen)
    rows += run_adam_phase(flush, gen)
    del flush
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    a = path_a("cuda", rng)
    b = path_b("cuda", rng)
    cpu_parity(rng)
    t = path_t(rng)
    train_parity(rng)

    summary = []
    for name, launches in (
            ("banded_decode_attention", b["launches"]),
            ("paged_decode_attention", a["launches"]),
            ("flash_attention_fwd", t["launches"]),
            ("flash_attention_bwd_dkdv", t["launches"]),
            ("flash_attention_bwd_dq", t["launches"]),
            ("adam_update", t["launches"])):
        mine = [r for r in rows if r["kernel"] == name]
        main_row = next(r for r in mine if r["main_path_shape"])
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    emit({"kernels": summary})
    print(gpu_name_and_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
