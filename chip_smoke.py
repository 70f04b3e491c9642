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
   - the fused LSTM forward B2a (with residuals) and B2b (inference) and
     the backward B2c (its reverse-time kernel and its weight-gradient
     launch) at the recurrent paths' shapes (T 128, B 64, H 512; T 200,
     50 and 1 at B 32, H 256), peepholes on and off, masked and not,
     against cuDNN's LSTM (`torch.nn.LSTM`, which also does the input
     projection and has no peepholes or mask: a time yardstick) and, for
     the weight gradients, one `torch.matmul`;
   - the fused Nesterovs B1b over the LSTM training path's leaves and
     odd sizes, float32 and bfloat16, against `torch.optim.SGD(momentum,
     nesterov=True, fused=True)` (PyTorch's form of Nesterov momentum,
     not ND4J's: a time yardstick);
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
   against the same on the CPU, same weights and batch;
8. path_l: training of the repo's LSTM bench model at full width
   (GravesLSTM(512) x 2 + RnnOutputLayer(64), input width 128, T 128,
   batch 64, float32, Nesterovs(0.01, 0.9)) through `net.fit`: 4 fixed
   batches, two of them with ragged feature masks, 3 epochs, 12 steps;
   B2a and B2c run twice a step and B1b once; steps 2-12 run under
   `torch.cuda.set_sync_debug_mode("error")`;
9. path_g: the zoo's `TextGenerationLSTM` (LSTM(256) x 2, 77 characters,
   Adam(1e-3), tBPTT 50) at its own width: one epoch of `fit` on 2
   batches of 32 one-hot sequences of T 200 (four chunks of 50 with the
   carries handed on: B2a, B2c, B1a), `output()` on one batch (B2b at
   T 200), then a greedy loop of 200 `rnn_time_step` calls for 32
   streams (B2b at T 1, twice a call);
10. lstm_parity: both recurrent models at T 32, batch 4: two `fit` steps
    and 8 `rnn_time_step` calls on the card against the same on the CPU.

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
    "banded_decode_attention_q":
        "deeplearning4j_tpu/ops/banded_attention.py:314 (_decode_kernel, "
        "quant=True: :327, :364-367)",
    "paged_decode_attention_q":
        "deeplearning4j_tpu/ops/banded_attention.py:487 "
        "(_paged_decode_kernel, quant=True: :499, :528-531)",
    "banded_attention":
        "deeplearning4j_tpu/ops/banded_attention.py:117 (_banded_kernel)",
    "flash_attention_fwd":
        "deeplearning4j_tpu/ops/attention.py:64 (_flash_kernel)",
    "flash_attention_bwd_dkdv":
        "deeplearning4j_tpu/ops/attention.py:211 (_flash_bwd_dkdv_kernel)",
    "flash_attention_bwd_dq":
        "deeplearning4j_tpu/ops/attention.py:251 (_flash_bwd_dq_kernel)",
    "adam_update":
        "deeplearning4j_tpu/ops/fused_update.py:46 (_adam_kernel)",
    "nesterov_update":
        "deeplearning4j_tpu/ops/fused_update.py:63 (_nesterov_kernel)",
    "lstm_fwd": "deeplearning4j_tpu/ops/lstm.py:61 (_fwd_kernel)",
    "lstm_fwd_inference":
        "deeplearning4j_tpu/ops/lstm.py:92 (_fwd_kernel_inference)",
    "lstm_bwd": "deeplearning4j_tpu/ops/lstm.py:166 (_bwd_kernel: dxw, "
                "dh0, dc0)",
    "lstm_bwd_weights": "deeplearning4j_tpu/ops/lstm.py:166 (_bwd_kernel: "
                        "dRW, dP)",
}
SOURCES = {
    "banded_decode_attention":
        "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
    "paged_decode_attention":
        "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
    "banded_decode_attention_q":
        "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
    "paged_decode_attention_q":
        "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
    "banded_attention": "deeplearning4j_tpu_torch/csrc/banded_attention.cu",
    "flash_attention_fwd": "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkdv":
        "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq":
        "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
    "adam_update": "deeplearning4j_tpu_torch/csrc/fused_update.cu",
    "nesterov_update": "deeplearning4j_tpu_torch/csrc/fused_update.cu",
    "lstm_fwd": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "lstm_fwd_inference": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "lstm_bwd": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "lstm_bwd_weights": "deeplearning4j_tpu_torch/csrc/lstm.cu",
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


def bound(vis, rows, q, hkv, dtype, extra_bytes, kv_dtype=None):
    """(bound_ms, bound_by): the larger of the bytes this call must move
    (the `rows` distinct visible K and V rows — quantized, one byte an
    element plus two 4-byte scales a row and kv head — q, out, indices)
    over HBM bandwidth and its operations (QK and PV, 4 flops per slot's
    visible key, head and head dim) over the peak rate of its dtype."""
    esize = torch.tensor([], dtype=dtype).element_size()
    kv_esize = torch.tensor([], dtype=kv_dtype or dtype).element_size()
    S, H, Dh = q.shape
    scale_bytes = 0 if kv_dtype is None else rows * 2 * hkv * 4
    nbytes = rows * 2 * hkv * Dh * kv_esize + scale_bytes \
        + 2 * q.numel() * esize + extra_bytes
    flops = int(vis.sum()) * 4 * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k_log, v_log, vis, scales=None):
    """One `scaled_dot_product_attention` over the logical [S, L, Hkv,
    Dh] cache with the same boolean mask: the library yardstick. With
    `scales` (the logical [S, L, Hkv] scale rows of quantized caches) a
    dequantize pass comes first, inside the timed call."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops.banded_attention import dequantize

    qh = q[:, :, None, :]                       # [S, H, 1, Dh]
    mask = vis[:, None, None, :]
    gqa = q.shape[1] != k_log.shape[2]

    def call():
        k, v = k_log, v_log
        if scales is not None:
            k = dequantize(k, scales[0], q.dtype)
            v = dequantize(v, scales[1], q.dtype)
        return F.scaled_dot_product_attention(
            qh, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=gqa)
    return call


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
    # B5q and B6q at the shapes path_q hands them (path_b's ring, path_a's
    # pages), int8 and e4m3 codes under float32 queries
    for kv in (torch.int8, torch.float8_e4m3fn):
        main = kv == torch.int8
        cases.append(dict(kernel="banded_decode_attention_q",
                          dtype=torch.float32, kv=kv, hkv=2, mode="rolling",
                          L=2303, main=main))
        cases.append(dict(kernel="paged_decode_attention_q",
                          dtype=torch.float32, kv=kv, hkv=8, mode="paged",
                          L=2048, page_len=128, main=main))
    return cases


def run_kernel_case(c, flush, gen):
    from deeplearning4j_tpu_torch.nn.layers.attention import quantize_kv
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    dev = flush.device
    dt, hkv, L, S, H, Dh = c["dtype"], c["hkv"], c["L"], 8, 8, 64
    kv = c.get("kv")
    scales = []

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dt)

    def cache(*shape):
        # quantized cases: codes, their scale rows kept in `scales`
        if kv is None:
            return rnd(*shape)
        codes, sc = quantize_kv(rnd(*shape), kv)
        scales.append(sc)
        return codes

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
    lib_scales = None
    if c["mode"] == "paged":
        lp = c["page_len"]
        npg = L // lp
        P = S * npg
        kc, vc = cache(P, lp, hkv, Dh), cache(P, lp, hkv, Dh)
        sk, sv = scales or (None, None)
        pt = torch.randperm(P, generator=gen).reshape(S, npg)
        pt[1:, : npg // 4] = pt[0, : npg // 4]    # a shared prefix chain
        pt = pt.to(dev, torch.int32)
        run = lambda: ba.paged_decode_attention(  # noqa: E731
            q, kc, vc, pt, qpos, scale_k=sk, scale_v=sv)
        plain = lambda: ba.paged_decode_attention_plain(  # noqa: E731
            q, kc, vc, pt, qpos, scale_k=sk, scale_v=sv)
        k_log, v_log = ba.gather_pages(kc, pt), ba.gather_pages(vc, pt)
        if kv is not None:
            lib_scales = (ba.gather_pages(sk, pt), ba.gather_pages(sv, pt))
        extra = pt.numel() * 4 + S * 4
    else:
        kc, vc = cache(S, L, hkv, Dh), cache(S, L, hkv, Dh)
        sk, sv = scales or (None, None)
        run = lambda: ba.banded_decode_attention(  # noqa: E731
            q, kc, vc, qpos, end, window=window, rolling=rolling,
            scale_k=sk, scale_v=sv)
        plain = lambda: ba.decode_attention_plain(  # noqa: E731
            q, kc, vc, qpos, end, window=window, rolling=rolling,
            scale_k=sk, scale_v=sv)
        k_log, v_log = kc, vc
        lib_scales = scales or None
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
    library_ms = time_ms(sdpa_call(q, k_log, v_log, vis, lib_scales), flush)
    rows = kv_rows(vis, pt, lp)
    bms, by = bound(vis, rows, q, hkv, dt, extra, kv)
    row = {"phase": "kernels", "kernel": c["kernel"],
           "dtype": str(dt).replace("torch.", ""),
           "kv_dtype": str(kv or dt).replace("torch.", ""), "S": S, "H": H,
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


# ------------------------------------------------ kernels: banded (B4)
def banded_cases():
    """`path_w`'s shape (B 8, H 8, Hkv 2, T 2048, Dh 64, window 256,
    causal, float32), and the variants the kernel must hold: MHA (Hkv
    8), bidirectional, a window past T, a ragged T with another window,
    bfloat16."""
    f32, bf16 = torch.float32, torch.bfloat16
    base = dict(b=8, h=8, hkv=2, t=2048, dh=64, w=256, causal=True,
                dtype=f32, main=False)
    return [dict(base, main=True), dict(base, hkv=8),
            dict(base, causal=False), dict(base, w=4096),
            dict(base, t=1000, w=100), dict(base, dtype=bf16)]


def banded_bound(c):
    """(bound_ms, bound_by) of B4: its two products over the visible
    (query, key) pairs at the peak rate of its dtype, or the bytes it
    must move (q, k, v read once, o written once) over HBM bandwidth."""
    from deeplearning4j_tpu_torch.ops.banded_attention import band_pairs

    es = torch.tensor([], dtype=c["dtype"]).element_size()
    pairs = c["b"] * c["h"] * band_pairs(c["t"], c["w"], c["causal"])
    flops = 2 * 2 * c["dh"] * pairs
    nbytes = 2 * c["b"] * c["t"] * (c["h"] + c["hkv"]) * c["dh"] * es
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[c["dtype"]] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")), pairs


def run_banded_case(c, flush, gen):
    """B4 against its plain version (the dense band-masked softmax);
    yardstick: SDPA with the band as a boolean mask, GQA enabled."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    dev, dt = flush.device, c["dtype"]
    b, t, h, hkv, dh, w, causal = (c[k] for k in ("b", "t", "h", "hkv",
                                                  "dh", "w", "causal"))

    def rnd(heads):
        return torch.randn(b, t, heads, dh, generator=gen).to(dev, dt)

    q, k, v = rnd(h), rnd(hkv), rnd(hkv)
    run = lambda: ba.banded_attention_fwd(q, k, v, w, causal)  # noqa: E731
    plain = lambda: ba.banded_reference(q, k, v, w, causal)  # noqa: E731
    out, ref = run(), plain()
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    shape = {kk: c[kk] for kk in ("b", "t", "h", "hkv", "dh", "w", "causal")}
    check(bool((diff <= atol + rtol * ref.float().abs()).all()),
          f"banded_attention {shape} {dt}: max abs err {err}, tolerance "
          f"atol {atol} + rtol {rtol} * |ref|")
    del out, ref
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    mask = ba.band_visibility(t, w, causal, dev)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=mask, enable_gqa=hkv != h)
    (bms, by), pairs = banded_bound(c)
    timed_plain = c["main"] or dt == torch.bfloat16
    row = {"phase": "kernels", "kernel": "banded_attention",
           "dtype": str(dt).replace("torch.", ""), **shape,
           "visible_pairs": pairs, "max_abs_err": err, "atol": atol,
           "rtol": rtol, "ms": time_ms(run, flush),
           "plain_ms": time_ms(plain, flush, iters=5) if timed_plain
           else None,
           "library_ms": time_ms(lib, flush, iters=10),
           "bound_ms": bms, "bound_by": by, "main_path_shape": c["main"]}
    emit(row)
    return row


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


# --------------------------------------------- kernels: Nesterovs (B1b)
def run_nesterov_phase(flush, gen):
    """B1b against its plain version over the LSTM training path's real
    leaves (its Nesterovs(0.01, 0.9)) and odd sizes (another momentum),
    float32 and bfloat16. Bound: read p, g, v and write p, v once (5
    tensors of n elements) over HBM bandwidth."""
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    from deeplearning4j_tpu_torch.optim.updaters import tree_leaves

    dev = flush.device
    net = build_lstm_net("cuda", seed=3)
    real = [tuple(p.shape) for p in tree_leaves(net.params_tree)]
    del net
    odd = [(1,), (127,), (4097,), ((1 << 20) + 3,)]
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for leafset, mu in (("real", 0.9), ("odd", 0.8)):
            shapes = real if leafset == "real" else odd
            lr = torch.tensor(0.01, device=dev)
            leaves = [(torch.randn(s, generator=gen).to(dev, dt),
                       torch.randn(s, generator=gen).to(dev, dt),
                       (0.1 * torch.randn(s, generator=gen)).to(dev, dt))
                      for s in shapes]
            ref = [fu.nesterov_update_plain(*leaf, lr, momentum=mu)
                   for leaf in leaves]
            fu.nesterov_update(*zip(*leaves), lr, momentum=mu)
            torch.cuda.synchronize()
            rtol = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -22
            err, ok = 0.0, True
            for (p, _, v), r in zip(leaves, ref):
                for got, want in zip((p, v), r):
                    d = (got.float() - want.float()).abs()
                    err = max(err, d.max().item())
                    ok = ok and bool((d <= rtol * want.float().abs()).all())
            check(ok, f"nesterov_update {leafset} {dt}: max abs err {err} "
                  f"past {rtol} of |ref|")
            n = sum(p.numel() for p, *_ in leaves)
            row = {"phase": "kernels", "kernel": "nesterov_update",
                   "dtype": str(dt).replace("torch.", ""),
                   "leaves": leafset, "n_leaves": len(leaves),
                   "elements": n, "momentum": mu, "max_abs_err": err,
                   "rtol": rtol, "main_path_shape":
                   leafset == "real" and dt == torch.float32,
                   "bound_ms": 5 * n * leaves[0][0].element_size()
                   / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
            lists = list(zip(*leaves))
            row["ms"] = time_ms(lambda: fu.nesterov_update(
                *lists, lr, momentum=mu), flush)
            if leafset == "real":
                row["plain_ms"] = time_ms(lambda: [
                    fu.nesterov_update_plain(*leaf, lr, momentum=mu)
                    for leaf in leaves], flush, iters=10)
                ps = [torch.nn.Parameter(p) for p, *_ in leaves]
                for prm, (_, g, _) in zip(ps, leaves):
                    prm.grad = g
                opt = torch.optim.SGD(ps, lr=0.01, momentum=mu,
                                      nesterov=True, fused=True)
                row["library_ms"] = time_ms(opt.step, flush)
                del opt, ps
            emit(row)
            rows.append(row)
            del leaves, ref, lists
    return rows


# ----------------------------------------------- kernels: LSTM (B2a-c)
def lstm_cases():
    """(T, B, H, input width, which kernels the recurrent paths run at
    this shape): `path_l` trains at T 128; `path_g` trains in chunks of
    T 50, runs `output()` at T 200 and steps at T 1."""
    return [dict(T=128, B=64, H=512, F=128, main=("lstm_fwd", "lstm_bwd",
                                                  "lstm_bwd_weights")),
            dict(T=200, B=32, H=256, F=77, main=("lstm_fwd_inference",)),
            dict(T=50, B=32, H=256, F=77, main=()),
            dict(T=1, B=32, H=256, F=77, main=())]


def lstm_bounds(T, B, H):
    """{kernel: (bound_ms, bound_by)}: each kernel's product, 2·T·B·H·4H
    flops at the float32 peak, against the bytes it must move (inputs
    read once, outputs written once) over HBM bandwidth."""
    ops_ms = 2.0 * T * B * H * 4 * H / PEAK_FLOPS[torch.float32] * 1e3
    seq, small = T * B * H, H * 4 * H + 3 * H + 2 * B * H
    nbytes = {
        # xw, rw, p, h0, c0, mask in; hs, hT, cT (+ cs, gates) out
        "lstm_fwd_inference": 4 * seq + small + T * B + seq + 2 * B * H,
        "lstm_fwd": 4 * seq + small + T * B + 6 * seq + 2 * B * H,
        # dhs, gates, cs, rwT, p, mask, dhT, dcT, c0 in; dxw, dh0, dc0 out
        "lstm_bwd": 6 * seq + small + B * H + T * B + 4 * seq + 2 * B * H,
        # hs, h0, dxw in; drw, dp out
        "lstm_bwd_weights": 5 * seq + B * H + H * 4 * H + 3 * H}
    out = {}
    for k, n in nbytes.items():
        t_bytes = 4.0 * n / HBM_BYTES_PER_S * 1e3
        out[k] = (t_bytes, "bytes") if t_bytes >= ops_ms \
            else (ops_ms, "operations")
    return out


def run_lstm_case(c, flush, gen):
    """Every variant (peepholes on/off x masked or not) of one shape
    against the plain versions; the main variant (peepholes on, masked)
    is the one timed. Tolerances (sums of H products in another order,
    carried through T steps): 1e-4 absolute on hs and the gates, which
    lie in [-1, 1]; 1e-4 of the reference's largest magnitude (at least
    1) on the cell states, which are not bounded, and on each
    gradient."""
    from deeplearning4j_tpu_torch.ops import lstm as lk

    dev = flush.device
    T, B, H, F = c["T"], c["B"], c["H"], c["F"]
    with_bwd = T > 1

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    errs = {k: 0.0 for k in lk.LAUNCHES}
    timed = None
    for peep in (False, True):
        for masked in (False, True):
            xw, rw = rnd(T, B, 4 * H), rnd(H, 4 * H, scale=H ** -0.5)
            p = rnd(3, H, scale=0.5) if peep else torch.zeros(3, H,
                                                              device=dev)
            h0, c0 = rnd(B, H, scale=0.5), rnd(B, H, scale=0.5)
            mask = torch.ones(T, B, device=dev)
            if masked and T > 1:
                lens = torch.randint(T // 4, T, (B,), generator=gen)
                mask = (torch.arange(T)[:, None] < lens[None, :]
                        ).float().to(dev)
            ins = (xw, rw, p, h0, c0, mask)
            tag = f"T{T} B{B} H{H} peep={peep} masked={masked}"
            got = lk.lstm_fwd(*ins, with_residuals=True)
            inf = lk.lstm_fwd(*ins, with_residuals=False)
            ref = lk.lstm_fwd_plain(*ins, with_residuals=True)
            torch.cuda.synchronize()
            e = 0.0
            for name, a, b in zip(("hs", "cs", "gates", "hT", "cT"), got,
                                  ref):
                tol = 1e-4 * max(1.0, b.abs().max().item()) \
                    if name in ("cs", "cT") else 1e-4
                d = (a - b).abs().max().item()
                check(d <= tol, f"lstm_fwd {tag}: {name} err {d} past {tol}")
                e = max(e, d)
            check(all(torch.equal(a, b) for a, b in
                      ((got[0], inf[0]), (got[3], inf[3]), (got[4], inf[4]))),
                  f"lstm_fwd_inference {tag} differs from lstm_fwd")
            errs["lstm_fwd"] = max(errs["lstm_fwd"], e)
            errs["lstm_fwd_inference"] = max(errs["lstm_fwd_inference"], e)
            bw = None
            if with_bwd:
                hs, cs, gates = ref[0], ref[1], ref[2]
                dhs, dhT, dcT = rnd(T, B, H), rnd(B, H), rnd(B, H)
                bw = (rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT, dcT)
                gk = lk.lstm_bwd(*bw)
                gr = lk.lstm_bwd_plain(*bw)
                torch.cuda.synchronize()
                for name, a, b in zip(("dxw", "dh0", "dc0", "drw", "dp"),
                                      gk, gr):
                    tol = 1e-4 * b.abs().max().item()
                    d = (a - b).abs().max().item()
                    check(d <= tol, f"lstm_bwd {tag}: {name} err {d} past "
                          f"{tol} (1e-4 of the largest |ref|)")
                    k = "lstm_bwd_weights" if name in ("drw", "dp") \
                        else "lstm_bwd"
                    errs[k] = max(errs[k], d)
            if peep and masked:
                timed = (ins, bw)
    ins, bw = timed
    xw, rw, p, h0, c0, mask = ins
    runs = {"lstm_fwd": lambda: lk.lstm_fwd(*ins, with_residuals=True),
            "lstm_fwd_inference": lambda: lk.lstm_fwd(
                *ins, with_residuals=False)}
    plain = {"lstm_fwd": lambda: lk.lstm_fwd_plain(*ins),
             "lstm_fwd_inference": lambda: lk.lstm_fwd_plain(
                 *ins, with_residuals=False)}
    # the library yardstick: cuDNN's LSTM over x [T, B, F], which also
    # does the input projection and has no peepholes and no mask
    cudnn = torch.nn.LSTM(F, H).to(dev)
    x = rnd(T, B, F)
    state = (h0[None].contiguous(), c0[None].contiguous())

    def lib_inference():
        with torch.no_grad():
            return cudnn(x, state)

    lib = {"lstm_fwd": lambda: cudnn(x, state),
           "lstm_fwd_inference": lib_inference}
    if with_bwd:
        rwT = rw.t().contiguous()
        _, _, _, hs, cs, gates, _, _, dhs, dhT, dcT = bw
        dxw = lk.launch_bwd_recurrence(rwT, p, mask, cs, gates, c0, dhs,
                                       dhT, dcT)
        runs["lstm_bwd"] = lambda: lk.launch_bwd_recurrence(
            rwT, p, mask, cs, gates, c0, dhs, dhT, dcT)
        runs["lstm_bwd_weights"] = lambda: lk.launch_bwd_weights(
            hs, h0, dxw[0], dxw[3])
        plain["lstm_bwd"] = plain["lstm_bwd_weights"] = \
            lambda: lk.lstm_bwd_plain(*bw)
        y, _ = cudnn(x.requires_grad_(), state)
        wrt = [x] + list(cudnn.parameters())
        lib["lstm_bwd"] = lambda: torch.autograd.grad(
            y, wrt, dhs, retain_graph=True)
        hprev = torch.cat([h0[None], hs[:-1]]).reshape(T * B, H)
        flat = dxw[0].reshape(T * B, 4 * H)
        lib["lstm_bwd_weights"] = lambda: torch.matmul(hprev.t(), flat)
    bounds = lstm_bounds(T, B, H)
    rows = []
    for name, fn in runs.items():
        timed_plain = name in c["main"] or T == 128
        row = {"phase": "kernels", "kernel": name, "dtype": "float32",
               "T": T, "B": B, "H": H, "max_abs_err": errs[name],
               "ms": time_ms(fn, flush),
               "plain_ms": time_ms(plain[name], flush, iters=5)
               if timed_plain else None,
               "library_ms": time_ms(lib[name], flush),
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
               "main_path_shape": name in c["main"]}
        emit(row)
        rows.append(row)
    return rows


# ------------------------------------------------------ serving phases
def build_net(device, *, num_blocks, seed, t=2048, **kw):
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    return TextGenerationTransformer(
        input_shape=(t, 1), d_model=512, num_heads=8,
        num_blocks=num_blocks, seed=seed, **kw).init(device=device)


def control_plane(net, *, slots, chunk, k, kv_dtype=None):
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
                               kv_dtype=kv_dtype, metrics=stats.registry)
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
               slots, chunk, k, kv_dtype=None):
    """Serve each wave through the session manager with every launch
    count zeroed just before and read just after; returns the streams
    and the path's summary line."""
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    registry, sched, mgr = control_plane(net, slots=slots, chunk=chunk, k=k,
                                         kv_dtype=kv_dtype)
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
           "slots": snap["slots"], "kv_dtype": snap["kv_dtype"],
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
    return row, prompts, w1


def build_path_b_net(device):
    return build_net(device, num_blocks=2, seed=11, pos_encoding="rope",
                     norm="rms", ffn_activation="swiglu", num_kv_heads=2,
                     window=256, rolling_cache=True)


def path_b(device, rng):
    """Llama-shaped, 2 blocks, rolling ring (L = 2048 + 256 - 1 = 2303):
    B5 on every decode step; prompts of 2240 + 128 new tokens run past
    the ring's length, so it wraps."""
    net = build_path_b_net(device)
    prompts = [rng.integers(0, 256, 2240) for _ in range(8)]
    greedy = [True] * 6 + [False] * 2
    (streams,), row = drive_path(net, "path_b", "banded_decode_attention",
                                 [prompts], greedy, 128, slots=8, chunk=128,
                                 k=8)
    check(not row["prefix_cache"]["enabled"],
          "path_b: a rolling ring cannot page, yet the prefix cache is on")
    emit(row)
    return row, prompts, streams


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


def prefill_slot0(net, carries, prompt, chunk=128):
    """Step all but the last token of `prompt` through slot 0, in
    valid-masked chunks of `chunk` (a rolling ring takes at most
    max_cache - window + 1 tokens a step)."""
    stem = np.asarray(prompt[:-1], np.float32)
    for i in range(0, len(stem), chunk):
        part = stem[i:i + chunk]
        x = np.zeros((1, chunk, 1), np.float32)
        x[0, :len(part), 0] = part
        valid = np.zeros((1, chunk), np.float32)
        valid[0, :len(part)] = 1.0
        _, carries = net.session_step(x, carries, valid=valid)
    return carries


def teacher_forced_gap(net, prompt, kv_dtype, page_len=None, steps=8):
    """JAX's contract for quantized KV (`tests/test_kv_quant.py:112-124`):
    one native and one quantized carry of the same weights take the same
    prompt, then the same `steps` tokens (the native stream's, so that a
    flipped argmax cannot make the inputs part); returns the largest
    difference of their output probabilities over those steps."""
    carries = {}
    for kd in ("native", kv_dtype):
        c = net.session_carries(1, kv_dtype=kd, page_len=page_len)
        for layer in c.values():
            if "page_table" in layer.get("attn", {}):
                npg = layer["attn"]["page_table"].shape[1]
                layer["attn"]["page_table"][0] = torch.arange(npg)
        carries[kd] = prefill_slot0(net, c, prompt)
    tok, gap = int(prompt[-1]), 0.0
    for _ in range(steps):
        probs = {}
        for kd in carries:
            out, carries[kd] = net.session_step(
                np.full((1, 1, 1), tok, np.float32), carries[kd])
            probs[kd] = out[0, -1].float()
        gap = max(gap, (probs[kv_dtype] - probs["native"]).abs().max()
                  .item())
        tok = int(torch.argmax(probs["native"]))
    return gap


def path_q(native_a, native_b, tol=0.02):
    """Quantized-KV decode serving through `DecodeSessionManager(...,
    kv_dtype=...)`: path_a's net with int8 pages (B6q on every decode
    step) and path_b's ring with e4m3, then int8 codes (B5q), each a
    wave of the native path's own prompts. Each wave is held to JAX's
    contract for quantized KV (`teacher_forced_gap` within `tol`); the
    share of greedy tokens equal to the native wave's is information
    only."""
    greedy = [True] * 6 + [False] * 2
    waves = [("path_q_a_int8", "paged_decode_attention_q", "int8",
              lambda: build_net("cuda", num_blocks=6, seed=7), native_a, 64,
              128),
             ("path_q_b_fp8", "banded_decode_attention_q", "fp8",
              lambda: build_path_b_net("cuda"), native_b, 128, None),
             ("path_q_b_int8", "banded_decode_attention_q", "int8",
              lambda: build_path_b_net("cuda"), native_b, 128, None)]
    rows = []
    for name, kernel, kv, build, (prompts, native), new, page_len in waves:
        net = build()
        (streams,), row = drive_path(net, name, kernel, [prompts], greedy,
                                     new, slots=8, chunk=128, k=8,
                                     kv_dtype=kv)
        native_kernel = kernel[:-2]
        check(row["launches"][native_kernel] == 0,
              f"{name}: the native {native_kernel} ran on a quantized pool")
        check(row["kv_dtype"]["kind"] == row["slots"]["kv_dtype"] == kv,
              f"{name}: pool holds {row['slots']['kv_dtype']}, asked {kv}")
        gap = teacher_forced_gap(net, prompts[0], kv, page_len)
        check(gap <= tol, f"{name}: quantized probabilities differ from the "
              f"native pool's by {gap} (tolerance {tol})")
        same = [a == b for s, n, g in zip(streams, native, greedy) if g
                for a, b in zip(s, n)]
        row.update(teacher_forced_max_prob_gap=gap, tol=tol,
                   greedy_tokens_equal_native_share=sum(same) / len(same))
        emit(row)
        rows.append(row)
        del net
    return rows


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


def reset_all_counts():
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    from deeplearning4j_tpu_torch.ops import lstm as lk

    for mod in (fa, fu, ba, lk):
        mod.reset_counts()


def read_all_counts():
    """(launches, plain calls on CUDA tensors) of every kernel module."""
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    from deeplearning4j_tpu_torch.ops import lstm as lk

    launches, plain = {}, {}
    for mod in (fa, fu, ba, lk):
        launches.update(mod.LAUNCHES)
        plain.update({f"{mod.__name__.rsplit('.', 1)[1]}.{k}": v
                      for k, v in mod.PLAIN_ON_CUDA.items()})
    return launches, plain


def timed_fit(name, net, batches, epochs, tokens_per_step):
    """`net.fit(batches, epochs)` with every launch count zeroed just
    before and read just after. Step times come from CUDA events recorded
    after each step is enqueued; every step after the first runs with
    host syncs made errors; the losses stay on the device until the fit
    has returned. Checks the step count, finite losses and a falling
    epoch mean loss; returns the measurements common to the training
    paths."""
    from deeplearning4j_tpu_torch.optim.listeners import TrainingListener

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
    reset_all_counts()
    t0 = time.perf_counter()
    net.fit(batches, epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_on_cuda = read_all_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in clock.losses]       # read after the steps
    steps = len(losses)
    ev = clock.events
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    per_epoch = len(batches)
    epoch_loss = [float(np.mean(losses[i:i + per_epoch]))
                  for i in range(0, steps, per_epoch)]
    check(steps == epochs * per_epoch, f"{name}: {steps} steps ran")
    check(all(np.isfinite(losses)), f"{name}: losses {losses}")
    check(epoch_loss[-1] < epoch_loss[0],
          f"{name}: mean loss did not fall: {epoch_loss}")
    check(sum(plain_on_cuda.values()) == 0,
          f"{name}: plain versions ran on CUDA tensors: {plain_on_cuda}")
    return {"steps": steps,
            "tokens_per_s_steps_3_12": (steps - 2) * tokens_per_step
            / (ev[2].elapsed_time(ev[steps]) / 1e3),
            "step_ms_p50": float(np.median(step_ms[1:])),
            "step_ms_max": max(step_ms[1:]), "step_ms_first": step_ms[0],
            "step_ms": step_ms, "wall_s": wall,
            "max_memory_allocated_bytes": peak,
            "epoch_mean_loss": epoch_loss, "losses": losses,
            "launches": launches, "plain_on_cuda": plain_on_cuda,
            "sync_debug_mode": "error in steps 2-12"}


def path_t(rng, epochs=3):
    """Full width training: 6 blocks, T 2048, batch 8, float32, the zoo's
    default Adam(3e-4), 4 fixed batches x 3 epochs = 12 steps through
    `net.fit` (`timed_fit`)."""
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    B, T, blocks = 8, 2048, 6
    net = build_net("cuda", num_blocks=blocks, seed=5)
    check(net.conf.updater == Adam(3e-4),
          f"path_t: zoo updater is {net.conf.updater}, not Adam(3e-4)")
    fit = timed_fit("path_t", net, lm_batches(rng, 4, B, T), epochs, B * T)
    steps, launches = fit["steps"], fit["launches"]
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"):
        check(launches[name] == blocks * steps,
              f"path_t: {name} launched {launches[name]} times, want "
              f"{blocks} a step x {steps}")
    check(launches["adam_update"] == steps,
          f"path_t: adam_update launched {launches['adam_update']} times, "
          f"want one a step x {steps}")
    row = {"phase": "path_t", "model": "TextGenerationTransformer",
           "d_model": 512, "heads": 8, "blocks": blocks, "T": T,
           "batch": B, "dtype": "float32", "updater": str(net.conf.updater),
           **fit}
    emit(row)
    return row


def train_parity(rng, name="train_parity", kernel="flash_attention_fwd",
                 steps=2, tol_loss=1e-5, tol_param=1e-5, **net_kw):
    """The port's train step on the card against the CPU: a 2-block model
    at T 256, batch 2, the same seed (so the same weights) and batch,
    `steps` Adam steps; `kernel` must have run on the card. Adam's ε is
    1e-3 here so that a near-zero gradient's first update (≈ lr·sign(g)
    at ε 1e-8) cannot flip with the last bits of a sum; losses agree
    within `tol_loss` relative and every parameter within `tol_param`
    absolute."""
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Adam, tree_leaves

    batch = lm_batches(rng, 1, 2, 256)
    losses, leaves = {}, {}
    for d in ("cuda", "cpu"):
        net = build_net(d, num_blocks=2, seed=17, t=256,
                        updater=Adam(3e-4, epsilon=1e-3), **net_kw)
        scores = CollectScoresIterationListener()
        net.listeners.append(scores)
        reset_all_counts()
        net.fit(batch, epochs=steps)
        if d == "cuda":
            launches, _ = read_all_counts()
            check(launches[kernel] == 2 * steps,
                  f"{name}: {kernel} launched {launches[kernel]} times, "
                  f"want 2 blocks x {steps} steps")
        losses[d] = [sc for _, sc in scores.scores]
        leaves[d] = [p.float().cpu() for p in tree_leaves(net.params_tree)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    dp = max((a - b).abs().max().item()
             for a, b in zip(leaves["cuda"], leaves["cpu"]))
    check(rel <= tol_loss, f"{name}: losses {losses} differ by {rel} "
          f"relative")
    check(dp <= tol_param, f"{name}: parameters differ by {dp}")
    row = {"phase": name, "steps": steps, "losses": losses,
           "loss_rel_err": rel, "tol_loss_rel": tol_loss,
           "max_param_abs_err": dp, "tol_param_abs": tol_param}
    emit(row)
    return row


LLAMA = dict(pos_encoding="rope", norm="rms", ffn_activation="swiglu",
             num_kv_heads=2)


def path_w(rng, epochs=3):
    """Full width training of the sliding-window (Mistral-shaped)
    transformer: 6 Llama blocks (RoPE, RMSNorm, SwiGLU, 2 KV heads under
    8) with window 256, T 2048, batch 8, float32, the zoo's default
    Adam(3e-4), 4 fixed batches x 3 epochs = 12 steps through `net.fit`
    (`timed_fit`): B4 forward in every block and B1a; then one
    `output()` (B4 under no_grad)."""
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    B, T, blocks = 8, 2048, 6
    net = build_net("cuda", num_blocks=blocks, seed=5, window=256, **LLAMA)
    check(net.conf.updater == Adam(3e-4),
          f"path_w: zoo updater is {net.conf.updater}, not Adam(3e-4)")
    batches = lm_batches(rng, 4, B, T)
    fit = timed_fit("path_w", net, batches, epochs, B * T)
    steps, launches = fit["steps"], fit["launches"]
    check(launches["banded_attention"] == blocks * steps,
          f"path_w: banded_attention launched "
          f"{launches['banded_attention']} times, want {blocks} a step x "
          f"{steps}")
    check(launches["adam_update"] == steps,
          f"path_w: adam_update launched {launches['adam_update']} times, "
          f"want one a step x {steps}")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"):
        check(launches[name] == 0, f"path_w: {name} ran in a windowed model")
    t0 = time.perf_counter()
    probs = net.output(batches[0].features)
    torch.cuda.synchronize()
    output_s = time.perf_counter() - t0
    after, plain = read_all_counts()
    check(tuple(probs.shape) == (B, T, 256), f"path_w: output {probs.shape}")
    check(bool(torch.isfinite(probs).all()), "path_w: output not finite")
    check(float((probs.sum(-1) - 1).abs().max()) < 1e-4,
          "path_w: output rows do not sum to 1")
    out_launches = after["banded_attention"] - launches["banded_attention"]
    check(out_launches == blocks, f"path_w: output() launched B4 "
          f"{out_launches} times, want {blocks}")
    check(sum(plain.values()) == 0,
          f"path_w: plain versions ran on CUDA tensors: {plain}")
    row = {"phase": "path_w", "model": "TextGenerationTransformer",
           "d_model": 512, "heads": 8, "kv_heads": 2, "window": 256,
           "blocks": blocks, "T": T, "batch": B, "dtype": "float32",
           "updater": str(net.conf.updater), **fit, "output_s": output_s,
           "output_launches": out_launches}
    emit(row)
    return row


# ----------------------------------------------------- recurrent phases
def build_lstm_net(device, *, seed, h=512, f=128, classes=64, fused=None):
    """The repo's LSTM bench model: GravesLSTM(h) x 2 + RnnOutputLayer,
    tanh, Nesterovs(0.01, 0.9), sequences of any length."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs

    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Nesterovs(0.01, 0.9)).activation("tanh")
            .list(GravesLSTM(n_out=h, fused=fused),
                  GravesLSTM(n_out=h, fused=fused),
                  RnnOutputLayer(n_out=classes, activation="softmax"))
            .set_input_type(InputType.recurrent(f)).build())
    return MultiLayerNetwork(conf, device=device).init()


def seq_batches(rng, n, batch, t, f, classes, masked=()):
    """`n` fixed DataSets: standard-normal features [batch, t, f], random
    one-hot labels; the batches listed in `masked` carry a features mask
    of ragged lengths in [t/4, t)."""
    from deeplearning4j_tpu_torch.data import DataSet

    eye = np.eye(classes, dtype=np.float32)
    out = []
    for i in range(n):
        x = rng.standard_normal((batch, t, f)).astype(np.float32)
        y = eye[rng.integers(0, classes, (batch, t))]
        fm = None
        if i in masked:
            lens = rng.integers(t // 4, t, batch)
            fm = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        out.append(DataSet(x, y, fm, None))
    return out


def onehot_batches(rng, n, batch, t, vocab):
    """`n` fixed DataSets of random characters, one-hot [batch, t, vocab],
    with next-character labels."""
    from deeplearning4j_tpu_torch.data import DataSet

    eye = np.eye(vocab, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (batch, t + 1))
        out.append(DataSet(eye[ids[:, :t]], eye[ids[:, 1:]]))
    return out


def path_l(rng, epochs=3):
    """Full width LSTM training: GravesLSTM(512) x 2, T 128, batch 64,
    float32, Nesterovs(0.01, 0.9); 4 fixed batches (two masked) x 3
    epochs = 12 steps through `net.fit` (`timed_fit`)."""
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs

    B, T = 64, 128
    net = build_lstm_net("cuda", seed=5)
    check(net.conf.updater == Nesterovs(0.01, 0.9),
          f"path_l: updater is {net.conf.updater}")
    batches = seq_batches(rng, 4, B, T, 128, 64, masked=(1, 3))
    fit = timed_fit("path_l", net, batches, epochs, B * T)
    steps, launches = fit["steps"], fit["launches"]
    for name in ("lstm_fwd", "lstm_bwd", "lstm_bwd_weights"):
        check(launches[name] == 2 * steps,
              f"path_l: {name} launched {launches[name]} times, want 2 a "
              f"step x {steps}")
    check(launches["nesterov_update"] == steps,
          f"path_l: nesterov_update launched {launches['nesterov_update']} "
          f"times, want one a step x {steps}")
    check(launches["lstm_fwd_inference"] == 0,
          "path_l: the inference kernel ran in a train step")
    row = {"phase": "path_l", "model": "GravesLSTM x 2 + RnnOutputLayer",
           "hidden": 512, "n_in": 128, "classes": 64, "T": T, "batch": B,
           "dtype": "float32", "updater": str(net.conf.updater),
           "masked_batches": 2, **fit}
    emit(row)
    return row


def path_g(rng, calls=200):
    """The zoo LSTM at its own width: tBPTT fit, `output()`, then a
    greedy stepping loop of `calls` `rnn_time_step` calls for 32 streams,
    each fed the one-hot of its last argmax. The loop's tokens are read
    once, after it."""
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    B, T, V = 32, 200, 77
    net = TextGenerationLSTM(input_shape=(T, V), seed=9).init(device="cuda")
    check(net.conf.updater == Adam(1e-3) and net.conf.tbptt_fwd_length == 50,
          f"path_g: zoo updater {net.conf.updater}, tbptt "
          f"{net.conf.tbptt_fwd_length}")
    batches = onehot_batches(rng, 2, B, T, V)
    torch.cuda.synchronize()
    reset_all_counts()
    t0 = time.perf_counter()
    net.fit(batches, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches, _ = read_all_counts()
    chunks = 2 * (T // 50)
    for name in ("lstm_fwd", "lstm_bwd", "lstm_bwd_weights"):
        check(fit_launches[name] == 2 * chunks,
              f"path_g: {name} launched {fit_launches[name]} times in the "
              f"tBPTT fit, want 2 a chunk x {chunks}")
    check(fit_launches["adam_update"] == chunks,
          f"path_g: adam_update launched {fit_launches['adam_update']} "
          f"times, want one a chunk x {chunks}")
    check(net.iteration == 2, f"path_g: {net.iteration} iterations for 2 "
          f"batches")
    check(np.isfinite(net.score_), f"path_g: loss {net.score_}")

    probs = net.output(batches[0].features)
    torch.cuda.synchronize()
    after_output, _ = read_all_counts()
    check(tuple(probs.shape) == (B, T, V), f"path_g: output {probs.shape}")
    check(bool(torch.isfinite(probs).all()), "path_g: output is not finite")
    check(float((probs.sum(-1) - 1).abs().max()) < 1e-4,
          "path_g: output rows do not sum to 1")
    check(after_output["lstm_fwd_inference"] == 2,
          "path_g: output() did not run the inference kernel twice")

    net.rnn_clear_previous_state()
    eye = torch.eye(V, device=net.device)
    tok = first = torch.as_tensor(rng.integers(0, V, B), device=net.device)
    stream, stepped = [], []
    net.rnn_time_step(eye[tok])               # warm-up call, not timed
    net.rnn_clear_previous_state()
    torch.cuda.synchronize()
    before, _ = read_all_counts()
    host_ms = []
    t0 = time.perf_counter()
    for _ in range(calls):
        t1 = time.perf_counter()
        out = net.rnn_time_step(eye[tok])
        tok = torch.argmax(out[:, -1, :], dim=-1)
        stream.append(tok)
        stepped.append(out[:, -1, :])
        host_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches, plain_on_cuda = read_all_counts()
    toks = torch.stack(stream, dim=1).cpu().numpy()
    step_launches = launches["lstm_fwd_inference"] \
        - before["lstm_fwd_inference"]
    check(step_launches == 2 * calls,
          f"path_g: {step_launches} inference launches in {calls} calls, "
          f"want 2 a call")
    check(toks.shape == (B, calls) and toks.min() >= 0 and toks.max() < V,
          "path_g: stepping produced an out-of-vocabulary token")
    check(sum(plain_on_cuda.values()) == 0,
          f"path_g: plain versions ran on CUDA tensors: {plain_on_cuda}")
    # stepping one token at a time with carried state equals `output()`
    # over the same tokens fed at once
    fed = torch.cat([first[:, None], torch.stack(stream, dim=1)[:, :-1]],
                    dim=1)
    whole = net.output(eye[fed])
    step_err = float((whole - torch.stack(stepped, dim=1)).abs().max())
    check(step_err <= 1e-4, f"path_g: stepping differs from output() over "
          f"the same tokens by {step_err}")
    row = {"phase": "path_g", "model": "TextGenerationLSTM", "hidden": 256,
           "vocab": V, "T": T, "batch": B, "tbptt": 50, "dtype": "float32",
           "updater": str(net.conf.updater), "fit_s": fit_s,
           "fit_loss": net.score_, "fit_launches": fit_launches,
           "streams": B, "calls": calls, "loop_s": loop_s,
           "tokens_per_s": B * calls / loop_s,
           "call_ms_p50": float(np.median(host_ms)),
           "call_ms_p99": float(np.percentile(host_ms, 99)),
           "stepping_vs_output_max_abs_err": step_err,
           "launches": launches, "plain_on_cuda": plain_on_cuda}
    emit(row)
    return row


def lstm_parity(rng, tol=1e-4):
    """Both recurrent models, 2 layers at full width but T 32 and batch
    4, on the card against the CPU (which runs the plain versions): two
    `fit` steps, then 8 `rnn_time_step` calls. Losses within `tol`
    relative, parameters and step outputs within `tol` absolute. Adam's
    ε is 1e-3 here, as in `train_parity`."""
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Adam, tree_leaves
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    T, B = 32, 4
    models = {
        "lstm_bench": (lambda d: build_lstm_net(d, seed=21),
                       seq_batches(rng, 2, B, T, 128, 64, masked=(1,)),
                       rng.standard_normal((8, B, 128)).astype(np.float32)),
        "text_generation_lstm": (
            lambda d: TextGenerationLSTM(
                input_shape=(T, 77), seed=22,
                updater=Adam(1e-3, epsilon=1e-3)).init(device=d),
            onehot_batches(rng, 2, B, T, 77),
            np.eye(77, dtype=np.float32)[rng.integers(0, 77, (8, B))])}
    row = {"phase": "lstm_parity", "tol": tol, "models": {}}
    for name, (build, batches, steps) in models.items():
        losses, leaves, outs = {}, {}, {}
        for d in ("cuda", "cpu"):
            net = build(d)
            scores = CollectScoresIterationListener()
            net.listeners.append(scores)
            net.fit(batches, epochs=1)
            losses[d] = [sc for _, sc in scores.scores]
            leaves[d] = [p.float().cpu()
                         for p in tree_leaves(net.params_tree)]
            outs[d] = [net.rnn_time_step(x).float().cpu() for x in steps]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        dp = max((a - b).abs().max().item()
                 for a, b in zip(leaves["cuda"], leaves["cpu"]))
        do = max((a - b).abs().max().item()
                 for a, b in zip(outs["cuda"], outs["cpu"]))
        check(rel <= tol, f"lstm_parity {name}: losses {losses} differ by "
              f"{rel} relative")
        check(dp <= tol, f"lstm_parity {name}: parameters differ by {dp}")
        check(do <= tol, f"lstm_parity {name}: step outputs differ by {do}")
        row["models"][name] = {"losses": losses, "loss_rel_err": rel,
                               "max_param_abs_err": dp,
                               "max_step_output_abs_err": do}
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
    rows += [run_banded_case(c, flush, gen) for c in banded_cases()]
    rows += run_adam_phase(flush, gen)
    rows += run_nesterov_phase(flush, gen)
    for c in lstm_cases():
        rows += run_lstm_case(c, flush, gen)
    del flush
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    a, *native_a = path_a("cuda", rng)
    b, *native_b = path_b("cuda", rng)
    cpu_parity(rng)
    qa, qb_fp8, qb_int8 = path_q(native_a, native_b)
    t = path_t(rng)
    train_parity(rng)
    w = path_w(rng)
    train_parity(rng, "window_parity", "banded_attention", window=32,
                 **LLAMA)
    lp = path_l(rng)
    g = path_g(rng)
    lstm_parity(rng)

    b5q = {"banded_decode_attention_q":
           qb_fp8["launches"]["banded_decode_attention_q"]
           + qb_int8["launches"]["banded_decode_attention_q"]}
    summary = []
    for name, launches in (
            ("banded_decode_attention", b["launches"]),
            ("paged_decode_attention", a["launches"]),
            ("banded_decode_attention_q", b5q),
            ("paged_decode_attention_q", qa["launches"]),
            ("banded_attention", w["launches"]),
            ("flash_attention_fwd", t["launches"]),
            ("flash_attention_bwd_dkdv", t["launches"]),
            ("flash_attention_bwd_dq", t["launches"]),
            ("adam_update", t["launches"]),
            ("nesterov_update", lp["launches"]),
            ("lstm_fwd", lp["launches"]),
            ("lstm_fwd_inference", g["launches"]),
            ("lstm_bwd", lp["launches"]),
            ("lstm_bwd_weights", lp["launches"])):
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
        if name == "lstm_fwd_inference":
            # most of its launches on path_g are the stepping loop's, at T 1
            summary[-1]["ms_at_T1"] = next(r["ms"] for r in mine
                                           if r["T"] == 1)
    emit({"kernels": summary})
    print(gpu_name_and_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
