"""Dispatch policies of the port (counterpart of
`deeplearning4j_tpu/ops/kernel_defaults.py`): decode attention, the
decode loop, speculative decoding, KV storage dtype and the prefix cache
(serving), and
full-context and sliding-window attention, the LSTM recurrence, the
fused optimizer update and the fused conv+BN statistics (training).

Same defaults as the JAX package: the fused K=8 decode window, spec
decoding at k=8 whenever a rewindable draft is wired up, native KV
storage, and the paged prefix cache whenever the model can page.
Each verdict is capability, then the structural default: the port has
no measured rows yet. The TPU's rules are gone: there is no backend
check and no 128-multiple page, cache or sequence rule, because the
CUDA kernels take any length. So full-context attention goes to the
flash kernels and windowed attention to the banded kernel at any T, a
sigmoid/tanh LSTM to the fused sequence
kernels, and Adam and Nesterovs to the fused update kernels, wherever
the shape allows — JAX's measured-winner tables describe another chip. Of
the JAX package's env hatches only the prefix cache's are mirrored
(`DL4J_TPU_PREFIX_CACHE`, `DL4J_TPU_KV_PAGE`); elsewhere callers choose
through the arguments.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch


def _env(name: str, default: str = "auto") -> str:
    v = os.environ.get(name, default).strip().lower()
    return v or default


def record_dispatch(op: str, impl: str) -> None:
    """Count a policy verdict on the shared metrics spine:
    `kernel_dispatch_total{op, impl}`."""
    from deeplearning4j_tpu_torch.observe import get_registry

    get_registry().counter("kernel_dispatch_total", op=op, impl=impl).inc()


class DecodePolicy(NamedTuple):
    kernel: str          # "paged_decode_attention" | "banded_decode_attention"
    reason: str


def decode_attention_policy(h: int, hkv: int, dh: int, *, paged: bool,
                            device="cuda",
                            record: bool = True) -> DecodePolicy:
    """Single-token decode-step attention: always the decode kernel, B6
    over a paged pool and B5 over the slot pool. Its wrapper launches the
    CUDA kernel on a CUDA device and takes the plain version on the CPU;
    there is no dense alternative on the card, so a shape past the
    kernels' register tiles (`decode_eligible`) is refused here, before
    a session runs."""
    from deeplearning4j_tpu_torch.ops.banded_attention import (
        MAX_GROUP, MAX_HEAD_DIM, decode_eligible,
    )

    kernel = "paged_decode_attention" if paged else \
        "banded_decode_attention"
    on_card = torch.device(device).type == "cuda"
    if on_card and not decode_eligible(h, hkv, dh):
        raise ValueError(
            f"no CUDA decode kernel for h={h}, hkv={hkv}, dh={dh}: the "
            f"kernels take at most {MAX_GROUP} query heads per KV head "
            f"and an even head dim of at most {MAX_HEAD_DIM}")
    if record:
        record_dispatch("decode_attention", kernel)
    return DecodePolicy(kernel, "the hand-written CUDA kernel" if on_card
                        else "the kernel's plain version (CPU tensors)")


class DecodeLoopPolicy(NamedTuple):
    kind: str            # "fused" | "stepwise"
    k: int               # window length (1 when stepwise)
    reason: str


DECODE_K_BUCKETS = (1, 2, 4, 8, 16)


def _bucket_k(k: int) -> int:
    for b in DECODE_K_BUCKETS:
        if b >= k:
            return b
    return DECODE_K_BUCKETS[-1]


def decode_loop_policy(k: Optional[int] = None, *, capable: bool = True,
                       record: bool = True) -> DecodeLoopPolicy:
    """Fused-K decode window (K steps per dispatch, sampling on the
    device, one host read per window) vs one token per dispatch for a
    model without `session_decode_window`. `k` (default 8) is snapped to
    DECODE_K_BUCKETS."""
    if not capable:
        if record:
            record_dispatch("decode_loop", "stepwise")
        return DecodeLoopPolicy("stepwise", 1,
                                "model has no session_decode_window")
    if record:
        record_dispatch("decode_loop", "fused")
    return DecodeLoopPolicy(
        "fused", _bucket_k(8 if k is None else max(1, int(k))),
        "structural default: K-fold fewer host round-trips for the same "
        "per-step forward")


class SpecDecodePolicy(NamedTuple):
    kind: str            # "spec" | "plain"
    k: int               # draft window length (0 when plain)
    reason: str


def spec_decode_policy(k: Optional[int] = None, *, capable: bool = True,
                       record: bool = True) -> SpecDecodePolicy:
    """Draft-model speculative decoding (the draft proposes k tokens a
    lane, the target verifies all of them in one chunked forward,
    accept/reject on the device) vs the plain fused window. On whenever
    a draft is wired up and both nets can rewind their caches;
    `capable=False` (no draft, recurrent carries or rolling rings)
    degrades to plain. `k` (default 8) is snapped to DECODE_K_BUCKETS.
    Counts `kernel_dispatch_total{op="spec_decode"}`."""
    if not capable:
        if record:
            record_dispatch("spec_decode", "plain")
        return SpecDecodePolicy(
            "plain", 0, "no rewindable draft/target pair (draft missing, "
            "recurrent carries, or rolling KV rings)")
    if record:
        record_dispatch("spec_decode", "spec")
    return SpecDecodePolicy(
        "spec", _bucket_k(8 if k is None else max(1, int(k))),
        "structural default: one chunk verify replaces D sequential "
        "target dispatches")


class KVDtypePolicy(NamedTuple):
    kind: str            # "native" | "int8" | "fp8"
    reason: str


def fp8_capable(device="cuda") -> bool:
    """e4m3 KV storage needs a card where e4m3 is native: a CUDA device
    of compute capability 8.9 or later (the counterpart of JAX's
    `_fp8_capable`, which asks for a TPU backend)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(dev) >= (8, 9)


def kv_dtype_policy(kind: Optional[str] = None, *, device="cuda",
                    record: bool = True) -> KVDtypePolicy:
    """KV cache storage dtype: the caller's request, else the model
    dtype (quantization is opt-in per deployment). "int8" stores K/V as
    int8 codes with one float32 scale per (token, kv head); "fp8" stores
    e4m3 codes with the same scale rows where the device has native e4m3
    (`fp8_capable`) and falls back to int8 elsewhere, as the JAX policy
    does. Unknown names fail."""
    want = (kind or "").strip().lower()
    if want not in ("", "auto", "native", "int8", "fp8"):
        raise ValueError(f"unknown kv_dtype {want!r} "
                         "(expected native|int8|fp8)")
    if want == "fp8" and not fp8_capable(device):
        kd, reason = "int8", ("caller=fp8 but backend lacks e4m3 support; "
                              "int8 carries the same scale rows")
    elif want in ("native", "int8", "fp8"):
        kd, reason = want, f"asked for by the caller: {want}"
    else:
        kd, reason = "native", "quantization is opt-in per deployment"
    if record:
        record_dispatch("kv_dtype", kd)
    return KVDtypePolicy(kd, reason)


class PrefixCachePolicy(NamedTuple):
    kind: str            # "paged" | "off"
    page_len: int        # KV page length in tokens (0 when off)
    reason: str


def prefix_cache_policy(page_len: Optional[int] = None, *,
                        max_cache: Optional[int] = None,
                        capable: bool = True,
                        record: bool = True) -> PrefixCachePolicy:
    """Paged KV storage + radix prefix cache vs monolithic per-slot
    caches, in the JAX package's order and with its reasons: the
    environment's force (`DL4J_TPU_PREFIX_CACHE=off|on`), then
    capability, then the structural default, ON when the model is capable
    (no recurrent carries, no rolling rings, uniform max_cache, no active
    draft). The page length (`DL4J_TPU_KV_PAGE`, else `page_len`, default
    128) is snapped down to the largest divisor of `max_cache`; the paged
    kernel takes any length."""
    forced = _env("DL4J_TPU_PREFIX_CACHE")
    env_p = os.environ.get("DL4J_TPU_KV_PAGE", "").strip()
    if env_p:
        page_len = int(env_p)
    want = max(1, int(page_len)) if page_len else 128
    if max_cache:
        mc = int(max_cache)
        want = min(want, mc)
        while mc % want:
            want -= 1

    def paged(reason):
        if record:
            record_dispatch("prefix_cache", "paged")
        return PrefixCachePolicy("paged", want, reason)

    def off(reason):
        if record:
            record_dispatch("prefix_cache", "off")
        return PrefixCachePolicy("off", 0, reason)

    if forced == "off":
        return off("forced by DL4J_TPU_PREFIX_CACHE=off")
    if forced == "on":
        if not capable:
            return off("DL4J_TPU_PREFIX_CACHE=on but the model cannot "
                       "page its KV (recurrent carries, rolling rings, "
                       "non-uniform max_cache, or active draft model)")
        return paged("forced by DL4J_TPU_PREFIX_CACHE=on")
    if not capable:
        return off("model cannot page its KV (recurrent carries, "
                   "rolling rings, non-uniform max_cache, or active "
                   "draft model)")
    return paged("structural default: a warm prefix replaces its whole "
                 "prefill; admission-time bookkeeping costs the "
                 "steady-state window nothing")


class AttentionPolicy(NamedTuple):
    kind: str            # "flash" | "banded" | "dense"
    reason: str


def attention_policy(*, device="cuda", masked: bool = False,
                     dropout: bool = False, window: Optional[int] = None,
                     head_dim: int = 64) -> AttentionPolicy:
    """Full-context (`apply`) attention: the flash kernels B3a/B3b/B3c
    (`ops/attention.flash_attention`), the banded kernel B4
    (`ops/banded_attention.banded_attention`) or the dense masked
    softmax.

    A sliding window goes to B4 and a full context to flash, at any T
    and in training as in inference: the dense path holds B·H·Tq·Tk
    float32 scores (1 GiB a layer at batch 8, 8 heads, T 2048) before
    softmax and its gradient. A padding mask or attention dropout needs
    the dense path, as in JAX (the weights never materialize inside the
    kernels). On CPU tensors "flash" and "banded" mean the kernels'
    plain versions; the count records impl="plain". On the card a head
    dim past the kernels' largest tile is refused: a CUDA tensor never
    falls back to a plain version."""
    from deeplearning4j_tpu_torch.ops.attention import MAX_HEAD_DIM

    on_card = torch.device(device).type == "cuda"
    if masked or dropout:
        kind, reason = "dense", ("a padding mask" if masked
                                 else "attention dropout") + \
            " needs the attention weights"
    else:
        kind = "flash" if window is None else "banded"
        if on_card and head_dim > MAX_HEAD_DIM:
            raise ValueError(f"no CUDA {kind} kernel for head dim "
                             f"{head_dim}: the kernels take at most "
                             f"{MAX_HEAD_DIM}")
        reason = (f"the hand-written CUDA {kind} kernels" if on_card
                  else f"the {kind} kernels' plain versions (CPU tensors)")
    record_dispatch("attention", kind if (on_card or kind == "dense")
                    else "plain")
    return AttentionPolicy(kind, reason)


class FusedUpdatePolicy(NamedTuple):
    kind: str            # "fused" | "plain"
    reason: str


def fused_update_policy(kind: str, device="cuda",
                        design: Optional[str] = None) -> FusedUpdatePolicy:
    """Optimizer read-modify-write: Adam goes to the fused kernel B1a and
    Nesterovs to B1b on the card, each to its kernel's plain version on
    CPU tensors. Each launch asks once (`fused_update.UpdatePlan.launch`)
    and counts `kernel_dispatch_total{op="adam_update"|"nesterov_update"}`
    with impl "fused/<design>" on the card, "plain" on the CPU."""
    op = {"adam": "adam_update", "nesterov": "nesterov_update"}.get(kind)
    if op is None:
        raise ValueError(f"unknown fused update {kind!r} "
                         "(expected adam|nesterov)")
    if torch.device(device).type == "cuda":
        pol = FusedUpdatePolicy("fused", "the hand-written CUDA kernel "
                                + ("B1a" if kind == "adam" else "B1b"))
    else:
        pol = FusedUpdatePolicy("plain", "the kernel's plain version "
                                "(CPU tensors)")
    record_dispatch(op, f"{pol.kind}/{design}"
                    if design and pol.kind == "fused" else pol.kind)
    return pol


class LSTMPolicy(NamedTuple):
    kind: str            # "fused" | "loop"
    reason: str


def lstm_policy(gate_activation: str, activation: Optional[str], *,
                fused: Optional[bool] = None, device="cuda",
                hidden: int = 1) -> LSTMPolicy:
    """The LSTM recurrence: the fused sequence kernels B2a/B2b/B2c
    (`ops/lstm.fused_lstm`) or the per-step loop in plain PyTorch.

    The kernels hard-code sigmoid gates and a tanh cell, so any other
    pair takes the loop, as the JAX package sends it to its scan (no
    kernel exists for it there either); `activation=None` is identity,
    not tanh. A layer's own `fused=False` takes the loop; `None` and
    `True` take the kernels, and `True` with other activations is an
    error. On CPU tensors "fused" means the kernels' plain versions; the
    count records impl="plain". On the card a hidden size past the
    kernels' shared-memory tile is refused: a CUDA tensor never falls
    back to a plain version. The kernels take float32 (`b2_design` and
    `b2c_design` choose design 1 or 2 by shape) and bfloat16 (design 1,
    "cluster" and "tiled", at every shape); another dtype on the card is
    refused by the kernels' wrapper."""
    from deeplearning4j_tpu_torch.ops.lstm import (
        MAX_HIDDEN, fused_lstm_available,
    )

    ok = fused_lstm_available(gate_activation, activation)
    if fused and not ok:
        raise ValueError(
            f"fused=True requires gate_activation='sigmoid' and "
            f"activation='tanh'; got {gate_activation!r}/{activation!r}")
    on_card = torch.device(device).type == "cuda"
    if fused is False:
        pol = LSTMPolicy("loop", "the layer asked for it (fused=False)")
    elif not ok:
        pol = LSTMPolicy("loop", "the kernels compute sigmoid gates and a "
                         "tanh cell only")
    elif on_card and hidden > MAX_HIDDEN:
        raise ValueError(f"no CUDA LSTM kernel for hidden size {hidden}: "
                         f"the kernels take at most {MAX_HIDDEN}")
    else:
        pol = LSTMPolicy("fused", "the hand-written CUDA LSTM kernels"
                         if on_card else
                         "the LSTM kernels' plain versions (CPU tensors)")
    record_dispatch("lstm", pol.kind if (on_card or pol.kind == "loop")
                    else "plain")
    return pol


class ConvFusedPolicy(NamedTuple):
    kind: str            # "fused" | "plain" | "fold"
    reason: str


def conv_fused_policy(dtype, *, train: bool,
                      device="cuda") -> ConvFusedPolicy:
    """A `FusedConvBNLayer` forward: in training, the conv+BN statistics
    kernels B7a (1x1) and B7b (3x3) on the card, their plain versions on
    CPU tensors; in eval, the running statistics folded into one epilogue
    of a plain product or convolution (no kernel, as in JAX). The kernels
    take float32 and bfloat16: another dtype on the card is refused here,
    never sent to a plain version."""
    on_card = torch.device(device).type == "cuda"
    if not train:
        pol = ConvFusedPolicy("fold", "eval folds the running statistics "
                              "into one affine epilogue")
    elif on_card:
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the conv+BN statistics kernels take float32 "
                            f"or bfloat16, got {dtype}")
        pol = ConvFusedPolicy("fused", "the hand-written CUDA kernels "
                              "B7a/B7b")
    else:
        pol = ConvFusedPolicy("plain", "the kernels' plain versions (CPU "
                              "tensors)")
    record_dispatch("conv_fused", pol.kind)
    return pol
