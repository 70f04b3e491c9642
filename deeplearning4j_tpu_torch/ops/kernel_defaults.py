"""Dispatch policies of the port (counterpart of
`deeplearning4j_tpu/ops/kernel_defaults.py`): decode attention, the
decode loop, KV storage dtype and the prefix cache (serving), and
full-context attention and the fused optimizer update (training).

Same defaults as the JAX package: the fused K=8 decode window, native
KV storage, and the paged prefix cache whenever the model can page.
Each verdict is capability, then the structural default: the port has
no measured rows yet. The TPU's rules are gone: there is no backend
check and no 128-multiple page, cache or sequence rule, because the
CUDA kernels take any length. So full-context attention goes to the
flash kernels at any T, and Adam to the fused kernel, wherever the
shape allows — JAX's measured-winner tables describe another chip. The
JAX package's env hatches are not mirrored; callers choose through the
arguments.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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


class KVDtypePolicy(NamedTuple):
    kind: str            # "native" | "int8" | "fp8"
    reason: str


def kv_dtype_policy(kind: Optional[str] = None, *,
                    record: bool = True) -> KVDtypePolicy:
    """KV cache storage dtype: the caller's request, else the model
    dtype. int8/fp8 are recognised (the pool then refuses them: their
    scale rows are not ported yet), unknown names fail."""
    want = (kind or "").strip().lower()
    if want not in ("", "auto", "native", "int8", "fp8"):
        raise ValueError(f"unknown kv_dtype {want!r} "
                         "(expected native|int8|fp8)")
    if want in ("native", "int8", "fp8"):
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
    caches. On whenever the model is capable (no rolling rings, uniform
    max_cache). The page length (default 128) is snapped down to the
    largest divisor of `max_cache`; the paged kernel takes any length."""
    if not capable:
        if record:
            record_dispatch("prefix_cache", "off")
        return PrefixCachePolicy("off", 0, "model cannot page its KV "
                                 "(rolling rings or non-uniform max_cache)")
    want = max(1, int(page_len)) if page_len else 128
    if max_cache:
        mc = int(max_cache)
        want = min(want, mc)
        while mc % want:
            want -= 1
    if record:
        record_dispatch("prefix_cache", "paged")
    return PrefixCachePolicy("paged", want, "structural default: a warm "
                             "prefix replaces its whole prefill")


class AttentionPolicy(NamedTuple):
    kind: str            # "flash" | "dense"
    reason: str


def attention_policy(*, device="cuda", masked: bool = False,
                     dropout: bool = False, window: Optional[int] = None,
                     head_dim: int = 64) -> AttentionPolicy:
    """Full-context (`apply`) attention: the flash kernels B3a/B3b/B3c
    (`ops/attention.flash_attention`) or the dense masked softmax.

    Flash whenever the structure allows, at any Tq and Tk and in training
    as in inference: the dense path holds B·H·Tq·Tk float32 scores (1 GiB
    a layer at batch 8, 8 heads, T 2048) before softmax and its gradient.
    A padding mask or attention dropout needs the dense path, as in JAX
    (the weights never materialize inside the kernels); so does a sliding
    window until the banded kernel B4 is ported. On CPU tensors "flash"
    means the kernels' plain versions; the count records impl="plain".
    On the card a head dim past the kernels' largest tile is refused:
    a CUDA tensor never falls back to a plain version."""
    from deeplearning4j_tpu_torch.ops.attention import MAX_HEAD_DIM

    on_card = torch.device(device).type == "cuda"
    if masked or dropout:
        kind, reason = "dense", ("a padding mask" if masked
                                 else "attention dropout") + \
            " needs the attention weights"
    elif window is not None:
        kind, reason = "dense", "banded kernel B4 not ported"
    elif on_card and head_dim > MAX_HEAD_DIM:
        raise ValueError(f"no CUDA flash kernel for head dim {head_dim}: "
                         f"the kernels take at most {MAX_HEAD_DIM}")
    else:
        kind = "flash"
        reason = ("the hand-written CUDA flash kernels" if on_card
                  else "the flash kernels' plain versions (CPU tensors)")
    record_dispatch("attention", kind if (on_card or kind == "dense")
                    else "plain")
    return AttentionPolicy(kind, reason)


class FusedUpdatePolicy(NamedTuple):
    kind: str            # "fused" | "plain"
    reason: str


def fused_update_policy(kind: str, device="cuda") -> FusedUpdatePolicy:
    """Optimizer read-modify-write: Adam goes to the fused kernel B1a on
    the card (its plain version on CPU tensors); Nesterovs runs plain
    tensor math everywhere until B1b is ported."""
    op = {"adam": "adam_update", "nesterov": "nesterov_update"}.get(kind)
    if op is None:
        raise ValueError(f"unknown fused update {kind!r} "
                         "(expected adam|nesterov)")
    on_card = torch.device(device).type == "cuda"
    if kind == "adam" and on_card:
        pol = FusedUpdatePolicy("fused", "the hand-written CUDA kernel B1a")
    elif kind == "adam":
        pol = FusedUpdatePolicy("plain", "the kernel's plain version "
                                "(CPU tensors)")
    else:
        pol = FusedUpdatePolicy("plain", "kernel B1b not ported")
    record_dispatch(op, pol.kind)
    return pol
