"""Banded (sliding-window) attention and single-query decode attention
over the serving KV pool — the port of
`deeplearning4j_tpu/ops/banded_attention.py`.

Three kernels, hand-written in CUDA C++ for Hopper, each with its plain
PyTorch version beside it:

- `banded_attention` (kernel B4, `csrc/banded_attention.cu`, replaces
  `_banded_kernel`): full-sequence sliding-window attention on the JAX
  layouts q [B, T, H, Dh], k/v [B, T, Hkv, Dh], causal
  (`q - w < k <= q`) or bidirectional (`|q - k| < w`), GQA-native (a
  query head reads its KV head's band by strides; K/V are never
  broadcast to H heads). A block visits only the key tiles that meet its
  band (`band_key_tiles`), so the work grows as T·w. Two designs, chosen
  by `b4_design` before the launch: "folded" (design 2) for float32 at
  Dh 32, 64 or 128 with H / Hkv in {1, 2, 4, 8} — the G heads of a group
  folded into one block's 128 rows, so K/V tiles are staged once a
  group, through a cp.async ring, masked only where the band cuts them
  (`band_tile_whole`) — and "ffma" (design 1, one head's 64 rows a
  block) for bfloat16 and every other shape. Its backward is
  the JAX package's: a dense band-masked recompute (`banded_dense`)
  under autograd, which holds B·H·T² float32 scores transiently;
- `banded_decode_attention` (kernel B5, `csrc/decode_attention.cu`,
  replaces `_decode_kernel`) over the slot pool `[S, L, Hkv, Dh]`:
  linear visibility with an optional window, or a rolling ring;
- `paged_decode_attention` (kernel B6, replaces `_paged_decode_kernel`)
  over a physical page pool `[P, Lp, Hkv, Dh]` through `page_table`.

B5 and B6 take quantized caches too (the TPU bodies' `quant=True`
branch): int8 or e4m3 codes with float32 scale rows `[.., L, Hkv]`, one
scale per (token, kv head), dequantized on load in float32. Their
launches count apart, as `banded_decode_attention_q` and
`paged_decode_attention_q`.

B6/B6q and B5/B5q come in two designs, chosen by `b6_design` and
`b5_design` before the launch: "split" (design 2) for float32 queries
over float32, int8 or e4m3 caches at Dh 64 or 128 — each slot's key
range split over many blocks (`b6_splits` pages, `b5_splits` positions
a block), keys streamed through shared memory, one merge in fixed order
— and "ffma" (design 1, one block a slot and KV head) for bfloat16 and
every other shape. `LAUNCHES_BY_DESIGN[(kernel, design)]` counts the
launches of all three kernels by design.

A wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises — there is no fallback. Each
wrapper adds one to `LAUNCHES[name]` where it launches its kernel, and
each plain version adds one to `PLAIN_ON_CUDA[name]` when it is handed
CUDA tensors, so a run can show that its main path went through the
kernels. The bound, design and numerics are described in the CUDA
sources. Unlike the TPU kernels, any T, window, page length and cache
length works: the decode kernels read exactly the visible range of
positions, and B4 masks its tail tiles.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

# B4 runs B3a's tiles (csrc/attention_tiles.cuh): the same head-dim limit
# and grid.y bound
from deeplearning4j_tpu_torch.ops.attention import (
    _MAX_BH, MAX_HEAD_DIM as BAND_MAX_HEAD_DIM, _pv,
)

_NEG_INF = -1e30

# kernel name -> launches (wrapper) / plain-version calls on CUDA tensors
_NAMES = ("banded_attention", "banded_decode_attention",
          "paged_decode_attention", "banded_decode_attention_q",
          "paged_decode_attention_q")
LAUNCHES: Dict[str, int] = dict.fromkeys(_NAMES, 0)
PLAIN_ON_CUDA: Dict[str, int] = dict.fromkeys(_NAMES, 0)
# launches by design: B5/B5q and B6/B6q (`b5_design`, `b6_design`), B4
# (`b4_design`)
DESIGNS = ("ffma", "split")
B4_DESIGNS = ("ffma", "folded")
LAUNCHES_BY_DESIGN: Dict[Tuple[str, str], int] = {
    (k, d): 0 for k in _NAMES
    for d in (B4_DESIGNS if k == "banded_attention" else DESIGNS)}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# cache storage codes of the decode kernels: the query's dtype, or
# quantized codes with scale rows
_CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3}
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)

# the decode kernels' register tiles (kMaxG, 32 * kMaxE in
# csrc/decode_attention.cu)
MAX_GROUP = 8
MAX_HEAD_DIM = 128
# B4's query/key tile (kTile in csrc/attention_tiles.cuh)
BAND_TILE = 64
# B4 design 2 (namespace folded in csrc/banded_attention.cu): the query
# rows of a block (G heads x 128 / G positions), the keys of a tile, its
# head dims and GQA groups
FOLD_ROWS = 128
FOLD_KEYS = 32
FOLD_HEAD_DIMS = (32, 64, 128)
FOLD_GROUPS = (1, 2, 4, 8)
# B6 design 2 (namespace split in csrc/decode_attention.cu): its head
# dims, the page-table entries a block holds (kMaxPages), the splits one
# block merges (kMaxSplits); a split holds at least SPLIT_MIN_KEYS keys
SPLIT_HEAD_DIMS = (64, 128)
MAX_SPLIT_PAGES = 256
MAX_SPLITS = 1024
SPLIT_MIN_KEYS = 64
# the K and V rows of one tile of its ring (kTileBytes)
SPLIT_TILE_BYTES = 16384


def decode_eligible(h: int, hkv: int, dh: int) -> bool:
    """Shapes the CUDA decode kernels take: a clean GQA grouping of at
    most MAX_GROUP query heads per KV head and an even head dim of at
    most MAX_HEAD_DIM (a lane reads element pairs). Any cache and page
    length works."""
    return (hkv >= 1 and h % hkv == 0 and h // hkv <= MAX_GROUP
            and 2 <= dh <= MAX_HEAD_DIM and dh % 2 == 0)


def reset_counts() -> None:
    for d in (LAUNCHES, LAUNCHES_BY_DESIGN, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def b6_design(q_dtype, cache_dtype, h: int, hkv: int, dh: int,
              tensors: Sequence[torch.Tensor] = ()) -> str:
    """The design that takes a B6 or B6q call: "split" (design 2) for
    float32 queries over float32, int8 or e4m3 pages at Dh 64 or 128 whose
    `tensors` (the caches: 16-byte copies) start 16-byte aligned; "ffma"
    (design 1) for everything else the kernels take. bfloat16 pages stay
    on design 1: they round p against the row max (C6b), which a block
    holding part of the range does not know."""
    if q_dtype != torch.float32 or \
            cache_dtype not in (torch.float32,) + QUANT_DTYPES or \
            dh not in SPLIT_HEAD_DIMS or not decode_eligible(h, hkv, dh) or \
            any(t.data_ptr() % 16 for t in tensors):
        return "ffma"
    return "split"


def b5_design(q_dtype, cache_dtype, h: int, hkv: int, dh: int,
              tensors: Sequence[torch.Tensor] = ()) -> str:
    """The design that takes a B5 or B5q call: `b6_design`'s rule, since
    the two kernels share design 2's body ("split": float32 queries over
    float32, int8 or e4m3 caches at Dh 64 or 128, 16-byte aligned;
    "ffma" for bfloat16 caches and every other shape)."""
    return b6_design(q_dtype, cache_dtype, h, hkv, dh, tensors)


def split_tile_keys(dh: int, cache_dtype) -> int:
    """Keys in one tile of design 2's ring: SPLIT_TILE_BYTES of K and V
    rows (32 float32 keys at Dh 64, 128 of 1-byte codes)."""
    esize = torch.tensor([], dtype=cache_dtype).element_size()
    return SPLIT_TILE_BYTES // (2 * dh * esize)


@functools.lru_cache(maxsize=256)
def b5_splits(s: int, hkv: int, l: int, window: Optional[int], sms: int,
              tile_keys: int) -> Tuple[int, int]:
    """(C, NSPLIT) of B5/B5q design 2: C logical positions a split, the
    chunks aligned to multiples of C (so the merge order is a function of
    the positions and shapes alone), and NSPLIT blocks a slot and KV head,
    enough for the chunks any visible range meets: ceil(N / C) + 1 with
    a window (N = min(w, L): a range of up to N positions that may start
    anywhere), ceil(L / C) without (the range starts at 0). C is the
    largest whose grid S * Hkv * NSPLIT holds at least 2 * `sms` blocks,
    at least SPLIT_MIN_KEYS keys and one tile of the ring (`tile_keys`,
    `split_tile_keys`; where N holds them) and NSPLIT at most MAX_SPLITS,
    then evened out over the same chunk count. A split's chain of
    loads, folds and the merge sets the time at these sizes, not the
    bytes (`tools/torch_b5_splits.py`): the fewest splits of at least a
    tile each."""
    extra = 1 if window else 0
    n = min(window, l) if window else l
    least = min(n, max(SPLIT_MIN_KEYS, tile_keys,
                       -(-n // (MAX_SPLITS - extra))))
    want = -(-2 * sms // (s * hkv)) - extra       # chunks of N to fill it
    c = n if want <= 1 else -(-n // (want - 1)) - 1
    c = max(least, min(c, n))
    c = max(least, -(-n // -(-n // c)))
    return c, -(-n // c) + extra


@functools.lru_cache(maxsize=256)
def b6_splits(s: int, hkv: int, npg: int, page_len: int, sms: int) -> int:
    """C, the logical pages a block of design 2 takes (NSPLIT =
    ceil(NP / C) blocks a slot and KV head), from the shapes alone: the
    largest C whose grid S * Hkv * NSPLIT holds at least 2 * `sms`
    blocks, then evened out over the same NSPLIT; at least SPLIT_MIN_KEYS
    keys (where the table holds them) and at most MAX_SPLIT_PAGES pages a
    split, at most MAX_SPLITS splits. Where even the smallest C gives
    fewer blocks, the smallest."""
    if npg > MAX_SPLIT_PAGES * MAX_SPLITS:
        raise ValueError(f"design 2 takes at most "
                         f"{MAX_SPLIT_PAGES * MAX_SPLITS} pages a slot, "
                         f"got {npg}")
    least = min(npg, max(-(-SPLIT_MIN_KEYS // page_len),
                         -(-npg // MAX_SPLITS)))
    c = least
    for cand in range(min(npg, MAX_SPLIT_PAGES), least - 1, -1):
        if s * hkv * -(-npg // cand) >= 2 * sms:
            c = cand
            break
    return max(least, -(-npg // -(-npg // c)))


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# ------------------------------------------------------- B4: band geometry
def band_key_tiles(q0: int, t: int, window: int, causal: bool,
                   tile: int = BAND_TILE, block_q: Optional[int] = None):
    """(first, last) key tile of `tile` keys that the query positions
    [q0, q0 + block_q) (default: `tile` of them) can see: the loop bounds
    of a B4 block (the TPU kernel's `_kb_first` and `nkb`; design 2 has
    FOLD_KEYS-key tiles and FOLD_ROWS / G positions a block). Causal:
    from the tile of q0 - w + 1 to the tile holding the block's last
    row; bidirectional: up to q0 + block_q - 1 + w - 1; both clipped to
    [0, T). At most ceil((block_q + w - 1) / tile) + 1 tiles (twice the
    band for bidirectional), whatever T: the T·w contract."""
    bq = tile if block_q is None else block_q
    lo = max(0, q0 - window + 1)
    hi = min(t - 1, q0 + bq - 1 + (0 if causal else window - 1))
    return lo // tile, hi // tile


def band_tile_whole(q0: int, k0: int, t: int, window: int, causal: bool,
                    block_q: int, block_k: int) -> bool:
    """Whether the keys [k0, k0 + block_k) lie inside T and inside the
    band of every query position [q0, q0 + block_q): the tiles design 2
    of B4 folds without the mask. Only a block's first tile and those on
    its diagonal (and past T) are cut."""
    last = k0 + block_k - 1
    return (last < t and k0 > q0 + block_q - 1 - window
            and (last <= q0 if causal else last < q0 + window))


def band_pairs(t: int, window: int, causal: bool) -> int:
    """Visible (query, key) pairs of one head's band: the work a B4
    launch must do, per (batch, head)."""
    if causal:
        return sum(min(i + 1, window) for i in range(t))
    return sum(min(t, i + window) - max(0, i - window + 1)
               for i in range(t))


def band_visibility(t: int, window: int, causal: bool, device=None):
    """[T, T] bool: key j is visible to query i."""
    qi = torch.arange(t, device=device)[:, None]
    ki = torch.arange(t, device=device)[None, :]
    if causal:
        return (ki <= qi) & (ki > qi - window)
    return (qi - ki).abs() < window


# ------------------------------------------------------ B4: plain versions
def banded_dense(q, k, v, window: int, causal: bool, scale: float,
                 block_k: Optional[int] = None):
    """The dense band-masked attention over native GQA layouts (q
    [B, T, H, Dh], k/v [B, T, Hkv, Dh]): score-level -1e30 bias and the
    softmax in float32 (float64 stays float64), output in q's dtype. The
    plain version of B4 and B4's backward recompute (JAX's
    `banded_reference`). In bfloat16 the probabilities meet v rounded to
    bfloat16 (C6), against the running max of key blocks of `block_k`,
    or of the row (None), as `flash_attention_plain` rounds them; the
    CUDA kernel's blocks are BAND_TILE keys."""
    b, t, h, dh = q.shape
    hkv = k.shape[2]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(acc).reshape(b, t, hkv, h // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(acc)) * scale
    s = torch.where(band_visibility(t, window, causal, q.device), s,
                    _NEG_INF)
    if v.dtype == acc:
        # nothing is rounded: one softmax, which keeps the recompute's
        # transient [B, H, T, T] tensors few
        o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v)
        return o.reshape(b, t, h, dh).to(q.dtype)
    pv, l, _ = _pv(s.reshape(b * hkv, -1, t),
                   v.transpose(1, 2).reshape(b * hkv, t, dh), acc, block_k)
    o = (pv / l).reshape(b, hkv, h // hkv, t, dh).permute(0, 3, 1, 2, 4)
    return o.reshape(b, t, h, dh).to(q.dtype)


def banded_reference(q, k, v, window: int, causal: bool = True,
                     scale: Optional[float] = None,
                     block_k: Optional[int] = None):
    """Plain version of kernel B4 (counted when handed CUDA tensors):
    `banded_dense`."""
    if q.is_cuda:
        PLAIN_ON_CUDA["banded_attention"] += 1
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    return banded_dense(q, k, v, window, causal, sc, block_k)


# ------------------------------------------------------------ B4: wrapper
def _check_banded(q, k, v, window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"banded attention wants q [B, T, H, Dh] and k/v "
                         f"[B, T, Hkv, Dh]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, dh = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in B, T or Dh")
    if h % k.shape[2]:
        raise ValueError(f"H {h} not divisible by Hkv {k.shape[2]}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def b4_design(dtype, h: int, hkv: int, dh: int,
              tensors: Sequence[torch.Tensor] = ()) -> str:
    """The design that takes a B4 call: "folded" (design 2) for float32
    at Dh 32, 64 or 128 with H / Hkv in {1, 2, 4, 8} whose `tensors` (q,
    k, v: 16-byte copies) start 16-byte aligned; "ffma" (design 1) for
    everything else the kernel takes. bfloat16 stays on design 1: its
    64-key tiles are the blocks p is rounded against (C6). T and the
    window do not enter: design 2's loop bounds and masks take any."""
    if dtype != torch.float32 or dh not in FOLD_HEAD_DIMS or hkv < 1 or \
            h % hkv or h // hkv not in FOLD_GROUPS or \
            any(t.data_ptr() % 16 for t in tensors):
        return "ffma"
    return "folded"


def banded_attention_fwd(q, k, v, window: int, causal: bool = True,
                         scale: Optional[float] = None,
                         design: Optional[str] = None):
    """Kernel B4: q [B, T, H, Dh], k/v [B, T, Hkv, Dh] (contiguous) ->
    o [B, T, H, Dh] in q's dtype. On the card the kernel runs in
    `b4_design`'s design, or in `design` where the caller names one
    (`chip_smoke.py` times design 1 on design 2's inputs); a design that
    cannot take the call raises."""
    _check_banded(q, k, v, window)
    if q.device.type == "cpu":
        return banded_reference(q, k, v, window, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no banded kernel for device {q.device}")
    b, t, h, dh = q.shape
    if dh > BAND_MAX_HEAD_DIM or b * h > _MAX_BH:
        raise ValueError(f"the CUDA banded kernel takes Dh <= "
                         f"{BAND_MAX_HEAD_DIM} and B*H <= {_MAX_BH}; got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the banded kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from deeplearning4j_tpu_torch.ops import cuda_build

    hkv = k.shape[2]
    chosen = b4_design(q.dtype, h, hkv, dh, (q, k, v))
    design = design or chosen
    if design not in B4_DESIGNS or (design == "folded" and
                                    chosen != "folded"):
        raise ValueError(f"B4 design {design!r} cannot take {q.dtype} at "
                         f"H {h}, Hkv {hkv}, Dh {dh}")
    lib = cuda_build.library("banded_attention")
    o = torch.empty_like(q)
    sc = scale if scale is not None else dh ** -0.5
    # a window past T is the full band: clip it so the kernel's tile
    # arithmetic stays in int range
    w = max(1, min(int(window), t))
    if design == "folded":
        rc = lib.dl4j_banded_attention_folded(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, t, h,
            hkv, dh, w, int(causal), sc, _stream(q.device))
    else:
        rc = lib.dl4j_banded_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, t, h,
            hkv, dh, w, int(causal), sc, _DTYPE_CODES[q.dtype],
            _stream(q.device))
    cuda_build.check(lib, rc, f"banded_attention ({design})")
    LAUNCHES["banded_attention"] += 1
    LAUNCHES_BY_DESIGN[("banded_attention", design)] += 1
    return o


# the profiler range of the backward's dense recompute
# (`tools/torch_train_profile.py --path w` classes its kernels by it)
RECOMPUTE_RANGE = "banded_attention_backward_recompute"


class BandedAttention(torch.autograd.Function):
    """o = banded attention(q, k, v) with B4 as the forward. The backward
    is the JAX package's: the dense band-masked recompute through
    `banded_dense` under autograd, from the saved (q, k, v) only."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, scale):
        o = banded_attention_fwd(q, k, v, window, causal, scale)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v)
        ctx.window, ctx.causal = window, causal
        ctx.scale = scale if scale is not None else q.shape[-1] ** -0.5
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad(), \
                torch.profiler.record_function(RECOMPUTE_RANGE):
            o = banded_dense(q, k, v, ctx.window, ctx.causal, ctx.scale)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        return dq, dk, dv, None, None, None


def banded_attention(q, k, v, window: int, causal: bool = True,
                     scale: Optional[float] = None):
    """Banded (sliding-window) self-attention, GQA-native, differentiable
    in q, k and v. q: [B, T, H, Dh]; k/v: [B, T, Hkv, Dh] with Hkv
    dividing H (Hkv == H is plain MHA). Returns [B, T, H, Dh]."""
    return BandedAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), int(window), bool(causal),
                                 scale)


# ------------------------------------------------ B5/B6: plain versions
def _kernel_name(base: str, scale_k) -> str:
    return base + ("_q" if scale_k is not None else "")


def dequantize(cache, scale, dtype):
    """Quantized codes [.., Hkv, Dh] times their scale rows [.., Hkv], in
    `dtype` (the plain versions' dequantize-up-front, as JAX's
    `decode_reference` does it)."""
    return cache.to(dtype) * scale.to(dtype)[..., None]


def decode_attention_plain(q, cache_k, cache_v, qpos, end,
                           window: Optional[int] = None,
                           rolling: bool = False,
                           scale: Optional[float] = None,
                           scale_k=None, scale_v=None,
                           block_k: Optional[int] = None,
                           split_keys: Optional[int] = None):
    """Plain version of kernel B5, mirroring the JAX `decode_reference`:
    q [S, H, Dh], caches [S, L, Hkv, Dh], qpos/end [S] int; quantized
    caches pass their [S, L, Hkv] scale rows and are dequantized up front
    in q's dtype. Math in f32, output in q's dtype. Rows with no visible
    key are garbage by contract (softmax of a constant here, zeros in the
    kernel). bfloat16 caches feed p to P·V rounded to bfloat16 (C6), as
    the kernel does against the row max, or against the running max of
    blocks of `block_k` cache slots, as the TPU kernel does with its
    `block_l`. `split_keys` C walks design 2's splits instead
    (`split_merge` over each slot's positions in order from a multiple of
    C, so the chunks are the kernel's): the same function, and zeros for
    a row with no visible key."""
    if q.is_cuda:
        PLAIN_ON_CUDA[_kernel_name("banded_decode_attention", scale_k)] += 1
    rounded = cache_v.dtype == torch.bfloat16
    if scale_k is not None:
        cache_k = dequantize(cache_k, scale_k, q.dtype)
        cache_v = dequantize(cache_v, scale_v, q.dtype)
    L = cache_k.shape[1]
    if split_keys is not None:
        if rounded:
            raise ValueError("design 2 takes float32, int8 or e4m3 caches, "
                             "not bfloat16")
        lo, hi = decode_range(qpos, end, L, window, rolling)
        p = (lo // split_keys * split_keys)[:, None] + torch.arange(
            L + split_keys, device=q.device)
        rows = torch.arange(q.shape[0], device=q.device)[:, None]
        idx = torch.remainder(p, L)
        vis = (p >= lo[:, None]) & (p <= hi[:, None])
        return split_merge(q, cache_k[rows, idx], cache_v[rows, idx], vis,
                           split_keys, scale)
    vis = visibility(qpos, end, L, window, rolling)
    return attend_plain(q[:, None], cache_k, cache_v, vis[:, None], scale,
                        rounded, block_k)[:, 0]


def decode_range(qpos, end, L: int, window: Optional[int], rolling: bool):
    """[lo, hi] of the positions each slot's query sees, as the decode
    kernels read them from qpos and end [S] (empty where lo > hi):
    linear `max(0, qpos - w + 1) .. min(qpos, L - 1)`; on the ring also
    from `end - L + 1` and up to `min(qpos, end)`, position p held by
    slot p mod L. The same set as `visibility`."""
    pos = qpos.long()
    lo = (pos - window + 1).clamp(min=0) if window else torch.zeros_like(pos)
    hi = pos.clamp(max=L - 1)
    if rolling:
        e = end.long()
        lo = torch.maximum(lo, e - L + 1)
        hi = torch.minimum(pos, e)
    return lo, hi


def visibility(qpos, end, L: int, window: Optional[int], rolling: bool):
    """Which cache slots each query sees: qpos [S] (one query a slot, as
    the decode kernels take it) gives [S, L] bool, qpos [S, T] (a prefill
    chunk) gives [S, T, L]. Linear: `j <= qpos`, minus what lies past the
    window; rolling ring: slot j holds position
    `held = end - ((end - j) mod L)`, with end [S] the slot's newest
    written position, and is visible iff `0 <= held <= qpos` and
    `held > qpos - window`."""
    j = torch.arange(L, device=qpos.device)
    qp = qpos.long()[..., None]
    if rolling:
        e = end.long().reshape((-1,) + (1,) * qpos.ndim)
        # torch.remainder is a floor-mod, like jnp's %: end - j < 0 early
        held = e - torch.remainder(e - j, L)
        return (held >= 0) & (held <= qp) & (held > qp - window)
    vis = j <= qp
    if window is not None:
        vis = vis & (j > qp - window)
    return vis


def attend_plain(q, cache_k, cache_v, vis, scale: Optional[float] = None,
                 rounded: bool = False, block_k: Optional[int] = None):
    """Grouped masked softmax attention with the math in f32 (f64 for
    float64 queries): q
    [S, T, H, Dh] over caches [S, L, Hkv, Dh] where `vis` [S, T, L] is
    true; returns [S, T, H, Dh] in q's dtype. `rounded` (the decode
    kernels' plain versions over bfloat16 caches) feeds p to P·V rounded
    to the caches' dtype, against the running max of blocks of `block_k`
    slots or the row max (None), as `_pv` does; a row with no visible key
    then comes out as zeros."""
    s_, t, h, dh = q.shape
    hkv, g = cache_k.shape[2], h // cache_k.shape[2]
    sc = scale if scale is not None else dh ** -0.5
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(acc).reshape(s_, t, hkv, g, dh)
    s = torch.einsum("sthgd,slhd->shgtl", qg, cache_k.to(acc)) * sc
    s = torch.where(vis[:, None, None], s, _NEG_INF)
    if not rounded:
        o = torch.einsum("shgtl,slhd->sthgd", torch.softmax(s, dim=-1),
                         cache_v.to(acc))
        return o.reshape(s_, t, h, dh).to(q.dtype)
    pv, l, _ = _pv(s.reshape(s_ * hkv, g * t, -1),
                   cache_v.transpose(1, 2).reshape(s_ * hkv, -1, dh),
                   torch.float32, block_k)
    o = (pv / l).reshape(s_, hkv, g, t, dh).permute(0, 3, 1, 2, 4)
    return o.reshape(s_, t, h, dh).to(q.dtype)


def gather_pages(cache, page_table):
    """Logical [S, NP * Lp, ...] copy of each slot's page chain out of a
    [P, Lp, ...] page pool (caches [.., Hkv, Dh] or scale rows
    [.., Hkv])."""
    s_, npg = page_table.shape
    lp = cache.shape[1]
    return cache[page_table.long()].reshape(s_, npg * lp, *cache.shape[2:])


def paged_decode_attention_plain(q, cache_k, cache_v, page_table, qpos,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None,
                                 scale_k=None, scale_v=None,
                                 block_k: Optional[int] = None,
                                 split_pages: Optional[int] = None):
    """Plain version of kernel B6: gather each slot's page chain (and its
    scale rows) into a logical [S, L, Hkv, Dh] copy and attend linearly
    over it. bfloat16 caches round p as `decode_attention_plain` does
    (the TPU kernel's blocks are its pages: `block_k` = Lp).
    `split_pages` C walks design 2's splits instead (`split_merge`): the
    same function, and zeros for a row with no visible key."""
    if q.is_cuda:
        PLAIN_ON_CUDA[_kernel_name("paged_decode_attention", scale_k)] += 1
    rounded = cache_v.dtype == torch.bfloat16
    ck = gather_pages(cache_k, page_table)
    cv = gather_pages(cache_v, page_table)
    if scale_k is not None:
        ck = dequantize(ck, gather_pages(scale_k, page_table), q.dtype)
        cv = dequantize(cv, gather_pages(scale_v, page_table), q.dtype)
    vis = visibility(qpos, qpos, ck.shape[1], window, False)
    if split_pages is not None:
        if rounded:
            raise ValueError("design 2 takes float32, int8 or e4m3 pages, "
                             "not bfloat16")
        return split_merge(q, ck, cv, vis, split_pages * cache_k.shape[1],
                           scale)
    return attend_plain(q[:, None], ck, cv, vis[:, None], scale, rounded,
                        block_k)[:, 0]


def split_merge(q, ck, cv, vis, split_keys: int,
                scale: Optional[float] = None):
    """Design 2's arithmetic in plain PyTorch: q [S, H, Dh] over logical
    caches [S, L, Hkv, Dh] where `vis` [S, L] is true, in splits of
    `split_keys` logical positions. Each split keeps (m, l, acc) with m
    its max over visible scores (-1e30 for none; a NaN score is left out
    of the max, as fmaxf leaves it, and carried by exp(s - m) into l and
    acc); the splits merge in order: M = max m_z, c_z = exp(m_z - M),
    o = sum acc_z c_z / max(sum l_z c_z, 1e-30). Math in f32."""
    s_, h, dh = q.shape
    L, hkv = ck.shape[1], ck.shape[2]
    sc = scale if scale is not None else dh ** -0.5
    qg = q.float().reshape(s_, hkv, h // hkv, dh)
    parts = []
    for z0 in range(0, L, split_keys):
        sl = slice(z0, z0 + split_keys)
        s = torch.einsum("shgd,slhd->shgl", qg, ck[:, sl].float()) * sc
        live = vis[:, None, None, sl]
        m = torch.where(live & ~torch.isnan(s), s, _NEG_INF).amax(dim=-1)
        p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("shgl,slhd->shgd", p, cv[:, sl].float())))
    big_m = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = o = 0.0
    for m, lz, acc in parts:
        c = torch.exp(m - big_m)
        l = l + lz * c
        o = o + acc * c[..., None]
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(s_, h, dh).to(q.dtype)


# ------------------------------------------------------ B5/B6: wrappers
def _check_common(q, cache_k, cache_v, scale_k, scale_v):
    if q.ndim != 3 or cache_k.ndim != 4 or cache_v.shape != cache_k.shape:
        raise ValueError(f"decode attention wants q [S, H, Dh] and caches "
                         f"[N, L, Hkv, Dh]; got {tuple(q.shape)}, "
                         f"{tuple(cache_k.shape)}, {tuple(cache_v.shape)}")
    h, dh = q.shape[1], q.shape[2]
    hkv = cache_k.shape[2]
    if cache_k.shape[3] != dh:
        raise ValueError(f"head dim {cache_k.shape[3]} != query's {dh}")
    if h % hkv:
        raise ValueError(f"H {h} not divisible by Hkv {hkv}")
    if (scale_k is None) != (scale_v is None):
        raise ValueError("pass both scale rows or neither")
    quant = cache_k.dtype in QUANT_DTYPES
    if quant != (scale_k is not None):
        raise ValueError(f"{cache_k.dtype} caches "
                         + ("need" if quant else "take no")
                         + " scale rows")
    if quant:
        for name, t in (("scale_k", scale_k), ("scale_v", scale_v)):
            if tuple(t.shape) != tuple(cache_k.shape[:3]):
                raise ValueError(f"{name} {tuple(t.shape)} is not the "
                                 f"caches' [N, L, Hkv] "
                                 f"{tuple(cache_k.shape[:3])}")


def _check_cuda(tensors: dict, dtype) -> None:
    _, h, dh = tensors["q"].shape
    if not decode_eligible(h, tensors["cache_k"].shape[2], dh):
        raise ValueError(
            f"the CUDA decode kernels take at most {MAX_GROUP} query heads "
            f"per KV head and an even head dim of at most {MAX_HEAD_DIM}; "
            f"got H={h}, Hkv={tensors['cache_k'].shape[2]}, Dh={dh}")
    dev = tensors["q"].device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"decode kernels take float32 or bfloat16 queries, "
                        f"got {dtype}")
    cdt = tensors["cache_k"].dtype
    for name in ("cache_k", "cache_v"):
        t = tensors[name]
        if t.dtype != cdt or (t.dtype != dtype and t.dtype
                              not in QUANT_DTYPES):
            raise TypeError(f"{name} is {t.dtype}, q is {dtype}: caches "
                            f"hold q's dtype or int8/e4m3 codes")
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"{name} must start on a {2 * t.element_size()}"
                             f"-byte boundary (the kernels load element "
                             f"pairs)")
    for name in ("scale_k", "scale_v"):
        if name in tensors and tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
    for name in ("qpos", "end", "page_table"):
        if name in tensors and tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")


def _scale_ptrs(scale_k, scale_v):
    if scale_k is None:
        return None, None
    return scale_k.data_ptr(), scale_v.data_ptr()


def _with_scales(tensors: dict, scale_k, scale_v) -> dict:
    if scale_k is not None:
        tensors.update(scale_k=scale_k, scale_v=scale_v)
    return tensors


def banded_decode_attention(q, cache_k, cache_v, qpos, end,
                            window: Optional[int] = None,
                            rolling: bool = False,
                            scale: Optional[float] = None,
                            scale_k=None, scale_v=None,
                            design: Optional[str] = None):
    """Single-query attention over the slot pool (kernel B5).

    q: [S, H, Dh] (this step's query per slot, post-RoPE); caches
    [S, L, Hkv, Dh] (this step's K/V already written), in q's dtype or
    int8/e4m3 codes with float32 scale rows `scale_k`/`scale_v`
    [S, L, Hkv]; qpos: [S] int32 position of each slot's query; end: [S]
    int32 newest written position (rolling ring only; pass qpos
    otherwise). Returns [S, H, Dh] in q's dtype. On the card the kernel
    runs in `b5_design`'s design, or in `design` where the caller names
    one; a design that cannot take the call raises."""
    _check_common(q, cache_k, cache_v, scale_k, scale_v)
    if rolling and window is None:
        raise ValueError("rolling decode requires a window")
    s_, h, dh = q.shape
    if cache_k.shape[0] != s_ or qpos.shape != (s_,) or end.shape != (s_,):
        raise ValueError("slot counts of q, caches, qpos and end differ")
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, qpos, end,
                                      window, rolling, scale, scale_k,
                                      scale_v)
    if q.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {q.device}")
    _check_cuda(_with_scales(dict(q=q, cache_k=cache_k, cache_v=cache_v,
                                  qpos=qpos, end=end), scale_k, scale_v),
                q.dtype)
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("decode_attention")
    out = torch.empty_like(q)
    l, hkv = cache_k.shape[1], cache_k.shape[2]
    sc = scale if scale is not None else dh ** -0.5
    chosen = b5_design(q.dtype, cache_k.dtype, h, hkv, dh, (cache_k, cache_v))
    design = design or chosen
    if design not in DESIGNS or (design == "split" and chosen != "split"):
        raise ValueError(f"B5 design {design!r} cannot take q {q.dtype} "
                         f"over {cache_k.dtype} caches at H {h}, Hkv {hkv}, "
                         f"Dh {dh}")
    if design == "split":
        c, nsplit = b5_splits(s_, hkv, l, window or None,
                              _sm_count(q.device),
                              split_tile_keys(dh, cache_k.dtype))
        work, counters = _split_workspace(q.device, s_, hkv, nsplit,
                                          h // hkv, dh)
        rc = lib.dl4j_decode_attention_split(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            *_scale_ptrs(scale_k, scale_v), out.data_ptr(), qpos.data_ptr(),
            end.data_ptr(), work, counters, s_, l, h, hkv, dh, window or 0,
            int(rolling), c, nsplit, sc, _CACHE_CODES[cache_k.dtype],
            _stream(q.device))
    else:
        rc = lib.dl4j_decode_attention(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            *_scale_ptrs(scale_k, scale_v), out.data_ptr(), qpos.data_ptr(),
            end.data_ptr(), s_, l, h, hkv, dh, window or 0, int(rolling), sc,
            _DTYPE_CODES[q.dtype], _CACHE_CODES[cache_k.dtype],
            _stream(q.device))
    name = _kernel_name("banded_decode_attention", scale_k)
    cuda_build.check(lib, rc, f"{name} ({design})")
    LAUNCHES[name] += 1
    LAUNCHES_BY_DESIGN[(name, design)] += 1
    return out


def paged_decode_attention(q, cache_k, cache_v, page_table, qpos,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           scale_k=None, scale_v=None,
                           design: Optional[str] = None):
    """Single-query attention over the paged pool (kernel B6).

    q: [S, H, Dh]; caches [P, Lp, Hkv, Dh] (post-write), in q's dtype or
    int8/e4m3 codes with float32 scale rows [P, Lp, Hkv]; page_table
    [S, NP] int32 mapping logical pages to physical ones (unmapped
    entries hold a valid page, 0); qpos [S] int32 logical position of
    each slot's query. Returns [S, H, Dh]. Any page length works. On the
    card the kernel runs in `b6_design`'s design, or in `design` where
    the caller names one (`chip_smoke.py` times design 1 on design 2's
    inputs); a design that cannot take the call raises."""
    _check_common(q, cache_k, cache_v, scale_k, scale_v)
    s_, h, dh = q.shape
    if page_table.ndim != 2 or page_table.shape[0] != s_ or \
            qpos.shape != (s_,):
        raise ValueError("slot counts of q, page_table and qpos differ")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, cache_k, cache_v, page_table,
                                            qpos, window, scale, scale_k,
                                            scale_v)
    if q.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {q.device}")
    _check_cuda(_with_scales(dict(q=q, cache_k=cache_k, cache_v=cache_v,
                                  page_table=page_table, qpos=qpos),
                             scale_k, scale_v), q.dtype)
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("decode_attention")
    out = torch.empty_like(q)
    npg = page_table.shape[1]
    lp, hkv = cache_k.shape[1], cache_k.shape[2]
    sc = scale if scale is not None else dh ** -0.5
    chosen = b6_design(q.dtype, cache_k.dtype, h, hkv, dh, (cache_k, cache_v))
    design = design or chosen
    if design not in DESIGNS or (design == "split" and chosen != "split"):
        raise ValueError(f"B6 design {design!r} cannot take q {q.dtype} "
                         f"over {cache_k.dtype} pages at H {h}, Hkv {hkv}, "
                         f"Dh {dh}")
    if design == "split":
        c = b6_splits(s_, hkv, npg, lp, _sm_count(q.device))
        work, counters = _split_workspace(q.device, s_, hkv, -(-npg // c),
                                          h // hkv, dh)
        rc = lib.dl4j_paged_decode_attention_split(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            *_scale_ptrs(scale_k, scale_v), out.data_ptr(),
            page_table.data_ptr(), qpos.data_ptr(), work, counters, s_, npg,
            lp, h, hkv, dh, window or 0, c, sc, _CACHE_CODES[cache_k.dtype],
            _stream(q.device))
    else:
        rc = lib.dl4j_paged_decode_attention(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            *_scale_ptrs(scale_k, scale_v), out.data_ptr(),
            page_table.data_ptr(), qpos.data_ptr(), s_, npg, lp, h, hkv, dh,
            window or 0, sc, _DTYPE_CODES[q.dtype],
            _CACHE_CODES[cache_k.dtype], _stream(q.device))
    name = _kernel_name("paged_decode_attention", scale_k)
    cuda_build.check(lib, rc, f"{name} ({design})")
    LAUNCHES[name] += 1
    LAUNCHES_BY_DESIGN[(name, design)] += 1
    return out


_SMS: Dict[int, int] = {}
# (device index, stream, S, Hkv, NSPLIT, G, Dh) -> (work, counters) of
# design 2
_WORKSPACES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _sm_count(dev) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _split_workspace(dev, s_: int, hkv: int, nsplit: int, g: int, dh: int):
    """Design 2's partials (NSPLIT x G (Dh + 2) float32 a slot and KV head)
    and arrival counters (zero; each launch leaves them zero), allocated
    once per device, stream and shape and kept: pointers (None for NSPLIT
    1). Launches on one stream run one after another, so they may share
    them; launches on two streams must not."""
    if nsplit == 1:
        return None, None
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream, s_, hkv,
           nsplit, g, dh)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = (
            torch.empty(s_ * hkv * nsplit * g * (dh + 2), dtype=torch.float32,
                        device=dev),
            torch.zeros(s_ * hkv, dtype=torch.int32, device=dev))
    work, counters = _WORKSPACES[key]
    return work.data_ptr(), counters.data_ptr()
