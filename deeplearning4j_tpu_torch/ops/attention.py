"""Blockwise (flash) attention, forward and backward — the port of
`deeplearning4j_tpu/ops/attention.py`.

Three kernels, hand-written in CUDA C++ for Hopper
(`csrc/flash_attention.cu`), over folded [BH, T, Dh] tensors:

- B3a, `flash_attention_fwd` (replaces `_flash_kernel`): o and, for
  training, the per-row log-sum-exp lse = m + log(l) in float32;
- B3b and B3c, launched together by `flash_attention_bwd` (replace
  `_flash_bwd_dkdv_kernel` and `_flash_bwd_dq_kernel`): dK/dV with a K/V
  tile pinned while Q is swept, and dQ with a Q tile pinned while K is
  swept, from the saved lse and Δ = rowsum(dO·O) (computed here in f32,
  as JAX computes it in XLA).

Each kernel comes in three designs, chosen by `b3_design` from the
dtype, the head dim and the operands' alignment before the launch (none
is a fallback of another): "wgmma" (design 2) for bfloat16 at Dh 64 and
128 — TMA-fed tiles and `wgmma` on the tensor cores, P and dS rounded to
bfloat16 as operands; "tf32x3" (design 3) for float32 at Dh 64 and 128 —
`mma.sync` on the tensor cores, each float32 operand split into two TF32
terms (`tf32x3_split`) and each product taken as three TF32 products,
the forward's online softmax in registers; and "ffma" (design 1, float32
FMA) for every other shape. `LAUNCHES_BY_DESIGN[(kernel, design)]`
counts their launches. In bfloat16 every design, and the plain versions,
round the probabilities and score gradients to bfloat16 where they meet
the second products, as the TPU kernels do (C6); float32 never rounds.

The float32 contract: no design rounds a float32 operand to a single TF32
term. 3xTF32 keeps about 22 bits of each operand, so design 3 is as
accurate as design 1's FMA: on the card its largest error against a
float64 forward (o and lse) or backward stays within twice design 1's on
the same inputs, which a one-pass TF32 product misses by far
(`tests/test_torch_b3_tf32.py` and `tests/test_torch_b3a_tf32.py` show
both on the CPU through `flash_attention_plain(..., products=...)` and
`flash_attention_bwd_plain(..., products=...)`).

`flash_attention` is a `torch.autograd.Function` over the two. Beside
each kernel stands its plain PyTorch version: `flash_attention_plain`
(dense masked softmax) and `flash_attention_bwd_plain` (the same
identity from the lse as the TPU kernels' `_bwd_tile`, not autograd
through the dense forward). A wrapper takes its plain version only for
tensors on the CPU; on a CUDA tensor it launches its kernel or raises.
Each wrapper adds one to `LAUNCHES[name]` for each kernel it launches,
and each plain version adds one to `PLAIN_ON_CUDA[name]` when handed
CUDA tensors.

Unlike the TPU kernels, any Tq and Tk work (no 128-multiple rule: the
kernels mask their tail tiles) and the head dim may be anything up to
MAX_HEAD_DIM. The scale defaults to Dh^-0.5 and the causal mask value
is -1e30, as in JAX.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# the float32 split of design 3, shared with ops/conv_fused.py
from deeplearning4j_tpu_torch.ops.tf32 import (  # noqa: F401
    tf32_rna, tf32x3_split)

_NEG_INF = -1e30
MAX_HEAD_DIM = 128        # the kernels' largest head-dim tile
_MAX_BH = 65535           # grid.y
KERNEL_BLOCK_K = 64       # keys a B3a tile folds into its running max
                          # (both designs)
WGMMA_HEAD_DIMS = (64, 128)
# B3a's o against `flash_attention_plain` at KERNEL_BLOCK_K, past one bf16
# step of each element: 2e-5, and on design 2 this share of the largest
# |o| besides (`fwd_atol`)
FWD_WGMMA_SHARE = 4e-4

# kernel name -> launches (wrapper) / plain-version calls on CUDA tensors
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd_dkdv": 0,
                            "flash_attention_bwd_dq": 0}
DESIGNS = ("ffma", "wgmma", "tf32x3")
LAUNCHES_BY_DESIGN: Dict[Tuple[str, str], int] = {
    (k, d): 0 for k in LAUNCHES for d in DESIGNS}
PLAIN_ON_CUDA: Dict[str, int] = {"flash_attention_fwd": 0,
                                 "flash_attention_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    for d in (LAUNCHES, LAUNCHES_BY_DESIGN, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def _acc_dtype(dtype):
    """float64 stays float64 (gradcheck); everything else computes in
    float32, as the kernels do."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _split_product(eq: str, a, b, products: Optional[str]):
    """einsum(eq, a, b) in float32 with its operands as the named
    tensor-core scheme takes them: None, the plain product; "tf32x3",
    small·big + big·small + big·big, each term's products exact in
    float32 (11-bit significands), the small terms first; "tf32", the
    one-pass big·big."""
    if products is None:
        return torch.einsum(eq, a, b)
    ab, as_ = tf32x3_split(a)
    bb, bs = tf32x3_split(b)
    if products == "tf32":
        return torch.einsum(eq, ab, bb)
    if products != "tf32x3":
        raise ValueError(f"products must be None, 'tf32x3' or 'tf32'; got "
                         f"{products!r}")
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)) \
        + torch.einsum(eq, ab, bb)


def _check_products(products, acc, dtype) -> None:
    if products is not None and acc != torch.float32:
        raise ValueError(f"products={products!r} emulates float32 "
                         f"products; got {dtype}")


def _scores(q, k, causal: bool, scale: float, acc,
            products: Optional[str] = None):
    s = _split_product("bqd,bkd->bqk", q.to(acc), k.to(acc),
                       products) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = torch.ones((tq, tk), dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(keep, s, _NEG_INF)
    return s


# ------------------------------------------------------------ plain versions
def _pv(s, v, acc, block_k, products: Optional[str] = None):
    """(P·V, l, m) for scores s [BH, Tq, Tk] (masked entries -1e30):
    p = exp(s - m) with m the running max over key blocks of `block_k`
    (None: one block, the row max), l = Σp unrounded, m [BH, Tq, 1] the
    row max.
    Where v is narrower than the accumulation dtype (bfloat16), p meets v
    rounded to v's dtype, as the TPU kernel's `p.astype(v.dtype)`; each
    block's product is then rescaled to the final max, as an online
    softmax rescales its accumulator. Float32 and float64 never round,
    so there the blocks change nothing and one block is taken.
    `products` takes P·V as that tensor-core scheme does
    (`_split_product`)."""
    tk = s.shape[-1]
    bk = tk if block_k is None or v.dtype == acc else block_k
    nb = -(-tk // bk)
    pad = nb * bk - tk
    sb = F.pad(s, (0, pad), value=_NEG_INF).unflatten(-1, (nb, bk))
    m_run = sb.amax(dim=-1).cummax(dim=-1).values          # [BH, Tq, nb]
    # masked keys get p = 0 outright: a row with no visible key in the
    # blocks so far still has the running max -1e30 there
    p = torch.where(sb > _NEG_INF, torch.exp(sb - m_run[..., None]), 0.0)
    c = torch.exp(m_run - m_run[..., -1:])                  # block rescale
    l = torch.clamp((p.sum(dim=-1) * c).sum(dim=-1, keepdim=True),
                    min=1e-30)
    vb = F.pad(v.to(acc), (0, 0, 0, pad)).unflatten(-2, (nb, bk))
    pv = _split_product("bqnk,bnkd->bqnd", p.to(v.dtype).to(acc), vb,
                        products)
    return (pv * c[..., None]).sum(dim=-2), l, m_run[..., -1:]


def flash_attention_plain(q, k, v, causal: bool,
                          scale: Optional[float] = None,
                          block_k: Optional[int] = None,
                          products: Optional[str] = None):
    """Plain version of kernel B3a: q [BH, Tq, Dh], k/v [BH, Tk, Dh];
    returns (o in q's dtype, lse [BH, Tq] in float32, float64 for float64
    inputs). In bfloat16 the probabilities meet v rounded to bfloat16
    (C6), against the row max by default. The TPU kernel rounds them
    against the running max of its key blocks, so its rounding point
    depends on its `block_k`; `block_k` here rounds against the running
    max of blocks of that many keys, as a kernel with that tile does
    (the CUDA kernel's is `KERNEL_BLOCK_K`). The row sum l is taken from
    the unrounded p, and o is rounded once.

    `products` ("tf32x3" or "tf32", float32 only) takes S = Q·K^T and P·V
    as that tensor-core scheme does (`_split_product`): the CPU's
    emulation of design 3's forward and of the one-pass TF32 product it
    avoids."""
    if q.is_cuda:
        PLAIN_ON_CUDA["flash_attention_fwd"] += 1
    acc = _acc_dtype(q.dtype)
    _check_products(products, acc, q.dtype)
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    pv, l, m = _pv(_scores(q, k, causal, sc, acc, products), v, acc,
                   block_k, products)
    return (pv / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool,
                              scale: Optional[float] = None,
                              products: Optional[str] = None):
    """Plain version of kernels B3b and B3c: (dq, dk, dv) from the saved
    lse through p = exp(s - L), ds = p * (dp - Δ) * scale with
    Δ = rowsum(do · o), the identity the TPU kernels' `_bwd_tile` uses.
    As there, ds is taken from the unrounded p, and in bfloat16 p meets
    dO rounded to do's dtype and ds meets q and k rounded to theirs (C6:
    `_flash_bwd_dkdv_kernel`'s `p.astype(do.dtype)`,
    `ds.astype(q.dtype)`; `_flash_bwd_dq_kernel`'s `ds.astype(k.dtype)`);
    float32 and float64 do not round.

    `products` ("tf32x3" or "tf32", float32 only) takes each of the five
    products as that tensor-core scheme does (`_split_product`): the
    CPU's emulation of design 3 and of the one-pass TF32 product it
    avoids."""
    if q.is_cuda:
        PLAIN_ON_CUDA["flash_attention_bwd"] += 1
    acc = _acc_dtype(q.dtype)
    _check_products(products, acc, q.dtype)
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    s = _scores(q, k, causal, sc, acc, products)
    p = torch.exp(s - lse.to(acc)[..., None])
    dof = do.to(acc)
    dp = _split_product("bqd,bkd->bqk", dof, v.to(acc), products)
    delta = (dof * o.to(acc)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * sc

    def operand(x, dtype):
        return x.to(dtype).to(acc)

    dq = _split_product("bqk,bkd->bqd", operand(ds, k.dtype), k.to(acc),
                        products)
    dk = _split_product("bqk,bqd->bkd", operand(ds, q.dtype), q.to(acc),
                        products)
    dv = _split_product("bqk,bqd->bkd", operand(p, do.dtype), dof,
                        products)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ wrappers
def _check_shapes(q, k, v, causal: bool) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"flash attention wants q [BH, Tq, Dh] and k/v "
                         f"[BH, Tk, Dh]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"differ in BH or Dh")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal attention requires Tq == Tk (got {q.shape[1]} vs "
            f"{k.shape[1]}); cross-attention is non-causal")


def _check_cuda(tensors: dict, dtype) -> None:
    q = tensors["q"]
    if q.shape[2] > MAX_HEAD_DIM or q.shape[0] > _MAX_BH:
        raise ValueError(f"the CUDA flash kernels take Dh <= {MAX_HEAD_DIM} "
                         f"and BH <= {_MAX_BH}; got {tuple(q.shape)}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got "
                        f"{dtype}")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.float32 if name in ("lse", "delta") else dtype
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, expected {want}")


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _on_card(q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    return True


def flash_attention_fwd(q, k, v, causal: bool,
                        scale: Optional[float] = None,
                        with_lse: bool = True):
    """Kernel B3a: q [BH, Tq, Dh], k/v [BH, Tk, Dh] -> (o [BH, Tq, Dh] in
    q's dtype, lse [BH, Tq] float32 or None when `with_lse` is false)."""
    _check_shapes(q, k, v, causal)
    if not _on_card(q):
        o, lse = flash_attention_plain(q, k, v, causal, scale)
        return o, (lse if with_lse else None)
    _check_cuda(dict(q=q, k=k, v=v), q.dtype)
    design = b3_design(q.dtype, q.shape[2], (q, k, v))
    return launch_fwd(q, k, v, causal, scale, with_lse, design)


def launch_fwd(q, k, v, causal: bool, scale: Optional[float] = None,
               with_lse: bool = True, design: str = "ffma"):
    """Kernel B3a alone, on checked CUDA tensors, in `design` (the
    wrapper passes `b3_design`'s choice; `chip_smoke.py` also times
    design 1 on the inputs of designs 2 and 3 to compare them): returns
    (o, lse or None)."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("flash_attention")
    bh, tq, dh = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((bh, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    sc = scale if scale is not None else dh ** -0.5
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, tq, k.shape[1], dh,
            sc, int(causal))
    if design in ("wgmma", "tf32x3"):
        fn = getattr(lib, f"dl4j_flash_fwd_{design}")
        rc = fn(*args, _stream(q.device))
    else:
        rc = lib.dl4j_flash_fwd(*args, _DTYPE_CODES[q.dtype],
                                _stream(q.device))
    cuda_build.check(lib, rc, f"flash_attention_fwd ({design})")
    _count("flash_attention_fwd", design)
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool,
                        scale: Optional[float] = None):
    """Kernels B3b (dK, dV) and B3c (dQ) from the forward's residuals:
    returns (dq, dk, dv) in the inputs' dtypes."""
    _check_shapes(q, k, v, causal)
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != q.shape[:2]:
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and "
                         f"lse {tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if not _on_card(q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    # Δ = rowsum(do · o) in f32: one small reduction outside the kernels,
    # as JAX computes it in XLA (`_run_flash_bwd`)
    delta = (do.float() * o.float()).sum(dim=-1)
    _check_cuda(dict(q=q, k=k, v=v, o=o, do=do, lse=lse, delta=delta),
                q.dtype)
    design = b3_design(q.dtype, q.shape[2], (q, k, v, do))
    dk, dv = launch_bwd_dkdv(q, k, v, do, lse, delta, causal, scale, design)
    dq = launch_bwd_dq(q, k, v, do, lse, delta, causal, scale, design)
    return dq, dk, dv


def fwd_atol(o_ref: torch.Tensor, design: str) -> float:
    """B3a's absolute tolerance on o in `design` against the plain version
    that rounds p against KERNEL_BLOCK_K-key tiles, past one bf16 step of
    each element: 2e-5, plus FWD_WGMMA_SHARE of the largest |o_ref| on
    design 2. Both sides round p to bfloat16 where it meets V (C6), from
    float32 scores: design 1's FMA sums give the plain version's scores,
    design 2's tensor-core sums differ in their last bits, so a p near a
    rounding boundary lands on the other bf16 neighbour and moves its row
    by a step of p v / l (design 1's form of the exponential does not
    remove it). On an H100, at the bfloat16 shapes of `chip_smoke.py`'s
    flash rows (and `tools/torch_b3a_exp_forms.py`'s), design 2 lies at
    most 2.4e-4 of the largest |o| past one step from this plain version,
    and at least 4.9e-4 from the one that leaves p unrounded (C6's
    fault): the share lies between the two."""
    share = FWD_WGMMA_SHARE if design == "wgmma" else 0.0
    return 2e-5 + share * o_ref.float().abs().max().item()


def b3_design(dtype, dh: int, tensors: Sequence[torch.Tensor]) -> str:
    """The design that takes a B3a or B3b/B3c call whose `tensors` (q, k,
    v forward, and dO backward: the operands the tensor maps or the
    16-byte copies read) start 16-byte aligned at Dh 64 or 128: "wgmma"
    (design 2, the tensor cores) for bfloat16; "tf32x3" (design 3, the
    tensor cores as three TF32 products) for float32. "ffma" (design 1,
    float32 FMA) for every other shape. The wrapper has checked that
    they are contiguous."""
    if dh not in WGMMA_HEAD_DIMS or any(t.data_ptr() % 16 for t in tensors):
        return "ffma"
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "tf32x3"
    return "ffma"


def _bwd_args(q, k, causal, scale, design):
    bh, tq, dh = q.shape
    sc = scale if scale is not None else dh ** -0.5
    dtype = (_DTYPE_CODES[q.dtype],) if design == "ffma" else ()
    return (bh, tq, k.shape[1], dh, sc, int(causal), *dtype,
            _stream(q.device))


# kernel -> design -> the C entry point that launches it
_BWD_ENTRY = {
    "flash_attention_bwd_dkdv": {"ffma": "dl4j_flash_bwd_dkdv",
                                 "wgmma": "dl4j_flash_bwd_dkdv_wgmma",
                                 "tf32x3": "dl4j_flash_bwd_dkdv_tf32x3"},
    "flash_attention_bwd_dq": {"ffma": "dl4j_flash_bwd_dq",
                               "wgmma": "dl4j_flash_bwd_dq_wgmma",
                               "tf32x3": "dl4j_flash_bwd_dq_tf32x3"}}


def _count(kernel, design):
    LAUNCHES[kernel] += 1
    LAUNCHES_BY_DESIGN[(kernel, design)] += 1


def launch_bwd_dkdv(q, k, v, do, lse, delta, causal: bool,
                    scale: Optional[float] = None, design: str = "ffma"):
    """Kernel B3b alone, on checked CUDA tensors, in `design` (the
    wrapper passes `b3_design`'s choice; `chip_smoke.py` also times
    design 1 on the inputs of designs 2 and 3 to compare them): returns
    (dk, dv)."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("flash_attention")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = getattr(lib, _BWD_ENTRY["flash_attention_bwd_dkdv"][design])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, k, causal, scale, design))
    cuda_build.check(lib, rc, f"flash_attention_bwd_dkdv ({design})")
    _count("flash_attention_bwd_dkdv", design)
    return dk, dv


def launch_bwd_dq(q, k, v, do, lse, delta, causal: bool,
                  scale: Optional[float] = None, design: str = "ffma"):
    """Kernel B3c alone, on checked CUDA tensors, in `design`: returns
    dq."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("flash_attention")
    dq = torch.empty_like(q)
    fn = getattr(lib, _BWD_ENTRY["flash_attention_bwd_dq"][design])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_bwd_args(q, k, causal, scale, design))
    cuda_build.check(lib, rc, f"flash_attention_bwd_dq ({design})")
    _count("flash_attention_bwd_dq", design)
    return dq


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) over [BH, T, Dh] with the flash kernels as
    forward and backward. The forward saves q, k, v, o and the lse only
    when a gradient is wanted (so `output()` skips the lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        need = any(ctx.needs_input_grad[:3])
        o, lse = flash_attention_fwd(q, k, v, causal, scale, with_lse=need)
        if need:
            ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _fold3(x):
    """[B, T, H, D] -> contiguous [BH, T, D] (3-D inputs pass through)."""
    if x.ndim == 3:
        return x.contiguous(), None
    b, t, h, d = x.shape
    # reshape may return a strided view (batch 1): the kernels want rows
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous(), \
        (b, t, h, d)


def _unfold3(x, shape):
    if shape is None:
        return x
    b, t, h, d = shape
    return x.reshape(b, h, t, d).transpose(1, 2)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """Fused attention. q/k/v: [B, T, H, D] (the layer's layout) or
    [BH, T, D]; returns the same layout, differentiable in q, k and v."""
    q3, shape = _fold3(q)
    k3, _ = _fold3(k)
    v3, _ = _fold3(v)
    return _unfold3(FlashAttention.apply(q3, k3, v3, causal, scale), shape)
