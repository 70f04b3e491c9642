"""Fused convolution + batch-norm statistics — the port of
`deeplearning4j_tpu/ops/conv_fused.py` (kernels B7a, `_mm_stats_kernel`,
and B7b, `_conv3_stats_kernel`).

A training-mode batch norm needs its batch statistics before it can
normalize, so an unfused conv + BN writes y, reads it for the sums, reads
it again to normalize and writes the result. The kernels compute y AND
its per-channel Σy and Σy² in one pass, from the float32 accumulator
while the output tile is still in registers; the normalize+activation
epilogue then reads y once.

- B7a, `matmul_with_channel_stats(x2d, w)`: y = x2d @ w, the 1×1
  convolution over NHWC rows (any stride: the wrapper takes the strided
  rows first);
- B7b, `conv3x3_with_channel_stats(x, w)`: the 3×3 stride-1 SAME
  convolution over NHWC input with an HWIO kernel, as an implicit GEMM.

Both are hand-written CUDA C++ for Hopper (`csrc/conv_fused.cu`), in
three designs chosen by `b7_design` from the dtype and the shape before
the launch (none is a fallback of another):
- "wgmma" (design 2): bfloat16 whose rows are 16-byte aligned (K or C,
  and N, multiples of 8; 16-byte aligned data) — every `path_r` shape.
  A producer warp keeps TMA loads of 64-deep K slices in flight into a
  shared-memory ring; two warpgroups multiply them on the tensor cores
  (`wgmma`, float32 accumulators) into a 128 x BN tile of y, BN from
  `wgmma_tile`; the 3x3 reads each tap's rows of x shifted by the tap's
  offset and zeroes the rows whose tap pixel is off the map;
- "tf32x3" (design 3): float32 whose rows are 16-byte aligned (K or C,
  and N, multiples of 4; 16-byte aligned data) — every `path_r` shape in
  float32. Design 2's ring and warpgroups with 32-deep K slices of
  float32; the products on the tensor cores as three TF32 products
  (`wgmma` m64nBNk8, BN 64 or 128: `tf32x3_tile`), each float32 operand
  split into big = tf32(x) and small = tf32(x - big) (`ops/tf32.py`): x
  where the consumers load it into registers, w by a split pass at the
  start of the call into two K-major planes (tf32 `wgmma` reads B
  K-major only). Each group of `TF32_FLUSH_DEPTH` K values takes its
  products into a fresh accumulator, small·big and big·small first, then
  big·big, and is then added to the float32 sum, so the tensor cores'
  truncating sums never run long (C17; nothing is added back for their
  truncation, so TF32-exact data comes out exact), and the tiles'
  partial sums are added in float64. B7b reads a channel slice's x tile
  with its halo rows once for its nine taps, one TMA box, so maps up to
  `TF32_HALO_MAX_W` wide;
- "ffma" (design 1): exact float32 FMA tiles, every other shape (ragged
  or unaligned float32 and bfloat16, float32 maps wider than
  `TF32_HALO_MAX_W`).
In both, the epilogue writes y rounded once to the working dtype and
per-tile column partials of Σy and Σy² from the unrounded float32
accumulator, then a second launch sums the partials in a fixed order
(deterministic, no atomics). They take float32 and bfloat16; on a CUDA
tensor any other dtype raises. Each returns (y in x's dtype, sums,
sumsqs in the accumulation dtype: float32, or float64 for float64 CPU
tensors, as JAX's `_acc_dtype`).

Beside each kernel stands its plain version: B7a one product in the
accumulation dtype then the sums over rows; B7b nine shifted products
over a zero-padded input, as the Pallas body does. With `products`
("tf32x3" or "tf32", float32 only) they emulate design 3's sums on the
CPU: groups of K each from a fresh float32 sum of the split terms
(or of the one-pass TF32 product), added in order — for the tests' guard,
never on the card's path. A wrapper takes its
plain version only for CPU tensors; on a CUDA tensor it launches its
kernel or raises. `LAUNCHES[name]` counts launches (one a call: the
GEMM and its reduction), `LAUNCHES_BY_DESIGN[(name, design)]` the same
by design, `PLAIN_ON_CUDA[name]` plain calls handed CUDA tensors.

Around the kernels, as in JAX: `_bn_train_epilogue` (normalize from the
sums, biased and clamped E[y²] − E[y]²), `_bn_eval_fold` (running
statistics folded into one affine epilogue of a plain product or
`F.conv2d`: no kernel in eval), `_bn_backward`, and the two train paths
as `torch.autograd.Function`s whose backward finishes with the linear
op's own transpose (two matrix products for the 1×1, one
`convolution_backward` for the 3×3), all in the accumulation dtype.
`conv1x1_bn_act` and `conv3x3_bn_act` are the public entry points.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.tf32 import tf32x3_split

LAUNCHES: Dict[str, int] = {"conv1x1_bn_stats": 0, "conv3x3_bn_stats": 0}
DESIGNS = ("ffma", "wgmma", "tf32x3")
LAUNCHES_BY_DESIGN: Dict[Tuple[str, str], int] = {
    (k, d): 0 for k in LAUNCHES for d in DESIGNS}
PLAIN_ON_CUDA: Dict[str, int] = {"conv1x1_bn_stats": 0,
                                 "conv3x3_bn_stats": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# design 3 (csrc/conv_fused.cu, namespace tf3): the K values whose
# products share a fresh accumulator before it is added to the float32
# sum (its kFlush k8 steps, 1 as the guard decides: PERF.md), and
# the widest B7b map whose x tile with its halo, 128 + 2 W + 2 rows, is
# one TMA box of at most 256 rows
TF32_FLUSH_DEPTH = 8
TF32_HALO_MAX_W = 63
SMEM_BYTES = 232448           # a block's shared memory on an H100


def reset_counts() -> None:
    for d in (LAUNCHES, LAUNCHES_BY_DESIGN, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def _acc_dtype(dtype):
    """float32 accumulation, float64 for float64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ------------------------------------------------------------ plain versions
def _check_products(products, dtype) -> None:
    if products not in (None, "tf32x3", "tf32"):
        raise ValueError(f"products must be None, 'tf32x3' or 'tf32'; got "
                         f"{products!r}")
    if products is not None and dtype != torch.float32:
        raise ValueError(f"products={products!r} emulates float32 "
                         f"products; got {dtype}")


def _sliced_product(xs, w, products):
    """xs @ w ([M, K] @ [K, N], float32) as design 3 sums it: each group
    of `TF32_FLUSH_DEPTH` K values from a fresh float32 sum —
    small·big + big·small, then big·big ("tf32x3"), or the one-pass
    big·big ("tf32") — added to the total in order. The tensor cores'
    truncation is the card's and is not emulated."""
    xb, xsm = tf32x3_split(xs)
    wb, wsm = tf32x3_split(w)
    tot = torch.zeros((xs.shape[0], w.shape[1]), dtype=torch.float32,
                      device=xs.device)
    for k0 in range(0, xs.shape[1], TF32_FLUSH_DEPTH):
        k = slice(k0, k0 + TF32_FLUSH_DEPTH)
        if products == "tf32":
            tot += xb[:, k] @ wb[k]
        else:
            tot += (xsm[:, k] @ wb[k] + xb[:, k] @ wsm[k]) + xb[:, k] @ wb[k]
    return tot


def matmul_with_channel_stats_plain(x2d, w, products=None):
    """Plain version of kernel B7a: (y, Σy, Σy²) with the sums taken from
    the unrounded product. `products` ("tf32x3" or "tf32") emulates
    design 3's split products and sums on float32 inputs."""
    _check_products(products, x2d.dtype)
    if x2d.is_cuda:
        PLAIN_ON_CUDA["conv1x1_bn_stats"] += 1
    acc = _acc_dtype(x2d.dtype)
    y = x2d.to(acc) @ w.to(acc) if products is None \
        else _sliced_product(x2d, w, products)
    return y.to(x2d.dtype), y.sum(0), (y * y).sum(0)


def conv3x3_with_channel_stats_plain(x, w, products=None):
    """Plain version of kernel B7b: nine shifted products over the
    zero-padded NHWC input, then the sums over B, H, W. `products` as in
    `matmul_with_channel_stats_plain`, tap by tap (design 3 takes the
    same groups, each tap's channel slices, in another order)."""
    _check_products(products, x.dtype)
    if x.is_cuda:
        PLAIN_ON_CUDA["conv3x3_bn_stats"] += 1
    acc = _acc_dtype(x.dtype)
    b, h, wd, cin = x.shape
    m = b * h * wd
    xpad = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
    wa = w.to(acc)
    tot = torch.zeros((m, w.shape[3]), dtype=acc, device=x.device)
    for dh in range(3):
        for dw in range(3):
            xs = xpad[:, dh:dh + h, dw:dw + wd, :].reshape(m, cin)
            tot += xs @ wa[dh, dw] if products is None \
                else _sliced_product(xs, wa[dh, dw], products)
    return (tot.reshape(b, h, wd, -1).to(x.dtype), tot.sum(0),
            (tot * tot).sum(0))


# ------------------------------------------------------------------ wrappers
def _on_card(x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no conv+BN statistics kernel for device "
                         f"{x.device}")
    return True


def _check_cuda(**tensors) -> None:
    first = next(iter(tensors.values()))
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"the conv+BN statistics kernels take float32 or "
                        f"bfloat16, got {first.dtype}")
    for name, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name} on {t.device}, not {first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name} is {t.dtype}, not {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def b7_design(dtype, shape: Sequence[int], ptrs: Sequence[int]) -> str:
    """The design that takes a B7 call: rows 16-byte aligned — K (B7a)
    or C (B7b) and N multiples of 8 in bfloat16, of 4 in float32 — and
    the data pointers in `ptrs` (x, w) multiples of 16, as the tensor
    maps need, go to "wgmma" (bfloat16) or "tf32x3" (float32, B7b maps
    up to `TF32_HALO_MAX_W` wide); every other call to "ffma". `shape`
    is (M, K, N) for B7a and (B, H, W, C, N) for B7b. y and design 3's
    planes are fresh from the allocator, so aligned."""
    k, n = shape[-2], shape[-1]
    per16 = {torch.bfloat16: 8, torch.float32: 4}.get(dtype)
    if per16 is None or k % per16 or n % per16 or \
            any(p % 16 for p in ptrs):
        return "ffma"
    if dtype == torch.bfloat16:
        return "wgmma"
    return "ffma" if len(shape) == 5 and shape[2] > TF32_HALO_MAX_W \
        else "tf32x3"


def wgmma_tile(shape: Sequence[int]) -> Tuple[int, int]:
    """(bn, stages) of design 2 for a B7a (M, K, N) or B7b (B, H, W, C,
    N) shape: the columns of a y tile, N rounded up to 64, 128 or 256 (so
    x is read once where N <= 256), and the depth of the shared-memory
    ring, as many stages as fit beside the staged y tile (3 at 256
    columns, else 4). The block is persistent and its ring runs on from
    one tile to the next, so the depth does not depend on K."""
    n = shape[-1]
    bn = 64 if n <= 64 else 128 if n <= 128 else 256
    return bn, 3 if bn == 256 else 4


def tf32x3_smem(bn: int, stages: int, halo_w=None) -> int:
    """Design 3's shared memory (`tf3::smem_bytes` in csrc/conv_fused.cu):
    alignment slack; the ring, a stage the 128 x 32 slice of x (B7a) and
    two bn x 32 boxes of the planes; B7b (`halo_w`, its map's W): two
    slots of x tiles with their halo, 128 + 2 W + 2 rows of 32 floats in
    whole 1 KB atoms; the partials; the barriers."""
    stage = (0 if halo_w is not None else 128 * 32 * 4) + 2 * bn * 32 * 4
    halo = 0 if halo_w is None else \
        2 * (-(-(128 + 2 * halo_w + 2) * 128 // 1024) * 1024)
    return 1024 + stages * stage + halo + 2 * 8 * bn * 4 \
        + 2 * (stages + 2) * 8


def tf32x3_tile(shape: Sequence[int]) -> Tuple[int, int]:
    """(bn, stages) of design 3 for a B7a (M, K, N) or B7b (B, H, W, C, N)
    shape: 64 columns where N <= 64, else 128 (a warpgroup holds the
    float32 sum and the flush group's accumulator, 64 + 64 registers a
    thread at 128), and as many ring stages as fit, at most 6 (B7b:
    beside the halo slots)."""
    bn = 64 if shape[-1] <= 64 else 128
    halo_w = shape[2] if len(shape) == 5 else None
    stages = 2
    while stages < 6 and tf32x3_smem(bn, stages + 1, halo_w) <= SMEM_BYTES:
        stages += 1
    return bn, stages


_C_NAMES = {"conv1x1_bn_stats": "dl4j_matmul_stats",
            "conv3x3_bn_stats": "dl4j_conv3x3_stats"}


def _launch(kernel, x, w, shape, design):
    """Allocate y [M, N] and the statistics, launch `kernel` (GEMM +
    fixed-order reduction of the per-tile partials; design 3 splits w
    first, into planes of its own) in `design` and count it. The wrappers
    pass `b7_design`'s choice; `chip_smoke.py` also times design 1 on the
    shapes designs 2 and 3 take to compare them."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("conv_fused")
    dev = x.device
    n = shape[-1]
    m = shape[0] if kernel == "conv1x1_bn_stats" else \
        shape[0] * shape[1] * shape[2]
    tiles = -(-m // lib.dl4j_conv_stats_tile_m())
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    part = torch.empty((2, tiles, n), dtype=torch.float32, device=dev)
    sums = torch.empty((2, n), dtype=torch.float32, device=dev)
    ptrs = (x.data_ptr(), w.data_ptr())
    if design == "wgmma":
        fn, extra = f"{_C_NAMES[kernel]}_wgmma", wgmma_tile(shape)
    elif design == "tf32x3":
        fn, extra = f"{_C_NAMES[kernel]}_tf32x3", tf32x3_tile(shape)
        planes = torch.empty(2 * w.numel(), dtype=torch.float32, device=dev)
        ptrs += (planes.data_ptr(),)
    else:
        fn, extra = _C_NAMES[kernel], (_DTYPE_CODES[x.dtype],)
    rc = getattr(lib, fn)(
        *ptrs, y.data_ptr(), part.data_ptr(), sums.data_ptr(), *shape,
        *extra, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(lib, rc, f"{kernel} ({design})")
    LAUNCHES[kernel] += 1
    LAUNCHES_BY_DESIGN[(kernel, design)] += 1
    return y, sums[0], sums[1]


def matmul_with_channel_stats(x2d, w):
    """Kernel B7a: y = x2d @ w ([M, K] @ [K, N]) plus per-column Σy and
    Σy² of the unrounded product. Any M, K, N."""
    if x2d.ndim != 2 or w.ndim != 2 or x2d.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_with_channel_stats wants x2d [M, K] and "
                         f"w [K, N]; got {tuple(x2d.shape)}, "
                         f"{tuple(w.shape)}")
    if not _on_card(x2d):
        return matmul_with_channel_stats_plain(x2d, w)
    _check_cuda(x2d=x2d, w=w)
    shape = (*x2d.shape, w.shape[1])
    return _launch("conv1x1_bn_stats", x2d, w, shape, b7_design(
        x2d.dtype, shape, (x2d.data_ptr(), w.data_ptr())))


def conv3x3_with_channel_stats(x, w):
    """Kernel B7b: y = conv2d(x, w, stride 1, SAME) over NHWC x
    [B, H, W, C_in] and HWIO w [3, 3, C_in, C_out], plus per-channel Σy
    and Σy² of the unrounded result."""
    if x.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]) or \
            w.ndim != 4:
        raise ValueError(f"conv3x3_with_channel_stats wants x [B, H, W, C] "
                         f"and w [3, 3, C, C_out]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if not _on_card(x):
        return conv3x3_with_channel_stats_plain(x, w)
    _check_cuda(x=x, w=w)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    if max(h, wd) >= 0x7fff:
        raise ValueError(f"the 3x3 kernel takes maps below 32767 a side; "
                         f"got {h}x{wd}")
    shape = (b, h, wd, cin, cout)
    y, s, q = _launch("conv3x3_bn_stats", x, w, shape, b7_design(
        x.dtype, shape, (x.data_ptr(), w.data_ptr())))
    return y.reshape(b, h, wd, cout), s, q


# ------------------------------------------------------- shared BN epilogue
def _bn_train_epilogue(y, s, q, mval, gamma, beta, eps, relu, acc):
    """Normalize y from its (Σy, Σy²): returns (out in `acc`, batch mean,
    biased clamped batch variance)."""
    mean = s / mval
    var = torch.clamp(q / mval - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    scale = gamma.to(acc) * inv
    shift = beta.to(acc) - mean * scale
    pre = torch.addcmul(shift, y, scale)
    return (torch.relu_(pre) if relu else pre), mean, var


def _bn_eval_fold(y, gamma, beta, mean, var, eps, relu, acc, out_dtype):
    """Eval: the running statistics as one affine (+ relu) epilogue."""
    inv = torch.rsqrt(var.to(acc) + eps)
    scale = gamma.to(acc) * inv
    shift = beta.to(acc) - mean.to(acc) * scale
    pre = torch.addcmul(shift, y, scale)
    if relu:
        pre = torch.relu_(pre)
    return pre.to(out_dtype)


def _bn_backward(dout, y, gamma, beta, mean, var, eps, relu, axes, mval,
                 ct):
    """Training-mode BN backward through the epilogue: (dy with respect
    to the linear op's output, dgamma, dbeta) in `ct`. The running
    statistics carry no gradient."""
    inv = torch.rsqrt(var + eps)
    xhat = (y.to(ct) - mean) * inv
    g = dout.to(ct)
    gam = gamma.to(ct)
    if relu:
        g = g * ((gam * xhat + beta.to(ct)) > 0)
    dbeta = g.sum(axes)
    dgamma = (g * xhat).sum(axes)
    dxhat = g * gam
    dy = inv * (dxhat - dxhat.sum(axes) / mval
                - xhat * (dxhat * xhat).sum(axes) / mval)
    return dy, dgamma, dbeta


# ---------------------------------------------------------------- train path
class Conv1x1BNTrain(torch.autograd.Function):
    """(out, batch mean, batch var) = BN(x2d @ w) + relu, B7a forward;
    the backward is `_bn_backward` then the product's two transposes."""

    @staticmethod
    def forward(ctx, x2d, w, gamma, beta, eps, relu):
        acc = _acc_dtype(x2d.dtype)
        y, s, q = matmul_with_channel_stats(x2d, w)
        out, mean, var = _bn_train_epilogue(y, s, q, x2d.shape[0], gamma,
                                            beta, eps, relu, acc)
        ctx.save_for_backward(x2d, w, gamma, beta, y, mean, var)
        ctx.eps, ctx.relu = eps, relu
        ctx.mark_non_differentiable(mean, var)
        return out.to(x2d.dtype), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x2d, w, gamma, beta, y, mean, var = ctx.saved_tensors
        ct = _acc_dtype(x2d.dtype)
        dy, dgamma, dbeta = _bn_backward(dout, y, gamma, beta, mean, var,
                                         ctx.eps, ctx.relu, 0, x2d.shape[0],
                                         ct)
        dx = (dy @ w.to(ct).t()).to(x2d.dtype) \
            if ctx.needs_input_grad[0] else None
        dw = (x2d.to(ct).t() @ dy).to(w.dtype)
        return dx, dw, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, \
            None


class Conv3x3BNTrain(torch.autograd.Function):
    """(out, batch mean, batch var) = BN(conv3x3(x, w)) + relu, B7b
    forward; the backward is `_bn_backward` then the convolution's own
    backward (cuDNN on the card) in the accumulation dtype."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, eps, relu):
        b, h, wd, _ = x.shape
        acc = _acc_dtype(x.dtype)
        y, s, q = conv3x3_with_channel_stats(x, w)
        out, mean, var = _bn_train_epilogue(y, s, q, b * h * wd, gamma,
                                            beta, eps, relu, acc)
        ctx.save_for_backward(x, w, gamma, beta, y, mean, var)
        ctx.eps, ctx.relu = eps, relu
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, w, gamma, beta, y, mean, var = ctx.saved_tensors
        b, h, wd, _ = x.shape
        ct = _acc_dtype(x.dtype)
        dy, dgamma, dbeta = _bn_backward(dout, y, gamma, beta, mean, var,
                                         ctx.eps, ctx.relu, (0, 1, 2),
                                         b * h * wd, ct)
        # NHWC / HWIO seen as NCHW / OIHW views (channels-last strides)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy.permute(0, 3, 1, 2), x.to(ct).permute(0, 3, 1, 2),
            w.to(ct).permute(3, 2, 0, 1), None, [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1, [ctx.needs_input_grad[0], True, False])
        dx = None if dx is None else dx.permute(0, 2, 3, 1).to(x.dtype)
        return (dx, dw.permute(2, 3, 1, 0).to(w.dtype).contiguous(),
                dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None)


# ------------------------------------------------------------- public API
def conv1x1_bn_act(x, w, gamma, beta, *, mean=None, var=None, stride=(1, 1),
                   eps: float = 1e-5, relu: bool = True, train: bool = False):
    """Fused 1×1 conv + batch norm + (optional) relu over NHWC input.

    x [B, H, W, C_in]; w [C_in, C_out]; gamma/beta [C_out].
    train=True: (out, batch mean, batch var), the statistics from kernel
    B7a; the running-statistics update is the caller's (they carry no
    gradient). train=False: out, normalized with the given running
    mean/var folded into one epilogue of a plain product.
    A stride takes the strided rows first, as a copy (B7a reads dense
    rows; reading by strides is later work)."""
    sh, sw = stride
    if (sh, sw) != (1, 1):
        x = x[:, ::sh, ::sw, :]
    b, h, wd, c = x.shape
    n = w.shape[1]
    x2d = x.reshape(b * h * wd, c).contiguous()
    if train:
        out2d, bmean, bvar = Conv1x1BNTrain.apply(x2d, w.contiguous(), gamma,
                                                  beta, eps, relu)
        return out2d.reshape(b, h, wd, n), bmean, bvar
    acc = _acc_dtype(x.dtype)
    pre = x2d.to(acc) @ w.to(acc)
    return _bn_eval_fold(pre, gamma, beta, mean, var, eps, relu, acc,
                         x.dtype).reshape(b, h, wd, n)


def conv3x3_bn_act(x, w, gamma, beta, *, mean=None, var=None,
                   eps: float = 1e-5, relu: bool = True,
                   train: bool = False):
    """Fused 3×3 stride-1 SAME conv + batch norm + (optional) relu over
    NHWC input with an HWIO kernel; the contract of `conv1x1_bn_act`,
    with kernel B7b in training and `F.conv2d` in eval."""
    if train:
        return Conv3x3BNTrain.apply(x.contiguous(), w.contiguous(), gamma,
                                    beta, eps, relu)
    acc = _acc_dtype(x.dtype)
    y = F.conv2d(x.to(acc).permute(0, 3, 1, 2),
                 w.to(acc).permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    return _bn_eval_fold(y, gamma, beta, mean, var, eps, relu, acc, x.dtype)
