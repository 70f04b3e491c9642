"""Fused LSTM over a whole sequence — the port of
`deeplearning4j_tpu/ops/lstm.py`.

The input projection x@W+b for ALL timesteps happens outside, as one
`torch.matmul` (as JAX leaves it to XLA); the kernels fuse the sequential
recurrence. Three kernels, hand-written in CUDA C++ for Hopper
(`csrc/lstm.cu`), in float32 and bfloat16:

- B2a, `lstm_fwd(..., with_residuals=True)` (replaces `_fwd_kernel`):
  hs, the final carries hT and cT, and the residuals cs and the activated
  gates that the backward reads;
- B2b, `lstm_fwd(..., with_residuals=False)` (replaces
  `_fwd_kernel_inference`): hs, hT and cT only;
- B2c, `lstm_bwd` (replaces `_bwd_kernel`): the reverse-time recurrence
  (dxw, dh0, dc0), then a second launch for the weight gradients dRW =
  [h0; hs[:-1]]^T dxw and dP, which the TPU kernel sums in scratch
  across its sequential grid.

The forward comes in two designs, chosen by `b2_design` from the shape
and the card before the launch (neither is a fallback of the other):
"cluster" (design 1: a cluster of 8 blocks walks T for 8 batch rows,
re-reading RW from L2 every step) and "persistent" (design 2: one block
an SM for the whole sequence, each holding its strip of RW in shared
memory, a barrier a step between the blocks of a batch tile). B2c's
two launches have two designs each (`B2C_DESIGNS`): its recurrence
"cluster" (design 1, from a transposed copy of RW) or "persistent"
(design 2, the forward's grid run in reverse time, each block's partial
dh exchanged through L2 at one barrier a step), chosen by `b2c_design`
as the forward is; its weight product "tiled" (design 1) or "pipelined"
(design 2, a cp.async-fed SGEMM over `b2c_splits` slices of T·B), which
needs no residency and takes every shape. `LAUNCHES_BY_DESIGN[(kernel,
design)]` counts the launches of each.

bfloat16 has two designs of each launch: the forward and B2c's
recurrence "cluster" and "persistent" (the latter with its product on
the tensor cores and a bfloat16 strip of RW, chosen by `b2_design` and
`b2c_design` with bfloat16's shared-memory arithmetic), the weight
product "tiled" and "wgmma" (a tensor-core GEMM fed by TMA, chosen by
`b2c_weights_design` where H is a multiple of 8). Its launches count as
`LAUNCHES["<kernel>_bf16"]`
and `LAUNCHES_BY_DESIGN[(kernel, "<design>_bf16")]` (`BF16_DESIGNS`),
and each wrapper's choice as `kernel_dispatch_total{op="lstm",
impl="<kernel>/<design>"}`. Its arithmetic rounds where the Pallas
body's does, which is after every operation (the plain versions, run on
bfloat16 tensors, equal JAX's interpret run bit for bit, sigmoid written
as 1 / (1 + exp(-x)) as XLA expands it); dRW and dP alone differ by
design: the Pallas kernel keeps a running bfloat16 sum over T, the CUDA
kernels a float32 sum (in "wgmma", of float32 slices added in order:
`lstm_weights_plain(..., slices=...)`) rounded once, and `c13_bound`
states how far apart that may put them (contract C13). `bf16_check`
holds every other output to its plain version (`bf16_atol`, and the
share of elements that differ, `BF16_SHARE`).

`fused_lstm` chooses before it applies its `torch.autograd.Function`:
B2b when no input wants a gradient (or grad is disabled), else the
Function, B2a with the residuals saved and B2c as its backward, as JAX's primal call runs the inference kernel and only the VJP's
forward the training one. Gate order i, f, g, o; sigmoid gates, tanh
cell; peepholes `p` [3, H] (zeros disable them, and then give the
peephole-free LSTM bit for bit); `mask` [T, B] holds the carry where 0.

Beside each kernel stands its plain PyTorch version: `lstm_fwd_plain` (a
loop over T with the cell's math) and `lstm_bwd_plain` (the backward
written out by hand as `_bwd_kernel` does, not autograd of the forward).
A wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Each wrapper adds one to
`LAUNCHES[name]` for each kernel it launches, and each plain version adds
one to `PLAIN_ON_CUDA[name]` when handed CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Tuple

import torch

MAX_HIDDEN = 1024         # 8 blocks a cluster x 128 hidden columns a block
DESIGNS = ("cluster", "persistent")
PERSISTENT_ROWS = (8, 16, 32, 64)     # batch rows a design-2 block takes
PERSISTENT_MIN_STEPS = 8              # shorter sequences stay on design 1

KERNELS = ("lstm_fwd", "lstm_fwd_inference", "lstm_bwd", "lstm_bwd_weights")
# bfloat16 launches count under their own names ("lstm_fwd_bf16", ...)
LAUNCHES: Dict[str, int] = {k + sfx: 0 for k in KERNELS
                            for sfx in ("", "_bf16")}
PLAIN_ON_CUDA: Dict[str, int] = {"lstm_fwd": 0, "lstm_fwd_inference": 0,
                                 "lstm_bwd": 0}
B2C_DESIGNS = {"lstm_bwd": ("cluster", "persistent"),
               "lstm_bwd_weights": ("tiled", "pipelined")}
WEIGHT_TILE = 128                     # the pipelined SGEMM's tile of dRW
# the bfloat16 wgmma GEMM's tile of dRW (rows, columns) and its K tile
WGMMA_TILE = (128, 256)
WGMMA_DEPTH = 64
WGMMA_MAX_SPLITS = 8                  # the slices of a tile: one cluster

# the designs each launch has in bfloat16, design 1 first, counted as
# "<design>_bf16"
BF16_DESIGNS = {"lstm_fwd": DESIGNS, "lstm_fwd_inference": DESIGNS,
                "lstm_bwd": ("cluster", "persistent"),
                "lstm_bwd_weights": ("tiled", "wgmma")}

LAUNCHES_BY_DESIGN: Dict[Tuple[str, str], int] = {
    **{(k, d): 0 for k in ("lstm_fwd", "lstm_fwd_inference")
       for d in DESIGNS},
    **{(k, d): 0 for k, ds in B2C_DESIGNS.items() for d in ds},
    **{(k, d + "_bf16"): 0 for k, ds in BF16_DESIGNS.items() for d in ds}}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernels' dtype codes


def reset_counts() -> None:
    for d in (LAUNCHES, LAUNCHES_BY_DESIGN, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def fused_lstm_available(gate_activation: str,
                         activation: Optional[str]) -> bool:
    """The kernels hard-code sigmoid gates and a tanh cell
    (`activation=None` is identity, not tanh)."""
    return gate_activation == "sigmoid" and activation == "tanh"


# ------------------------------------------------------------ plain versions
def _sigmoid(x):
    """The gates' sigmoid. In bfloat16 (and float16) 1 / (1 + exp(-x)),
    each operation rounded to x's dtype: the form XLA expands the Pallas
    body's sigmoid into, and the kernels' `sigm_r`, where `torch.sigmoid`
    rounds once and differs in the last bit. In float32 and float64,
    `torch.sigmoid`."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def _wide(x):
    """x in float32 where it is narrower (a sum taken unrounded)."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def lstm_fwd_plain(xw, rw, p, h0, c0, mask, with_residuals: bool = True):
    """Plain version of kernels B2a (`with_residuals`) and B2b: returns
    (hs [T, B, H], cs [T, B, H] | None, gates [T, B, 4H] | None, hT, cT).
    Plain tensor ops, so autograd can differentiate it (the tests hold
    `lstm_bwd_plain` against that)."""
    if xw.is_cuda:
        PLAIN_ON_CUDA["lstm_fwd" if with_residuals
                      else "lstm_fwd_inference"] += 1
    T, H = xw.shape[0], xw.shape[2] // 4
    h, c = h0, c0
    hs, cs, gs = [], [], []
    for t in range(T):
        z = xw[t] + h @ rw
        i = _sigmoid(z[:, :H] + c * p[0:1])
        f = _sigmoid(z[:, H:2 * H] + c * p[1:2])
        g = torch.tanh(z[:, 2 * H:3 * H])
        c_new = f * c + i * g
        o = _sigmoid(z[:, 3 * H:] + c_new * p[2:3])
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs.append(h)
        if with_residuals:
            cs.append(c)
            gs.append(torch.cat([i, f, g, o], dim=-1))
    if with_residuals:
        return torch.stack(hs), torch.stack(cs), torch.stack(gs), h, c
    return torch.stack(hs), None, None, h, c


def lstm_bwd_plain(rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT, dcT):
    """Plain version of kernel B2c, written out as `_bwd_kernel` does:
    returns (dxw [T, B, 4H], dh0, dc0, dRW [H, 4H], dP [3, H])."""
    if hs.is_cuda:
        PLAIN_ON_CUDA["lstm_bwd"] += 1
    T, _, H = hs.shape
    dh, dc = dhT, dcT
    dxw = [None] * T
    for t in range(T - 1, -1, -1):
        gt = gates[t]
        i, f, g, o = (gt[:, :H], gt[:, H:2 * H], gt[:, 2 * H:3 * H],
                      gt[:, 3 * H:])
        c_t = cs[t]
        # the predecessor of step 0 is the initial carry
        c_prev = c0 if t == 0 else cs[t - 1]
        m = mask[t][:, None]
        dh_in = dhs[t] + dh
        dh_t = m * dh_in
        pass_h = (1.0 - m) * dh_in
        tanh_c = torch.tanh(c_t)
        do_pre = dh_t * tanh_c * o * (1.0 - o)
        dc_new = (m * dc + dh_t * o * (1.0 - tanh_c * tanh_c)
                  + do_pre * p[2:3])
        di_pre = dc_new * g * i * (1.0 - i)
        df_pre = dc_new * c_prev * f * (1.0 - f)
        dg_pre = dc_new * i * (1.0 - g * g)
        dc = (dc_new * f + (1.0 - m) * dc + di_pre * p[0:1]
              + df_pre * p[1:2])
        dgates = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=-1)
        dh = dgates @ rw.T + pass_h
        dxw[t] = dgates
    dxw = torch.stack(dxw)
    return (dxw, dh, dc, *lstm_weights_plain(hs, h0, dxw, cs, c0))


def lstm_weights_plain(hs, h0, dxw, cs, c0, running: bool = True,
                       slices=None):
    """(dRW, dP) of B2c's second launch from the recurrence's dxw, as
    plain tensor ops: with `running`, the Pallas kernel's running sum
    over T (from T - 1 down) in the tensors' dtype, `lstm_bwd_plain`'s;
    else each a float32 sum over T·B rounded once to the dtype, the CUDA
    kernels' arithmetic. With `slices` ((k0, k1) ranges of the T·B rows
    of hprev = [h0; hs[:-1]], as `b2c_wgmma_slices` gives them; implies
    not `running`), dRW is the sum of the slices' float32 products added
    in slice order, as the "wgmma" design adds its partials. In float32
    the forms differ only in summation order. dP's products are summed
    unrounded, as XLA fuses them into the reduce; a step's sums round
    before the running sum."""
    T, B, H = hs.shape
    dt = hs.dtype
    h_prev = torch.cat([h0[None], hs[:-1]])
    c_prev = torch.cat([c0[None], cs[:-1]])
    if not running or slices is not None:
        w = _wide
        if slices is None:
            drw = torch.einsum("tbk,tbn->kn", w(h_prev), w(dxw))
        else:
            hp = w(h_prev).reshape(T * B, H)
            d = w(dxw).reshape(T * B, 4 * H)
            drw = None
            for k0, k1 in slices:
                prod = hp[k0:k1].T @ d[k0:k1]
                drw = prod if drw is None else drw + prod
        dp = torch.stack([(w(dxw[..., :H]) * w(c_prev)).sum((0, 1)),
                          (w(dxw[..., H:2 * H]) * w(c_prev)).sum((0, 1)),
                          (w(dxw[..., 3 * H:]) * w(cs)).sum((0, 1))])
        return drw.to(dt), dp.to(dt)
    drw = torch.zeros((H, 4 * H), dtype=dt, device=hs.device)
    dp = torch.zeros((3, H), dtype=dt, device=hs.device)
    for t in range(T - 1, -1, -1):
        d = dxw[t]
        drw = drw + h_prev[t].T @ d
        dp = dp + torch.stack([(_wide(d[:, :H]) * _wide(c_prev[t])).sum(0),
                               (_wide(d[:, H:2 * H]) * _wide(c_prev[t])
                                ).sum(0),
                               (_wide(d[:, 3 * H:]) * _wide(cs[t])).sum(0)]
                              ).to(dt)
    return drw, dp


# --------------------------------------------------------- bfloat16 contract
BF16_STEP = 2.0 ** -7          # a bfloat16 step (ulp) at [1, 2)
# the share of a sequence-long output's elements that may differ at all
BF16_SHARE = 2.0 ** -3
_SEQUENCE_OUTPUTS = ("hs", "cs", "gates", "dxw")


def bf16_atol(name: str, want: torch.Tensor) -> float:
    """The bfloat16 tolerance of a B2 output against its plain version.
    The kernels round after every operation where the plain version
    does, so the two part only where a float32 sum in another order (or
    the card's expf/tanhf) lands across a rounding; the recurrence then
    carries that step on, as it carries the plain version's against
    itself with its products summed in another exact order (at T 128, B
    64, H 512: hs 3 steps apart, dxw 0.0127 of its largest magnitude;
    `tests/test_torch_lstm_bf16.py`). So: 2^-5 absolute on hs, hT and the
    gates, which lie in [-1, 1]; 2^-5 of the largest magnitude on cs and
    cT, and 2^-4 on the gradients dxw, dh0 and dc0, which are not bounded
    by 1."""
    if name in ("hs", "hT", "gates"):
        return 2.0 ** -5
    scale = float(want.float().abs().max())
    return (2.0 ** -5 if name in ("cs", "cT") else 2.0 ** -4) * scale


def bf16_check(name: str, got: torch.Tensor,
               want: torch.Tensor) -> Tuple[bool, float, float]:
    """(within the contract, largest error, share of elements that
    differ): the largest error within `bf16_atol`, and for a
    sequence-long output (hs, cs, gates, dxw) at most `BF16_SHARE` of its
    elements different at all. The share is what tells rounding points
    apart: at `path_l`'s shape the plain version against itself in
    another sum order differs in about 1% of hs, the CUDA kernel against
    the plain version run on the CPU (JAX's arithmetic bit for bit) in
    4% (and the plain version run on the card in 12%: its bfloat16
    products land otherwise), a version rounding only where it stores
    in 70%. So the card's kernels are held to the plain version run on
    the CPU."""
    d = (got.float() - want.float()).abs()
    err, share = float(d.max()), float((d > 0).float().mean())
    ok = err <= bf16_atol(name, want) and (
        name not in _SEQUENCE_OUTPUTS or share <= BF16_SHARE)
    return ok, err, share


def _weight_products(hs, h0, dxw, cs, c0):
    """B2c's weight launch step by step in float32: the steps' products
    P [T, H, 4H] and [T, 3, H] (dRW's and dP's) and the sums of their
    terms' magnitudes A, of the same shapes."""
    H = hs.shape[2]
    w = _wide
    h_prev = w(torch.cat([h0[None], hs[:-1]]))
    c_prev = w(torch.cat([c0[None], cs[:-1]]))
    d = w(dxw)
    prw = torch.einsum("tbk,tbn->tkn", h_prev, d)
    arw = torch.einsum("tbk,tbn->tkn", h_prev.abs(), d.abs())
    terms = (d[..., :H] * c_prev, d[..., H:2 * H] * c_prev,
             d[..., 3 * H:] * w(cs))
    pp = torch.stack([x.sum(1) for x in terms], dim=1)
    ap = torch.stack([x.abs().sum(1) for x in terms], dim=1)
    return (prw, arw), (pp, ap)


def c13_bound(hs, h0, dxw, cs, c0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contract C13: the elementwise bound on |kernel - plain| for B2c's
    dRW and dP in bfloat16, on the same dxw. The plain version (and the
    Pallas kernel) keeps a running bfloat16 sum S_t = rnd(S_{t-1} +
    rnd(P_t)) over the steps' products P_t; the CUDA kernel sums in
    float32 and rounds once. Each bfloat16 rounding errs by at most u =
    2^-8 of its value, so to first order the two lie within u (|S_T| +
    sum_t (|P_t| + |S_t|)), S and P in float32 from the same inputs;
    each float32 sum of the n = T·B terms errs by at most n 2^-24 of the
    sum of their magnitudes A (`weights_f32_err`), which the two sides'
    float32 sums add twice."""
    T, B, _ = hs.shape
    out = []
    for prod, mag in _weight_products(hs, h0, dxw, cs, c0):
        srt = torch.cumsum(prod.flip(0), 0)      # S_t, in the sum's order
        out.append(2.0 ** -8 * (srt[-1].abs() + prod.abs().sum(0)
                                + srt.abs().sum(0))
                   + 2 * T * B * 2.0 ** -24 * mag.sum(0))
    return out[0], out[1]


def weights_f32_err(hs, h0, dxw, cs, c0) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The elementwise bound on how far a float32 sum of dRW's (dP's)
    n = T·B terms may lie from the exact sum: n 2^-24 of the sum of the
    terms' magnitudes (the standard bound of recursive summation; it
    matters where the terms cancel)."""
    T, B, _ = hs.shape
    return tuple(T * B * 2.0 ** -24 * mag.sum(0)
                 for _, mag in _weight_products(hs, h0, dxw, cs, c0))


# ------------------------------------------------------------------ wrappers
def _check_shapes(xw, rw, p, h0, c0, mask) -> None:
    if xw.ndim != 3 or xw.shape[2] % 4 or xw.shape[0] < 1:
        raise ValueError(f"fused LSTM wants xw [T >= 1, B, 4H]; got "
                         f"{tuple(xw.shape)}")
    T, B, H4 = xw.shape
    H = H4 // 4
    want = {"rw": (H, H4), "p": (3, H), "h0": (B, H), "c0": (B, H),
            "mask": (T, B)}
    for name, t in zip(want, (rw, p, h0, c0, mask)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected "
                             f"{want[name]} for xw {tuple(xw.shape)}")


def _check_cuda(tensors: dict) -> None:
    first = next(iter(tensors.values()))
    if first.dtype not in DTYPES:
        raise TypeError(f"the CUDA LSTM kernels take float32 or bfloat16; "
                        f"got {first.dtype}")
    for name, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name} on {t.device}, not {first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"the CUDA LSTM kernels take one dtype a call; "
                            f"{name} is {t.dtype}, not {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             f"copy 16 bytes at a time)")


def _check_hidden(H: int) -> None:
    if H > MAX_HIDDEN:
        raise ValueError(f"the CUDA LSTM kernels take a hidden size of at "
                         f"most {MAX_HIDDEN}; got {H}")


def _on_card(x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {x.device}")
    return True


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def b2_rows(B: int, H: int, sms: int, smem: int,
            esize: int = 4) -> Optional[int]:
    """The batch rows a design-2 block takes (BR; it computes BR x 1024
    / BR pre-activations, so 256 / BR hidden columns), or None where no BR
    fits: the smallest BR of `PERSISTENT_ROWS` (the least of h a block
    copies a step) whose grid, ceil(B / BR) x ceil(H / (256 / BR))
    blocks, fits one block on each of `sms` SMs, and whose shared memory
    fits the `smem` bytes a block may ask for. For float32 (`esize` 4):
    the resident strip of RW, [H, 1024 / BR] float32, beside the h tile
    [H, BR] or the 8 warps' partial sums, whichever is larger
    (`csrc/lstm.cu` `persist::launch`). For bfloat16 (`esize` 2,
    `persist::launch_bf16`): the strip [1024 / BR, row] and the h tile
    [BR, row] in bfloat16, a row being H rounded up to 16 plus 8, and the
    rounded products [BR, 1024 / BR] float32; so BR 8 fits at H 512."""
    for br in PERSISTENT_ROWS:
        nc = 1024 // br
        blocks = -(-B // br) * -(-H // (nc // 4))
        if esize == 2:
            row = -(-H // 16) * 16 + 8
            nbytes = 2 * row * (nc + br) + 4 * br * nc
        else:
            nbytes = 4 * (H * nc + max(H * br, 8 * br * (nc + 4)))
        if blocks <= sms and nbytes <= smem:
            return br
    return None


def card_limits(device) -> Tuple[int, int]:
    """(SMs, shared-memory bytes a block may ask for) of a CUDA card:
    the SM's shared memory less the 1 KB the runtime keeps a block."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, \
        props.shared_memory_per_multiprocessor - 1024


def b2_design(T: int, B: int, H: int, sms: int, smem: int,
              dtype=torch.float32) -> str:
    """The design that takes a forward call (B2a with residuals, B2b
    without: the same rule) on a card of `sms` SMs and `smem` bytes of
    shared memory a block: "persistent" (design 2) for sequences of at
    least PERSISTENT_MIN_STEPS steps where `b2_rows` finds a tile that
    fits, else "cluster" (design 1, which takes every hidden size up to
    MAX_HIDDEN). Design 2 pays a fixed cost a call (a cooperative launch
    whose blocks stage their strips of RW) for cheaper steps, so a short
    sequence (`rnn_time_step`'s T 1) stays on design 1 (`chip_smoke.py`
    times both designs at T 1, 4, 8, 50 and 200). bfloat16 takes the
    same rule with its own shared-memory arithmetic (`b2_rows` with
    `esize` 2: its strip is bfloat16 and its product runs on the tensor
    cores). A pure function of the shape, the dtype and the card, decided
    before the launch."""
    esize = 2 if dtype == torch.bfloat16 else 4
    if T < PERSISTENT_MIN_STEPS or b2_rows(B, H, sms, smem, esize) is None:
        return "cluster"
    return "persistent"


def _b2c_ksplit(tiles: int) -> int:
    """The thread groups (at most one a warp of 8) that split a design-2
    backward block's product over its gate columns, so that its
    `tiles` thread tiles of 8 rows x 4 k keep 256 threads busy
    (`csrc/lstm.cu` `persist::bwd_ksplit`)."""
    q = 1
    while q < 8 and 2 * q * tiles <= 256:
        q *= 2
    return q


def b2c_rows(B: int, H: int, sms: int, smem: int,
             esize: int = 4) -> Optional[int]:
    """The batch rows a block of B2c's design-2 recurrence takes (BR; its
    256 threads hold BR x 256 / BR cells, so 256 / BR hidden columns and
    their NC = 1024 / BR gate columns), or None where none fits: the
    smallest BR of `PERSISTENT_ROWS` (the least partial dh a block
    writes and reads a step) whose grid, ceil(B / BR) x ceil(H / (256 /
    BR)) blocks, fits one block on each of `sms` SMs, and whose shared
    memory fits the `smem` bytes a block may ask for. For float32
    (`esize` 4, `csrc/lstm.cu` `persist::launch_bwd`): the resident strip
    of RW transposed, [NC, Hp + 4] float32 (Hp = H rounded up to 4), the
    step's gate gradients [NC, BR], and where the product's thread tiles
    are fewer than the threads (`_b2c_ksplit`), the groups' sums [Q, BR,
    Hp]. For bfloat16 (`esize` 2, `persist::launch_bwd_bf16`): the strip
    as RW lies, [HK, NC + 8], and the gate gradients [BR, NC + 8], both
    bfloat16 (HK = H rounded up to 16; a row padded by 8 for `ldmatrix`),
    and no reduction buffer; so BR 8 fits at H 512 (141,440 bytes)."""
    hp = -(-H // 4) * 4
    for br in PERSISTENT_ROWS:
        nc = 1024 // br
        blocks = -(-B // br) * -(-H // (nc // 4))
        if esize == 2:
            nbytes = 2 * (nc + 8) * (-(-H // 16) * 16 + br)
        else:
            q = _b2c_ksplit(br // 8 * hp // 4)
            nbytes = 4 * (nc * (hp + 4) + nc * br
                          + (q * br * hp if q > 1 else 0))
        if blocks <= sms and nbytes <= smem:
            return br
    return None


def b2c_design(T: int, B: int, H: int, sms: int, smem: int,
               dtype=torch.float32) -> str:
    """The design of B2c's recurrence on a card of `sms` SMs and `smem`
    bytes of shared memory a block, by `b2_design`'s rule: "persistent"
    (design 2) for sequences of at least PERSISTENT_MIN_STEPS steps where
    `b2c_rows` finds a tile whose grid can be resident at once, else
    "cluster" (design 1, which takes every hidden size up to MAX_HIDDEN;
    `chip_smoke.py` times both at its LSTM shapes from T 4 to 200). The
    weight product's design is `b2c_weights_design`'s. bfloat16 takes
    the same rule with its own shared-memory arithmetic (`b2c_rows` with
    `esize` 2: its strip is bfloat16 and its product runs on the tensor
    cores), so T < 8 and H 1024 at B 64 stay on design 1. A pure
    function of the shape, the dtype and the card, decided before the
    launch."""
    esize = 2 if dtype == torch.bfloat16 else 4
    if T < PERSISTENT_MIN_STEPS or b2c_rows(B, H, sms, smem, esize) is None:
        return "cluster"
    return "persistent"


def b2c_weights_design(H: int, dtype=torch.float32) -> str:
    """The design of B2c's weight product at hidden size H: "pipelined"
    (design 2) in float32 at every H; in bfloat16 "wgmma" (design 2, the
    tensor-core GEMM, whose TMA loads want 16-byte rows) where H is a
    multiple of 8, else "tiled" (design 1). Decided before the launch."""
    if dtype != torch.bfloat16:
        return "pipelined"
    return "wgmma" if H % 8 == 0 else "tiled"


def b2c_splits(T: int, B: int, H: int, sms: int) -> int:
    """The slices of K = T·B that the pipelined weight product splits
    over: as many as two resident blocks on each of `sms` SMs allow for
    its ceil(H / 128) x ceil(4H / 128) tiles, with at least 256 rows of K
    a slice, and at most 16 (`path_l`: 4 on 132 SMs)."""
    tiles = -(-H // WEIGHT_TILE) * -(-4 * H // WEIGHT_TILE)
    return max(1, min(2 * sms // tiles, T * B // 256, 16))


def _wgmma_ktiles(T: int, B: int) -> Tuple[int, int]:
    """The "wgmma" weight product's K tiles of WGMMA_DEPTH rows: (those
    of h0, all of hprev = [h0; hs[:-1]]). hprev straddles two tensors,
    so its tiles come in two runs: h0's B rows, then hs's (T - 1) B."""
    n0 = -(-B // WGMMA_DEPTH)
    return n0, n0 + -(-(T - 1) * B // WGMMA_DEPTH)


def b2c_wgmma_splits(T: int, B: int, H: int, sms: int,
                     clusters=None) -> int:
    """The slices of the K tiles that the "wgmma" weight product splits
    over. The slices of a tile of dRW are one cluster, so: the most
    slices, at most WGMMA_MAX_SPLITS and with at least 4 K tiles (256
    rows) each, for which the card holds the clusters of all ceil(H /
    128) x ceil(4H / 256) tiles at once (`clusters(size)`: the clusters
    of `size` blocks it runs together, `wgmma_clusters` on a card; by
    default `sms // size`, one block an SM with no GPC left short); then
    as few as give each slice the same count of K tiles, ceil(tiles /
    slices), so that none is empty. `path_l`: 32 tiles of dRW and 128 K
    tiles; 4 slices on 132 SMs by default, 3 on an H100 whose GPCs hold
    fewer than 32 clusters of 4."""
    tiles = -(-H // WGMMA_TILE[0]) * -(-4 * H // WGMMA_TILE[1])
    nk = _wgmma_ktiles(T, B)[1]
    if clusters is None:
        clusters = lambda size: sms // size  # noqa: E731
    splits = 1
    for s in range(2, min(nk // 4, WGMMA_MAX_SPLITS) + 1):
        if clusters(s) >= tiles:
            splits = s
    per = -(-nk // splits)
    return -(-nk // per)


_CLUSTERS: Dict[Tuple[int, int], int] = {}


def wgmma_clusters(device) -> Callable[[int], int]:
    """`clusters(size)` for `b2c_wgmma_splits` on a CUDA card: how many
    clusters of `size` blocks of the "wgmma" weight product it runs at
    once (`cudaOccupancyMaxActiveClusters`), asked once a size."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index

    def clusters(size: int) -> int:
        key = (index, size)
        if key not in _CLUSTERS:
            lib = cuda_build.library("lstm")
            with torch.cuda.device(index):
                n = lib.dl4j_lstm_wgmma_max_clusters(size)
            if n < 0:
                cuda_build.check(lib, -n, "lstm wgmma cluster occupancy")
            _CLUSTERS[key] = n
        return _CLUSTERS[key]

    return clusters


def b2c_wgmma_slices(T: int, B: int,
                     splits: int) -> List[Tuple[int, int]]:
    """The (k0, k1) ranges of hprev's T·B rows that the "wgmma" weight
    product's `splits` slices sum, in order (`csrc/lstm.cu`
    `wg::launch`): slice s takes K tiles [s per, (s + 1) per), per =
    ceil(tiles / splits); tile i < n0 covers h0's rows [64 i, 64 (i + 1))
    and tile n0 + j hs's, rows [B + 64 j, B + 64 (j + 1)) of hprev, each
    cut at its run's end."""
    n0, nk = _wgmma_ktiles(T, B)
    per = -(-nk // splits)

    def start(i):
        return min(WGMMA_DEPTH * i, B) if i < n0 \
            else B + WGMMA_DEPTH * (i - n0)

    bounds = [start(i) for i in range(0, nk, per)] + [T * B]
    return list(zip(bounds, bounds[1:]))


def lstm_fwd(xw, rw, p, h0, c0, mask, with_residuals: bool = True):
    """Kernel B2a (`with_residuals`) or B2b: returns (hs, cs, gates, hT,
    cT), cs and gates None without residuals."""
    _check_shapes(xw, rw, p, h0, c0, mask)
    if not _on_card(xw):
        return lstm_fwd_plain(xw, rw, p, h0, c0, mask, with_residuals)
    _check_cuda(dict(xw=xw, rw=rw, p=p, h0=h0, c0=c0, mask=mask))
    T, B, H4 = xw.shape
    _check_hidden(H4 // 4)
    design = b2_design(T, B, H4 // 4, *card_limits(xw.device), xw.dtype)
    name = "lstm_fwd" if with_residuals else "lstm_fwd_inference"
    _record(name, design, xw.dtype)
    return launch_fwd(xw, rw, p, h0, c0, mask, with_residuals, design)


def launch_fwd(xw, rw, p, h0, c0, mask, with_residuals: bool = True,
               design: str = "cluster"):
    """Kernel B2a (`with_residuals`) or B2b alone, on checked CUDA
    tensors, in `design` (the wrapper passes `b2_design`'s choice;
    `chip_smoke.py` also times design 1 where design 2 runs): returns
    (hs, cs, gates, hT, cT)."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("lstm")
    T, B, H4 = xw.shape
    H = H4 // 4
    name = "lstm_fwd" if with_residuals else "lstm_fwd_inference"
    bf16 = _bf16_design(xw, design, name)
    if bf16 and design == "cluster":
        rw = rw.float()      # design 1 streams a float32 strip in both
    new = lambda *s: torch.empty(s, dtype=xw.dtype, device=xw.device)  # noqa
    hs, hT, cT = new(T, B, H), new(B, H), new(B, H)
    cs = new(T, B, H) if with_residuals else None
    gates = new(T, B, H4) if with_residuals else None
    args = (xw.data_ptr(), rw.data_ptr(), p.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), mask.data_ptr(), hs.data_ptr(),
            None if cs is None else cs.data_ptr(),
            None if gates is None else gates.data_ptr(), hT.data_ptr(),
            cT.data_ptr())
    if design == "persistent":
        rows = b2_rows(B, H, *card_limits(xw.device), xw.element_size())
        if rows is None:
            raise ValueError(f"no design-2 LSTM tile fits B {B}, H {H} on "
                             f"this card")
        bp = -(-B // rows) * rows
        # h between the steps, double-buffered, and the barriers' counters
        counters = torch.zeros(bp // rows, dtype=torch.int32,
                               device=xw.device)
        if bf16:
            # [2, Bp, H rounded up to 16]: the pad is the product's zero K
            hbuf = torch.zeros((2, bp, -(-H // 16) * 16), dtype=xw.dtype,
                               device=xw.device)
            rc = lib.dl4j_lstm_fwd_persistent_bf16(
                *args, hbuf.data_ptr(), counters.data_ptr(), T, B, H, rows,
                int(with_residuals), _stream(xw.device))
        else:
            hbuf = torch.empty((2, H, bp), dtype=xw.dtype, device=xw.device)
            rc = lib.dl4j_lstm_fwd_persistent(
                *args, hbuf.data_ptr(), counters.data_ptr(), T, B, H, rows,
                int(with_residuals), _stream(xw.device))
    elif design == "cluster":
        rc = lib.dl4j_lstm_fwd(*args, T, B, H, int(with_residuals),
                               DTYPES[xw.dtype], _stream(xw.device))
    else:
        raise ValueError(f"no LSTM forward design {design!r}")
    cuda_build.check(lib, rc, f"{name} ({design}, {xw.dtype})")
    _count(name, design, bf16)
    return hs, cs, gates, hT, cT


def _bf16_design(x, design: str, kernel: str) -> bool:
    """True for a bfloat16 launch of `kernel`, which takes only its
    designs of `BF16_DESIGNS`."""
    if x.dtype != torch.bfloat16:
        return False
    if design not in BF16_DESIGNS[kernel]:
        raise ValueError(f"the bfloat16 {kernel} kernel runs designs "
                         f"{BF16_DESIGNS[kernel]}, not {design!r}")
    return True


def _count(name: str, design: str, bf16: bool) -> None:
    sfx = "_bf16" if bf16 else ""
    LAUNCHES[name + sfx] += 1
    LAUNCHES_BY_DESIGN[(name, design + sfx)] += 1


def _record(name: str, design: str, dtype) -> None:
    """A wrapper's choice of design, on the metrics spine:
    `kernel_dispatch_total{op="lstm", impl="<kernel>/<design>"}` (the
    design with "_bf16" in bfloat16, as `LAUNCHES_BY_DESIGN` keys it)."""
    from deeplearning4j_tpu_torch.ops.kernel_defaults import record_dispatch

    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    record_dispatch("lstm", f"{name}/{design}{sfx}")


def lstm_bwd(rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT, dcT):
    """Kernel B2c from the forward's residuals: returns (dxw, dh0, dc0,
    dRW, dP)."""
    if not _on_card(hs):
        return lstm_bwd_plain(rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT,
                              dcT)
    T, B, H = hs.shape
    _check_hidden(H)
    _check_cuda(dict(hs=hs, rw=rw, p=p, mask=mask, cs=cs, gates=gates,
                     h0=h0, c0=c0, dhs=dhs, dhT=dhT, dcT=dcT))
    design = b2c_design(T, B, H, *card_limits(hs.device), hs.dtype)
    w_design = b2c_weights_design(H, hs.dtype)
    _record("lstm_bwd", design, hs.dtype)
    _record("lstm_bwd_weights", w_design, hs.dtype)
    dxw, dh0, dc0, dp_part = launch_bwd_recurrence(
        rw, p, mask, cs, gates, c0, dhs, dhT, dcT, design)
    drw, dp = launch_bwd_weights(hs, h0, dxw, dp_part, w_design)
    return dxw, dh0, dc0, drw, dp


def launch_bwd_recurrence(rw, p, mask, cs, gates, c0, dhs, dhT, dcT,
                          design: str = "cluster"):
    """The reverse-time kernel of B2c alone, on checked CUDA tensors, in
    `design` (the wrapper passes `b2c_design`'s choice; `chip_smoke.py`
    also times the other design on the same inputs): returns (dxw, dh0,
    dc0, dp_part [batch tiles, 3, H] float32, the tiles the design's)."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("lstm")
    T, B, H = cs.shape
    dev = cs.device
    bf16 = _bf16_design(cs, design, "lstm_bwd")
    new = lambda *s: torch.empty(s, dtype=cs.dtype, device=dev)  # noqa
    dxw, dh0, dc0 = new(T, B, 4 * H), new(B, H), new(B, H)
    if design == "persistent":
        rows = b2c_rows(B, H, *card_limits(dev), cs.element_size())
        if rows is None:
            raise ValueError(f"no design-2 LSTM backward tile fits B {B}, "
                             f"H {H} on this card")
        tiles = -(-B // rows)
        dp_part = torch.empty((tiles, 3, H), dtype=torch.float32,
                              device=dev)
        # each block's float32 partial dh between the steps, double-
        # buffered (k padded to 4, in bfloat16 to the product's 16), and
        # the barriers' counters
        part = torch.empty((2, -(-H // (256 // rows)), tiles * rows,
                            -(-H // 16) * 16 if bf16 else -(-H // 4) * 4),
                           dtype=torch.float32, device=dev)
        counters = torch.zeros(tiles, dtype=torch.int32, device=dev)
        fn = lib.dl4j_lstm_bwd_persistent_bf16 if bf16 \
            else lib.dl4j_lstm_bwd_persistent
        rc = fn(dhs.data_ptr(), gates.data_ptr(), cs.data_ptr(),
                rw.data_ptr(), p.data_ptr(), mask.data_ptr(), dhT.data_ptr(),
                dcT.data_ptr(), c0.data_ptr(), dxw.data_ptr(), dh0.data_ptr(),
                dc0.data_ptr(), dp_part.data_ptr(), part.data_ptr(),
                counters.data_ptr(), T, B, H, rows, _stream(dev))
    elif design == "cluster":
        # RW transposed once a call, in float32 (a copy, not a product), so
        # the kernel's reads of RW^T coalesce as the forward's reads of RW
        # do
        rwT = torch.empty((4 * H, H), dtype=torch.float32, device=dev)
        rwT.copy_(rw.t())
        dp_part = torch.empty((-(-B // lib.dl4j_lstm_batch_tile()), 3, H),
                              dtype=torch.float32, device=dev)
        rc = lib.dl4j_lstm_bwd(
            dhs.data_ptr(), gates.data_ptr(), cs.data_ptr(), rwT.data_ptr(),
            p.data_ptr(), mask.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
            c0.data_ptr(), dxw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            dp_part.data_ptr(), T, B, H, DTYPES[cs.dtype], _stream(dev))
    else:
        raise ValueError(f"no LSTM backward design {design!r}")
    cuda_build.check(lib, rc, f"lstm_bwd ({design}, {cs.dtype})")
    _count("lstm_bwd", design, bf16)
    return dxw, dh0, dc0, dp_part


def launch_bwd_weights(hs, h0, dxw, dp_part, design: str = "tiled"):
    """The weight-gradient launch of B2c alone, on checked CUDA tensors,
    in `design` (the wrapper's `b2c_weights_design`: "pipelined" in
    float32, "wgmma" in bfloat16 where H is a multiple of 8, else
    "tiled"; `chip_smoke.py` also times "tiled" beside the others):
    returns (dRW [H, 4H], dP [3, H])."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("lstm")
    T, B, H = hs.shape
    dev = hs.device
    bf16 = _bf16_design(hs, design, "lstm_bwd_weights")
    drw = torch.empty((H, 4 * H), dtype=hs.dtype, device=dev)
    dp = torch.empty((3, H), dtype=hs.dtype, device=dev)
    args = (hs.data_ptr(), h0.data_ptr(), dxw.data_ptr(), dp_part.data_ptr(),
            drw.data_ptr(), dp.data_ptr())
    if design == "pipelined":
        splits = b2c_splits(T, B, H, card_limits(dev)[0])
        # the slices' partial tiles, and a counter a tile for the last
        # slice to arrive, which adds them in slice order
        part = torch.empty((splits, H, 4 * H), dtype=hs.dtype,
                           device=dev) if splits > 1 else None
        counters = torch.zeros(
            -(-H // WEIGHT_TILE) * -(-4 * H // WEIGHT_TILE),
            dtype=torch.int32, device=dev)
        rc = lib.dl4j_lstm_bwd_weights_pipelined(
            *args, None if part is None else part.data_ptr(),
            counters.data_ptr(), T, B, H, dp_part.shape[0], splits,
            _stream(dev))
    elif design == "wgmma":
        if H % 8:
            raise ValueError(f"the wgmma LSTM weight product takes H a "
                             f"multiple of 8 (16-byte TMA rows); got {H}")
        # the slices of a tile of dRW are one cluster, which adds their
        # float32 sums in slice order in shared memory
        splits = b2c_wgmma_splits(T, B, H, card_limits(dev)[0],
                                  wgmma_clusters(dev))
        rc = lib.dl4j_lstm_bwd_weights_wgmma(
            *args, T, B, H, dp_part.shape[0], splits, _stream(dev))
    elif design == "tiled":
        rc = lib.dl4j_lstm_bwd_weights(*args, T, B, H, dp_part.shape[0],
                                       DTYPES[hs.dtype], _stream(dev))
    else:
        raise ValueError(f"no LSTM weight-gradient design {design!r}")
    cuda_build.check(lib, rc, f"lstm_bwd_weights ({design}, {hs.dtype})")
    _count("lstm_bwd_weights", design, bf16)
    return drw, dp


class FusedLSTM(torch.autograd.Function):
    """(hs, hT, cT) = lstm(xw, rw, p, h0, c0, mask) with kernel B2a as
    forward, its residuals saved, and B2c as backward. `fused_lstm` goes
    through it only when a gradient is wanted."""

    @staticmethod
    def forward(ctx, xw, rw, p, h0, c0, mask):
        hs, cs, gates, hT, cT = lstm_fwd(xw, rw, p, h0, c0, mask,
                                         with_residuals=True)
        ctx.save_for_backward(rw, p, mask, hs, cs, gates, h0, c0)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        rw, p, mask, hs, cs, gates, h0, c0 = ctx.saved_tensors
        # an output nothing downstream used has no cotangent
        dhs = torch.zeros_like(hs) if dhs is None else dhs.contiguous()
        dhT = torch.zeros_like(h0) if dhT is None else dhT.contiguous()
        dcT = torch.zeros_like(c0) if dcT is None else dcT.contiguous()
        dxw, dh0, dc0, drw, dp = lstm_bwd(rw, p, mask, hs, cs, gates, h0,
                                          c0, dhs, dhT, dcT)
        return dxw, drw, dp, dh0, dc0, None


def fused_lstm(xw, rw, p, h0, c0, mask):
    """Fused LSTM over a whole sequence.

    xw:   [T, B, 4H] precomputed x@W + b (gate order i, f, g, o)
    rw:   [H, 4H] recurrent weights; p: [3, H] peepholes (zeros = none)
    h0/c0:[B, H] initial carry; mask: [T, B] 1 = valid (carry held at 0)
    Returns (hs [T, B, H], h_T, c_T), differentiable in xw, rw, p, h0 and
    c0. Inputs are made contiguous (xw arrives as a transposed view).
    With grad disabled, or when no input wants a gradient, the inference
    kernel B2b runs and nothing is saved (`output()`, `rnn_time_step`)."""
    args = tuple(t.contiguous() for t in (xw, rw, p, h0, c0, mask))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:5]):
        return FusedLSTM.apply(*args)
    hs, _, _, hT, cT = lstm_fwd(*args, with_residuals=False)
    return hs, hT, cT
