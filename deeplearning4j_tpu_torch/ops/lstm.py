"""Fused LSTM over a whole sequence — the port of
`deeplearning4j_tpu/ops/lstm.py`.

The input projection x@W+b for ALL timesteps happens outside, as one
`torch.matmul` (as JAX leaves it to XLA); the kernels fuse the sequential
recurrence. Three kernels, hand-written in CUDA C++ for Hopper
(`csrc/lstm.cu`), float32:

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
from typing import Dict, Optional, Tuple

import torch

MAX_HIDDEN = 1024         # 8 blocks a cluster x 128 hidden columns a block
DESIGNS = ("cluster", "persistent")
PERSISTENT_ROWS = (8, 16, 32, 64)     # batch rows a design-2 block takes
PERSISTENT_MIN_STEPS = 8              # shorter sequences stay on design 1

LAUNCHES: Dict[str, int] = {"lstm_fwd": 0, "lstm_fwd_inference": 0,
                            "lstm_bwd": 0, "lstm_bwd_weights": 0}
PLAIN_ON_CUDA: Dict[str, int] = {"lstm_fwd": 0, "lstm_fwd_inference": 0,
                                 "lstm_bwd": 0}
B2C_DESIGNS = {"lstm_bwd": ("cluster", "persistent"),
               "lstm_bwd_weights": ("tiled", "pipelined")}
WEIGHT_TILE = 128                     # the pipelined SGEMM's tile of dRW

LAUNCHES_BY_DESIGN: Dict[Tuple[str, str], int] = {
    **{(k, d): 0 for k in ("lstm_fwd", "lstm_fwd_inference")
       for d in DESIGNS},
    **{(k, d): 0 for k, ds in B2C_DESIGNS.items() for d in ds}}


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
        i = torch.sigmoid(z[:, :H] + c * p[0:1])
        f = torch.sigmoid(z[:, H:2 * H] + c * p[1:2])
        g = torch.tanh(z[:, 2 * H:3 * H])
        c_new = f * c + i * g
        o = torch.sigmoid(z[:, 3 * H:] + c_new * p[2:3])
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
    drw = torch.zeros_like(rw)
    dp = torch.zeros_like(p)
    dxw = [None] * T
    for t in range(T - 1, -1, -1):
        gt = gates[t]
        i, f, g, o = (gt[:, :H], gt[:, H:2 * H], gt[:, 2 * H:3 * H],
                      gt[:, 3 * H:])
        c_t = cs[t]
        # the predecessors of step 0 are the initial carries
        c_prev = c0 if t == 0 else cs[t - 1]
        h_prev = h0 if t == 0 else hs[t - 1]
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
        drw = drw + h_prev.T @ dgates
        dp = dp + torch.stack([(di_pre * c_prev).sum(0),
                               (df_pre * c_prev).sum(0),
                               (do_pre * c_t).sum(0)])
    return torch.stack(dxw), dh, dc, drw, dp


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
    for name, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name} on {t.device}, not {first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA LSTM kernels take float32; {name} "
                            f"is {t.dtype}")
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


def b2_rows(B: int, H: int, sms: int, smem: int) -> Optional[int]:
    """The batch rows a design-2 block takes (BR; it computes BR x 1024
    / BR pre-activations, so 256 / BR hidden columns), or None where no BR
    fits: the smallest BR of `PERSISTENT_ROWS` (the least of h a block
    copies a step) whose grid, ceil(B / BR) x ceil(H / (256 / BR))
    blocks, fits one block on each of `sms` SMs, and whose shared memory
    (the resident strip of RW, [H, 1024 / BR] float32, beside the h tile
    [H, BR] or the 8 warps' partial sums, whichever is larger) fits the
    `smem` bytes a block may ask for. `csrc/lstm.cu` `persist::launch`
    computes the same grid and shared memory."""
    for br in PERSISTENT_ROWS:
        nc = 1024 // br
        blocks = -(-B // br) * -(-H // (nc // 4))
        floats = H * nc + max(H * br, 8 * br * (nc + 4))
        if blocks <= sms and 4 * floats <= smem:
            return br
    return None


def card_limits(device) -> Tuple[int, int]:
    """(SMs, shared-memory bytes a block may ask for) of a CUDA card:
    the SM's shared memory less the 1 KB the runtime keeps a block."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, \
        props.shared_memory_per_multiprocessor - 1024


def b2_design(T: int, B: int, H: int, sms: int, smem: int) -> str:
    """The design that takes a forward call (B2a with residuals, B2b
    without: the same rule) on a card of `sms` SMs and `smem` bytes of
    shared memory a block: "persistent" (design 2) for sequences of at
    least PERSISTENT_MIN_STEPS steps where `b2_rows` finds a tile that
    fits, else "cluster" (design 1, which takes every hidden size up to
    MAX_HIDDEN). Design 2 pays a fixed cost a call (a cooperative launch
    whose blocks stage their strips of RW) for cheaper steps, so a short
    sequence (`rnn_time_step`'s T 1) stays on design 1 (`chip_smoke.py`
    times both designs at T 1, 4, 8, 50 and 200). A pure function of the
    shape and the card, decided before the launch."""
    if T < PERSISTENT_MIN_STEPS or b2_rows(B, H, sms, smem) is None:
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


def b2c_rows(B: int, H: int, sms: int, smem: int) -> Optional[int]:
    """The batch rows a block of B2c's design-2 recurrence takes (BR; its
    256 threads hold BR x 256 / BR cells, so 256 / BR hidden columns and
    their NC = 1024 / BR gate columns), or None where none fits: the
    smallest BR of `PERSISTENT_ROWS` (the least partial dh a block
    writes and reads a step) whose grid, ceil(B / BR) x ceil(H / (256 /
    BR)) blocks, fits one block on each of `sms` SMs, and whose shared
    memory fits the `smem` bytes a block may ask for: the resident strip
    of RW transposed, [NC, Hp + 4] float32 (Hp = H rounded up to 4), the
    step's gate gradients [NC, BR], and where the product's thread tiles
    are fewer than the threads (`_b2c_ksplit`), the groups' sums [Q, BR,
    Hp]. `csrc/lstm.cu` `persist::launch_bwd` computes the same."""
    hp = -(-H // 4) * 4
    for br in PERSISTENT_ROWS:
        nc = 1024 // br
        blocks = -(-B // br) * -(-H // (nc // 4))
        q = _b2c_ksplit(br // 8 * hp // 4)
        floats = nc * (hp + 4) + nc * br + (q * br * hp if q > 1 else 0)
        if blocks <= sms and 4 * floats <= smem:
            return br
    return None


def b2c_design(T: int, B: int, H: int, sms: int, smem: int) -> str:
    """The design of B2c's recurrence on a card of `sms` SMs and `smem`
    bytes of shared memory a block, by `b2_design`'s rule: "persistent"
    (design 2) for sequences of at least PERSISTENT_MIN_STEPS steps where
    `b2c_rows` finds a tile whose grid can be resident at once, else
    "cluster" (design 1, which takes every hidden size up to MAX_HIDDEN;
    `chip_smoke.py` times both at its LSTM shapes from T 4 to 200). The
    weight product takes "pipelined" at every shape. A pure function of
    the shape and the card, decided before the launch."""
    if T < PERSISTENT_MIN_STEPS or b2c_rows(B, H, sms, smem) is None:
        return "cluster"
    return "persistent"


def b2c_splits(T: int, B: int, H: int, sms: int) -> int:
    """The slices of K = T·B that the pipelined weight product splits
    over: as many as two resident blocks on each of `sms` SMs allow for
    its ceil(H / 128) x ceil(4H / 128) tiles, with at least 256 rows of K
    a slice, and at most 16 (`path_l`: 4 on 132 SMs)."""
    tiles = -(-H // WEIGHT_TILE) * -(-4 * H // WEIGHT_TILE)
    return max(1, min(2 * sms // tiles, T * B // 256, 16))


def lstm_fwd(xw, rw, p, h0, c0, mask, with_residuals: bool = True):
    """Kernel B2a (`with_residuals`) or B2b: returns (hs, cs, gates, hT,
    cT), cs and gates None without residuals."""
    _check_shapes(xw, rw, p, h0, c0, mask)
    if not _on_card(xw):
        return lstm_fwd_plain(xw, rw, p, h0, c0, mask, with_residuals)
    _check_cuda(dict(xw=xw, rw=rw, p=p, h0=h0, c0=c0, mask=mask))
    T, B, H4 = xw.shape
    _check_hidden(H4 // 4)
    design = b2_design(T, B, H4 // 4, *card_limits(xw.device))
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
        rows = b2_rows(B, H, *card_limits(xw.device))
        if rows is None:
            raise ValueError(f"no design-2 LSTM tile fits B {B}, H {H} on "
                             f"this card")
        bp = -(-B // rows) * rows
        # h between the steps, double-buffered, and the barriers' counters
        hbuf = torch.empty((2, H, bp), dtype=xw.dtype, device=xw.device)
        counters = torch.zeros(bp // rows, dtype=torch.int32,
                               device=xw.device)
        rc = lib.dl4j_lstm_fwd_persistent(
            *args, hbuf.data_ptr(), counters.data_ptr(), T, B, H, rows,
            int(with_residuals), _stream(xw.device))
    else:
        rc = lib.dl4j_lstm_fwd(*args, T, B, H, int(with_residuals),
                               _stream(xw.device))
    name = "lstm_fwd" if with_residuals else "lstm_fwd_inference"
    cuda_build.check(lib, rc, f"{name} ({design})")
    LAUNCHES[name] += 1
    LAUNCHES_BY_DESIGN[(name, design)] += 1
    return hs, cs, gates, hT, cT


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
    design = b2c_design(T, B, H, *card_limits(hs.device))
    dxw, dh0, dc0, dp_part = launch_bwd_recurrence(
        rw, p, mask, cs, gates, c0, dhs, dhT, dcT, design)
    drw, dp = launch_bwd_weights(hs, h0, dxw, dp_part, "pipelined")
    return dxw, dh0, dc0, drw, dp


def launch_bwd_recurrence(rw, p, mask, cs, gates, c0, dhs, dhT, dcT,
                          design: str = "cluster"):
    """The reverse-time kernel of B2c alone, on checked CUDA tensors, in
    `design` (the wrapper passes `b2c_design`'s choice; `chip_smoke.py`
    also times the other design on the same inputs): returns (dxw, dh0,
    dc0, dp_part [batch tiles, 3, H], the tiles the design's)."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("lstm")
    T, B, H = cs.shape
    dev = cs.device
    new = lambda *s: torch.empty(s, dtype=cs.dtype, device=dev)  # noqa
    dxw, dh0, dc0 = new(T, B, 4 * H), new(B, H), new(B, H)
    if design == "persistent":
        rows = b2c_rows(B, H, *card_limits(dev))
        if rows is None:
            raise ValueError(f"no design-2 LSTM backward tile fits B {B}, "
                             f"H {H} on this card")
        tiles = -(-B // rows)
        dp_part = new(tiles, 3, H)
        # each block's partial dh between the steps, double-buffered, and
        # the barriers' counters
        part = new(2, -(-H // (256 // rows)), tiles * rows, -(-H // 4) * 4)
        counters = torch.zeros(tiles, dtype=torch.int32, device=dev)
        rc = lib.dl4j_lstm_bwd_persistent(
            dhs.data_ptr(), gates.data_ptr(), cs.data_ptr(), rw.data_ptr(),
            p.data_ptr(), mask.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
            c0.data_ptr(), dxw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            dp_part.data_ptr(), part.data_ptr(), counters.data_ptr(), T, B,
            H, rows, _stream(dev))
    elif design == "cluster":
        # RW transposed once a call (a copy, not a product), so the
        # kernel's reads of RW^T coalesce as the forward's reads of RW do
        rwT = rw.t().contiguous()
        dp_part = new(-(-B // lib.dl4j_lstm_batch_tile()), 3, H)
        rc = lib.dl4j_lstm_bwd(
            dhs.data_ptr(), gates.data_ptr(), cs.data_ptr(), rwT.data_ptr(),
            p.data_ptr(), mask.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
            c0.data_ptr(), dxw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            dp_part.data_ptr(), T, B, H, _stream(dev))
    else:
        raise ValueError(f"no LSTM backward design {design!r}")
    cuda_build.check(lib, rc, f"lstm_bwd ({design})")
    LAUNCHES["lstm_bwd"] += 1
    LAUNCHES_BY_DESIGN[("lstm_bwd", design)] += 1
    return dxw, dh0, dc0, dp_part


def launch_bwd_weights(hs, h0, dxw, dp_part, design: str = "tiled"):
    """The weight-gradient launch of B2c alone, on checked CUDA tensors,
    in `design` ("pipelined" is the wrapper's): returns (dRW [H, 4H],
    dP [3, H])."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("lstm")
    T, B, H = hs.shape
    dev = hs.device
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
    elif design == "tiled":
        rc = lib.dl4j_lstm_bwd_weights(*args, T, B, H, dp_part.shape[0],
                                       _stream(dev))
    else:
        raise ValueError(f"no LSTM weight-gradient design {design!r}")
    cuda_build.check(lib, rc, f"lstm_bwd_weights ({design})")
    LAUNCHES["lstm_bwd_weights"] += 1
    LAUNCHES_BY_DESIGN[("lstm_bwd_weights", design)] += 1
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
