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
from typing import Dict, Optional

import torch

MAX_HIDDEN = 1024         # 8 blocks a cluster x 128 hidden columns a block

LAUNCHES: Dict[str, int] = {"lstm_fwd": 0, "lstm_fwd_inference": 0,
                            "lstm_bwd": 0, "lstm_bwd_weights": 0}
PLAIN_ON_CUDA: Dict[str, int] = {"lstm_fwd": 0, "lstm_fwd_inference": 0,
                                 "lstm_bwd": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_ON_CUDA):
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


def lstm_fwd(xw, rw, p, h0, c0, mask, with_residuals: bool = True):
    """Kernel B2a (`with_residuals`) or B2b: returns (hs, cs, gates, hT,
    cT), cs and gates None without residuals."""
    _check_shapes(xw, rw, p, h0, c0, mask)
    if not _on_card(xw):
        return lstm_fwd_plain(xw, rw, p, h0, c0, mask, with_residuals)
    _check_cuda(dict(xw=xw, rw=rw, p=p, h0=h0, c0=c0, mask=mask))
    T, B, H4 = xw.shape
    H = H4 // 4
    _check_hidden(H)
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("lstm")
    new = lambda *s: torch.empty(s, dtype=xw.dtype, device=xw.device)  # noqa
    hs, hT, cT = new(T, B, H), new(B, H), new(B, H)
    cs = new(T, B, H) if with_residuals else None
    gates = new(T, B, H4) if with_residuals else None
    rc = lib.dl4j_lstm_fwd(
        xw.data_ptr(), rw.data_ptr(), p.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), mask.data_ptr(), hs.data_ptr(),
        None if cs is None else cs.data_ptr(),
        None if gates is None else gates.data_ptr(), hT.data_ptr(),
        cT.data_ptr(), T, B, H, int(with_residuals), _stream(xw.device))
    name = "lstm_fwd" if with_residuals else "lstm_fwd_inference"
    cuda_build.check(lib, rc, name)
    LAUNCHES[name] += 1
    return hs, cs, gates, hT, cT


def lstm_bwd(rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT, dcT):
    """Kernel B2c from the forward's residuals: returns (dxw, dh0, dc0,
    dRW, dP)."""
    if not _on_card(hs):
        return lstm_bwd_plain(rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT,
                              dcT)
    T, B, H = hs.shape
    _check_hidden(H)
    # RW transposed once a call (a copy, not a product), so the kernel's
    # reads of RW^T coalesce as the forward's reads of RW do
    rwT = rw.t().contiguous()
    _check_cuda(dict(hs=hs, rwT=rwT, p=p, mask=mask, cs=cs, gates=gates,
                     h0=h0, c0=c0, dhs=dhs, dhT=dhT, dcT=dcT))
    dxw, dh0, dc0, dp_part = launch_bwd_recurrence(
        rwT, p, mask, cs, gates, c0, dhs, dhT, dcT)
    drw, dp = launch_bwd_weights(hs, h0, dxw, dp_part)
    return dxw, dh0, dc0, drw, dp


def launch_bwd_recurrence(rwT, p, mask, cs, gates, c0, dhs, dhT, dcT):
    """The reverse-time kernel of B2c alone, on checked CUDA tensors:
    returns (dxw, dh0, dc0, dp_part [tiles, 3, H])."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("lstm")
    T, B, H = cs.shape
    tiles = -(-B // lib.dl4j_lstm_batch_tile())
    new = lambda *s: torch.empty(s, dtype=cs.dtype, device=cs.device)  # noqa
    dxw, dh0, dc0 = new(T, B, 4 * H), new(B, H), new(B, H)
    dp_part = new(tiles, 3, H)
    rc = lib.dl4j_lstm_bwd(
        dhs.data_ptr(), gates.data_ptr(), cs.data_ptr(), rwT.data_ptr(),
        p.data_ptr(), mask.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
        c0.data_ptr(), dxw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        dp_part.data_ptr(), T, B, H, _stream(cs.device))
    cuda_build.check(lib, rc, "lstm_bwd")
    LAUNCHES["lstm_bwd"] += 1
    return dxw, dh0, dc0, dp_part


def launch_bwd_weights(hs, h0, dxw, dp_part):
    """The weight-gradient launch of B2c alone, on checked CUDA tensors:
    returns (dRW [H, 4H], dP [3, H])."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("lstm")
    T, B, H = hs.shape
    drw = torch.empty((H, 4 * H), dtype=hs.dtype, device=hs.device)
    dp = torch.empty((3, H), dtype=hs.dtype, device=hs.device)
    rc = lib.dl4j_lstm_bwd_weights(
        hs.data_ptr(), h0.data_ptr(), dxw.data_ptr(), dp_part.data_ptr(),
        drw.data_ptr(), dp.data_ptr(), T, B, H, dp_part.shape[0],
        _stream(hs.device))
    cuda_build.check(lib, rc, "lstm_bwd_weights")
    LAUNCHES["lstm_bwd_weights"] += 1
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
