"""One-pass fused Adam — the port of `deeplearning4j_tpu/ops/fused_update.py`
(kernel B1a, `_adam_kernel`).

`adam_update` runs the whole read-modify-write of a group of leaves in
ONE launch of a hand-written CUDA kernel (`csrc/fused_update.cu`): p, m
and v are updated in place, as the TPU kernel's `input_output_aliases`
make its update in place, each in its stored dtype with float32 math.
The TPU launches once a leaf; here a device table of the leaves'
addresses and sizes drives one launch for all of them. The table is
built once for a set of addresses and kept (keyed by the addresses and
sizes), so a steady training loop, whose gradients the caching allocator
hands back at the same addresses, copies nothing to the card.

`lrbc` = lr · sqrt(1 - β2^t) / (1 - β1^t) is a float32 tensor on the
device, read by the kernel, so no step count goes to the host.

`adam_update_plain` is the plain version: the three lines of
`_adam_kernel`. The wrapper takes it only for tensors on the CPU; on
CUDA tensors it launches the kernel or raises. `LAUNCHES` and
`PLAIN_ON_CUDA` count as in `ops/attention.py`.

Nesterovs (B1b, `_nesterov_kernel`) is not ported yet: its updater runs
plain tensor math (see `optim/updaters.py`).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Sequence

import torch

LAUNCHES: Dict[str, int] = {"adam_update": 0}
PLAIN_ON_CUDA: Dict[str, int] = {"adam_update": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# elements a chunk: 2 float4 vectors a thread of a 256-thread block, so
# the 20 M-parameter zoo transformer makes ~2,500 chunks for 132 SMs
CHUNK = 1 << 11
_TABLES: "collections.OrderedDict" = collections.OrderedDict()
_TABLES_KEPT = 8


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def adam_update_plain(p, g, m, v, lrbc, *, beta1: float = 0.9,
                      beta2: float = 0.999, eps: float = 1e-8):
    """Plain version of kernel B1a for one leaf: returns (p', m', v') in
    the argument dtypes, with the math in float32 (float64 for float64)."""
    if p.is_cuda:
        PLAIN_ON_CUDA["adam_update"] += 1
    acc = _acc_dtype(p.dtype)
    g32, m32, v32, p32 = g.to(acc), m.to(acc), v.to(acc), p.to(acc)
    lr = torch.as_tensor(lrbc, dtype=acc, device=p.device)
    m_new = beta1 * m32 + (1.0 - beta1) * g32
    v_new = beta2 * v32 + (1.0 - beta2) * g32 * g32
    p_new = p32 - lr * m_new / (torch.sqrt(v_new) + eps)
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def _table(params, grads, ms, vs, dev):
    """The device leaf table (int64 [L, 6]: p, g, m, v, n, first chunk)
    and the chunk count; built and copied once per set of addresses."""
    key = (dev.index, tuple((p.data_ptr(), g.data_ptr(), m.data_ptr(),
                             v.data_ptr(), p.numel())
                            for p, g, m, v in zip(params, grads, ms, vs)))
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit
    rows, chunk0 = [], 0
    for p, g, m, v in zip(params, grads, ms, vs):
        n = p.numel()
        rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     n, chunk0])
        chunk0 += -(-n // CHUNK)
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    entry = (host.to(dev, non_blocking=True), chunk0)
    _TABLES[key] = entry
    while len(_TABLES) > _TABLES_KEPT:
        _TABLES.popitem(last=False)
    return entry


def _check_cuda(params, grads, ms, vs, lrbc) -> None:
    dev = params[0].device
    dtype = params[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused Adam kernel takes float32 or bfloat16 "
                        f"leaves, got {dtype}")
    for i, leaf in enumerate(zip(params, grads, ms, vs)):
        for name, t in zip("pgmv", leaf):
            if t.device != dev:
                raise ValueError(f"leaf {i} {name} on {t.device}, not {dev}")
            if t.dtype != dtype:
                raise TypeError(f"leaf {i} {name} is {t.dtype}; one launch "
                                f"takes one dtype ({dtype})")
            if not t.is_contiguous():
                raise ValueError(f"leaf {i} {name} must be contiguous")
            if t.numel() != leaf[0].numel():
                raise ValueError(f"leaf {i}: {name} has {t.numel()} "
                                 f"elements, p has {leaf[0].numel()}")
    if lrbc.device != dev or lrbc.dtype != torch.float32 or lrbc.numel() != 1:
        raise ValueError("lrbc must be a float32 scalar tensor on the "
                         "leaves' device")


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], lrbc: torch.Tensor, *,
                beta1: float = 0.9, beta2: float = 0.999,
                eps: float = 1e-8) -> None:
    """Kernel B1a over a group of leaves, in place: one launch on CUDA
    tensors, the plain version leaf by leaf on CPU tensors."""
    params, grads, ms, vs = (list(x) for x in (params, grads, ms, vs))
    if not (len(params) == len(grads) == len(ms) == len(vs)):
        raise ValueError("params, grads, m and v differ in length")
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        for p, g, m, v in zip(params, grads, ms, vs):
            pn, mn, vn = adam_update_plain(p, g, m, v, lrbc, beta1=beta1,
                                           beta2=beta2, eps=eps)
            p.copy_(pn)
            m.copy_(mn)
            v.copy_(vn)
        return
    if dev.type != "cuda":
        raise ValueError(f"no fused Adam kernel for device {dev}")
    _check_cuda(params, grads, ms, vs, lrbc)
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("fused_update")
    table, n_chunks = _table(params, grads, ms, vs, dev)
    rc = lib.dl4j_adam_multi(
        table.data_ptr(), len(params), n_chunks, CHUNK, lrbc.data_ptr(),
        beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
        _DTYPE_CODES[params[0].dtype],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(lib, rc, "adam_update")
    LAUNCHES["adam_update"] += 1

