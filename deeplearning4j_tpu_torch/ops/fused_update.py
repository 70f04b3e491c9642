"""One-pass fused Adam and Nesterovs — the port of
`deeplearning4j_tpu/ops/fused_update.py` (kernels B1a, `_adam_kernel`,
and B1b, `_nesterov_kernel`).

`adam_update` and `nesterov_update` run the whole read-modify-write of a
group of leaves in ONE launch of a hand-written CUDA kernel
(`csrc/fused_update.cu`): p and the moments are updated in place, as the
TPU kernels' `input_output_aliases` make their update in place, each in
its stored dtype with float32 math.
The TPU launches once a leaf; here a device table of the leaves'
addresses and sizes drives one launch for all of them. The table is
built once for a set of addresses and kept (keyed by the addresses and
sizes), so a steady training loop, whose gradients the caching allocator
hands back at the same addresses, copies nothing to the card.

Adam's `lrbc` = lr · sqrt(1 - β2^t) / (1 - β1^t) and Nesterovs' `lr`
(its schedule's value) are float32 tensors on the device, read by the
kernel, so no step count goes to the host.

`adam_update_plain` and `nesterov_update_plain` are the plain versions:
the lines of `_adam_kernel` and `_nesterov_kernel`. A wrapper takes its
plain version only for tensors on the CPU; on CUDA tensors it launches
the kernel or raises. `LAUNCHES` and `PLAIN_ON_CUDA` count as in
`ops/attention.py`.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Sequence

import torch

LAUNCHES: Dict[str, int] = {"adam_update": 0, "nesterov_update": 0}
PLAIN_ON_CUDA: Dict[str, int] = {"adam_update": 0, "nesterov_update": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# elements a chunk: 2 float4 vectors a thread of a 256-thread block, so
# the 20 M-parameter zoo transformer makes ~2,500 chunks for 132 SMs
CHUNK = 1 << 11
_TABLES: "collections.OrderedDict" = collections.OrderedDict()
_TABLES_KEPT = 8
# tables made while a CUDA graph is captured, with their pinned host rows:
# the graph copies the rows in and reads the table at every replay, so
# both live as long as the process
_GRAPH_TABLES: list = []


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


def nesterov_update_plain(p, g, v, lr, *, momentum: float = 0.9):
    """Plain version of kernel B1b for one leaf: returns (p', v') in the
    argument dtypes, with the math in float32 (float64 for float64)."""
    if p.is_cuda:
        PLAIN_ON_CUDA["nesterov_update"] += 1
    acc = _acc_dtype(p.dtype)
    g32, v32, p32 = g.to(acc), v.to(acc), p.to(acc)
    lr = torch.as_tensor(lr, dtype=acc, device=p.device)
    v_new = momentum * v32 - lr * g32
    p_new = p32 + momentum * v_new - lr * g32
    return p_new.to(p.dtype), v_new.to(v.dtype)


def _table(params, grads, ms, vs, dev):
    """The device leaf table (int64 [L, 6]: p, g, m, v, n, first chunk)
    and the chunk count; built and copied once per set of addresses
    (once per capture inside a CUDA graph).
    `ms` None (Nesterovs has no first moment) leaves the m column 0."""
    if ms is None:
        ms = [None] * len(params)
    rows, chunk0 = [], 0
    for p, g, m, v in zip(params, grads, ms, vs):
        n = p.numel()
        rows.append([p.data_ptr(), g.data_ptr(),
                     0 if m is None else m.data_ptr(), v.data_ptr(),
                     n, chunk0])
        chunk0 += -(-n // CHUNK)
    if torch.cuda.is_current_stream_capturing():
        # a table of the graph's own, copied in by the graph itself: a
        # kept eager table may be evicted, and another graph's table is
        # written only when that graph replays
        host = torch.tensor(rows, dtype=torch.int64).pin_memory()
        _GRAPH_TABLES.append((host, host.to(dev, non_blocking=True)))
        return _GRAPH_TABLES[-1][1], chunk0
    key = (dev.index, tuple(tuple(r[:5]) for r in rows))
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    entry = (host.to(dev, non_blocking=True), chunk0)
    _TABLES[key] = entry
    while len(_TABLES) > _TABLES_KEPT:
        _TABLES.popitem(last=False)
    return entry


def _check_cuda(names: str, columns, scalar) -> None:
    """`columns`: one list of tensors per letter of `names` ("pgmv" or
    "pgv"); `scalar`: the step's lrbc or lr."""
    dev = columns[0][0].device
    dtype = columns[0][0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused update kernels take float32 or "
                        f"bfloat16 leaves, got {dtype}")
    for i, leaf in enumerate(zip(*columns)):
        for name, t in zip(names, leaf):
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
    if not isinstance(scalar, torch.Tensor) or scalar.device != dev or \
            scalar.dtype != torch.float32 or scalar.numel() != 1:
        raise ValueError("the step's scalar (lrbc or lr) must be a float32 "
                         "scalar tensor on the leaves' device")


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
    _check_cuda("pgmv", (params, grads, ms, vs), lrbc)
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



def nesterov_update(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    vs: Sequence[torch.Tensor], lr: torch.Tensor, *,
                    momentum: float = 0.9) -> None:
    """Kernel B1b over a group of leaves, in place: one launch on CUDA
    tensors, the plain version leaf by leaf on CPU tensors."""
    params, grads, vs = (list(x) for x in (params, grads, vs))
    if not (len(params) == len(grads) == len(vs)):
        raise ValueError("params, grads and v differ in length")
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        for p, g, v in zip(params, grads, vs):
            pn, vn = nesterov_update_plain(p, g, v, lr, momentum=momentum)
            p.copy_(pn)
            v.copy_(vn)
        return
    if dev.type != "cuda":
        raise ValueError(f"no fused Nesterovs kernel for device {dev}")
    _check_cuda("pgv", (params, grads, vs), lr)
    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("fused_update")
    table, n_chunks = _table(params, grads, None, vs, dev)
    rc = lib.dl4j_nesterov_multi(
        table.data_ptr(), len(params), n_chunks, CHUNK, lr.data_ptr(),
        momentum, _DTYPE_CODES[params[0].dtype],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(lib, rc, "nesterov_update")
    LAUNCHES["nesterov_update"] += 1
