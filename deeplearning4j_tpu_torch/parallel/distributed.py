"""Multi-process initialization and the port's ONE set of collective
wrappers (port of `deeplearning4j_tpu/parallel/distributed.py`).

A rank is a process on one device; `initialize_distributed` joins them
into the default `torch.distributed` process group (NCCL on `cuda`,
gloo on the CPU, or the `backend` given: two ranks on one card must use
gloo, NCCL refuses them). Every collective of the port goes through the
wrappers here — `all_reduce`, `all_gather`, `broadcast` (the three
both gloo and NCCL take) — and each call records its kind, payload bytes
and group size in commsmon's ledger (`observe/commsmon.py`). A call on
a one-rank group runs nothing and is recorded as degenerate (out of the
totals), as XLA drops a single-participant collective.

Under gloo a CUDA tensor is staged explicitly: copied to the host, the
collective runs there, the result is copied back (the ledger marks the
call `staged`). A collective that fails raises; nothing falls back.

`BatchStatsGroup(group)` is what a data-parallel train step hands
batch normalization (`nn/layers/normalization.py`, `ops/conv_fused.py`,
through their `stats_group=` argument) so that its statistics span the
data group: `size` ranks, `sum(t)` a differentiable all-reduce. Each
rank then normalizes by the GLOBAL batch's mean and variance, as the
JAX package's sharded step computes them, so n ranks compute what one
process computes on the global batch. A step without it (an
evaluation, a plain fit) normalizes by its own rows.
"""

from __future__ import annotations

import datetime
import os
import zlib
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.observe.commsmon import record_collective

__all__ = [
    "initialize_distributed", "process_count", "process_index",
    "host_local_shard", "sync_global_devices", "put_global",
    "put_global_batch", "all_reduce", "all_gather", "broadcast",
    "group_size", "BatchStatsGroup",
]

DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group. No-ops on a single process, and
    when a group is already initialized.

    Each argument left None is read from the JAX package's variables
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID), then
    from torchrun's (MASTER_ADDR with MASTER_PORT, WORLD_SIZE, RANK): an
    explicit argument wins, then JAX's, then torchrun's. `backend`
    defaults to NCCL where a card is visible, else gloo; `timeout_s`
    bounds every join and collective, so a lost peer fails in seconds
    rather than hanging."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and num_processes in (None, 1):
        return  # single process
    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError(
            "initialize_distributed needs the coordinator address, the "
            "process count and this process's index (arguments, JAX_* or "
            "torchrun's variables)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_local_shard(n_examples: int, balanced: bool = False) -> slice:
    """Deterministic per-process data shard [start, stop), as JAX's.
    `balanced=False` drops the `n_examples % process_count` tail so every
    process gets the same count; `balanced=True` hands the remainder to
    the first processes."""
    nproc = process_count()
    per, rem = divmod(n_examples, nproc)
    pi = process_index()
    if not balanced:
        start = pi * per
        return slice(start, start + per)
    start = pi * per + min(pi, rem)
    return slice(start, start + per + (1 if pi < rem else 0))


# ---------------------------------------------------------- collectives
def group_size(group=None) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _backend(group=None) -> str:
    return str(dist.get_backend(group)).lower()


def _staged(t: torch.Tensor, group) -> bool:
    """gloo takes host tensors: a CUDA tensor is copied out and back."""
    return t.is_cuda and _backend(group) == "gloo"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "avg": "SUM"}


def all_reduce(t: torch.Tensor, *, op: str = "sum", group=None,
               purpose: str = "") -> torch.Tensor:
    """In place over the group; "avg" divides the sum by the group
    size. Returns `t`."""
    g = group_size(group)
    staged = g > 1 and _staged(t, group)
    record_collective("all-reduce", _nbytes(t), g, purpose=purpose,
                      staged=staged)
    if g <= 1:
        return t
    rop = getattr(dist.ReduceOp, _OPS[op])
    if staged:
        h = t.cpu()
        dist.all_reduce(h, op=rop, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=rop, group=group)
    if op == "avg":
        t.div_(g)
    return t


def all_gather(t: torch.Tensor, *, group=None,
               purpose: str = "") -> List[torch.Tensor]:
    """Every rank's `t`, in rank order (one tensor a rank)."""
    g = group_size(group)
    staged = g > 1 and _staged(t, group)
    record_collective("all-gather", _nbytes(t) * g, g, purpose=purpose,
                      staged=staged)
    if g <= 1:
        return [t]
    src = t.cpu() if staged else t.contiguous()
    out = [torch.empty_like(src) for _ in range(g)]
    dist.all_gather(out, src, group=group)
    if staged:
        out = [o.to(t.device) for o in out]
    return out


def broadcast(t: torch.Tensor, *, src: int = 0, group=None,
              purpose: str = "") -> torch.Tensor:
    """In place from global rank `src`. Returns `t`."""
    g = group_size(group)
    staged = g > 1 and _staged(t, group)
    record_collective("broadcast", _nbytes(t), g, purpose=purpose,
                      staged=staged)
    if g <= 1:
        return t
    if staged:
        h = t.cpu()
        dist.broadcast(h, src=src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def sync_global_devices(tag: str = "barrier") -> None:
    """Cross-process barrier."""
    if process_count() > 1:
        dist.barrier()


def _check_replicated_consistency(x: np.ndarray) -> None:
    """Debug guard (DL4J_TPU_CHECK_REPLICATED=1): gather a checksum of
    the supposedly replicated value and fail fast if processes diverge.
    Off by default: it costs one collective a call."""
    if os.environ.get("DL4J_TPU_CHECK_REPLICATED") != "1":
        return
    digest = torch.tensor([zlib.adler32(np.ascontiguousarray(x).tobytes())],
                          dtype=torch.int64)
    all_digests = [int(d) for d in all_gather(digest, purpose="check")]
    if any(d != all_digests[0] for d in all_digests):
        raise AssertionError(
            "put_global: replicated value differs across processes "
            f"(per-process adler32 = {all_digests}); every process must "
            "hold an identical copy")


def put_global(x, sharding, device=None) -> torch.Tensor:
    """This rank's placement of `x`, a value every process holds in full
    (replicated params, scalars): its slice under `sharding` on
    `device`."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if process_count() > 1:
        _check_replicated_consistency(t.detach().cpu().numpy())
    out = sharding.local_slice(t) if sharding is not None else t
    return out.to(device) if device is not None else out


def put_global_batch(local, sharding=None, device=None):
    """This process's rows of a global batch (its `host_local_shard`
    slice): the global batch is the concatenation over ranks in rank
    order, and no rank materializes it."""
    t = local if isinstance(local, torch.Tensor) else \
        torch.as_tensor(np.asarray(local))
    return t.to(device) if device is not None else t


# ------------------------------------------------- global batch statistics
class _BatchSum(torch.autograd.Function):
    """Sum over the group's ranks; its gradient is the sum of every
    rank's gradient (each rank's loss depends on the shared sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group=group, purpose="bn_stats")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), group=ctx.group,
                          purpose="bn_stats"), None


class BatchStatsGroup:
    """The ranks a data-parallel step's batch statistics span: `size`
    of them, summed by `sum` (one all-reduce, in commsmon's ledger as
    "bn_stats"; differentiable)."""

    __slots__ = ("group", "size")

    def __init__(self, group):
        self.group = group
        self.size = group_size(group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return _BatchSum.apply(t, self.group)
