"""The device mesh and the ONE sharding spine (port of
`deeplearning4j_tpu/parallel/mesh.py`).

The JAX package runs one controller over N devices. PyTorch's idiom is
one process per device, so in the port a rank is a process: the mesh is
a `torch.distributed.device_mesh.DeviceMesh` over the default process
group, `device_count()` is the world size, and a placement is what ONE
rank holds — its rows of a batch, its slice of a sharded moment, the
whole of a replicated parameter. A tensor carries no sharding; the spine
says which slice of the global value a rank's tensor is.

Axis conventions (shared by every trainer and rule of this package):
  data  — batch (data parallel)
  model — tensor parallel (hidden/feature dims)
  pipe  — pipeline stages
  seq   — sequence/context parallel (ring attention)
  expert — MoE expert parallel

`MeshContext` bundles the mesh with one `ShardingRules` and derives
every placement training needs by the JAX package's rules (batch,
params, optimizer moments, replicated), so a checkpoint's shard bounds
on n ranks equal JAX's on an n-device mesh. `make_mesh()` with no
process group initialized starts a one-rank group first (a `HashStore`,
no network), so a one-card `ParallelWrapper` needs no launcher.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_PIPE = "pipe"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"

__all__ = [
    "AXIS_DATA", "AXIS_MODEL", "AXIS_PIPE", "AXIS_SEQ", "AXIS_EXPERT",
    "MeshSpec", "PartitionSpec", "P", "NamedSharding", "MeshContext",
    "make_mesh", "device_count", "local_device_count",
    "current_mesh_context", "set_mesh_context", "use_mesh_context",
]


class PartitionSpec(tuple):
    """One entry a dimension: the mesh axis that dimension is split
    over, or None (whole). `PartitionSpec()` replicates. The meaning of
    `jax.sharding.PartitionSpec`, as the port's own small class."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes; -1 for one axis means 'all remaining devices'."""

    axes: Dict[str, int]

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = dict(self.axes)
        wild = [k for k, v in sizes.items() if v == -1]
        fixed = int(np.prod([v for v in sizes.values() if v != -1])) or 1
        if len(wild) > 1:
            raise ValueError("At most one axis may be -1")
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild[0]] = n_devices // fixed
        total = int(np.prod(list(sizes.values())))
        if total != n_devices:
            raise ValueError(
                f"Mesh axes {sizes} use {total} devices but {n_devices} "
                f"are available")
        return sizes


def device_count() -> int:
    """The world size: one device a rank."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_count() -> int:
    """The ranks on this host (torchrun's LOCAL_WORLD_SIZE, else every
    rank: one host)."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    return int(local) if local else device_count()


def _default_device_type() -> str:
    """The mesh's device type: that of the default group's backend where
    one is initialized (NCCL: "cuda"; gloo, which also carries two ranks
    on one card: "cpu"), else "cuda" where a card is visible."""
    if dist.is_initialized():
        return "cuda" if "nccl" in str(dist.get_backend()).lower() \
            else "cpu"
    return "cuda" if torch.cuda.is_available() else "cpu"


def _ensure_process_group(device_type: str) -> None:
    """A one-rank group when none is initialized: the single-process
    mesh (JAX's `make_mesh()` on one device)."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    """A `DeviceMesh`. Default: 1-D data-parallel over every rank.
    `devices` are ranks (default: all of them, in order); the axes'
    product must equal their count, as JAX's. With no process group
    initialized, a one-rank group is started for `device_type` (NCCL for
    "cuda", gloo for "cpu"); with one, `device_type` follows its backend
    (`_default_device_type`)."""
    if dist.is_initialized() or device_type is None:
        device_type = _default_device_type()
    _ensure_process_group(device_type)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    if axes is None:
        axes = {AXIS_DATA: len(ranks)}
    sizes = MeshSpec(dict(axes)).resolve(len(ranks))
    names = tuple(sizes)
    shape = tuple(sizes[n] for n in names)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def mesh_axis_size(mesh, axis: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def mesh_axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return int(mesh.get_local_rank(axis))


def _split(dim: int, parts: int, index: int) -> Tuple[int, int]:
    if dim % parts:
        raise ValueError(f"dim {dim} does not split into {parts} shards")
    step = dim // parts
    return index * step, (index + 1) * step


class NamedSharding:
    """A spec over a mesh: which slice of a global value each rank holds
    (`jax.sharding.NamedSharding`'s meaning)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"

    def axis_sizes(self) -> List[Tuple[int, str, int]]:
        """(dim, axis, axis size) of every split dimension."""
        return [(d, a, mesh_axis_size(self.mesh, a))
                for d, a in enumerate(self.spec) if a is not None]

    def bounds(self, shape: Sequence[int],
               coords: Optional[Dict[str, int]] = None) -> List[List[int]]:
        """[[lo, hi], ...] of the slice held at mesh `coords` (axis ->
        index; default this rank's), the checkpoint manifest's form."""
        out = [[0, int(d)] for d in shape]
        for d, a, size in self.axis_sizes():
            idx = (coords[a] if coords is not None
                   else mesh_axis_index(self.mesh, a))
            out[d] = list(_split(int(shape[d]), size, idx))
        return out

    def local_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the global `x` (a view)."""
        for d, (lo, hi) in enumerate(self.bounds(x.shape)):
            if (lo, hi) != (0, x.shape[d]):
                x = x.narrow(d, lo, hi - lo)
        return x


class MeshContext:
    """The sharding spine: one mesh x one rule set x every placement,
    by the JAX package's rules:

      batch       — leading dim over `batch_axis` (data parallel): a
                    rank holds its rows of every global batch
      params      — per-leaf from the rules (replicated when no rules)
      optimizer   — moments follow their param's spec when it shards
                    anything (FSDP); otherwise they are split across the
                    REPLICA axis (`batch_axis`) on the first evenly
                    divisible dim (cross-replica weight-update sharding,
                    arXiv:2004.13336): a rank keeps 1/n of each moment.

    Rule precedence for a param leaf: first matching (layer_glob,
    param_glob) rule wins; no match → `rules.default` (replicated).
    `shard_opt_state=False` replicates the optimizer state."""

    def __init__(self, mesh=None, rules=None, *,
                 batch_axis: str = AXIS_DATA,
                 model_axis: str = AXIS_MODEL,
                 shard_opt_state: bool = True):
        self.mesh = mesh if mesh is not None else make_mesh()
        if batch_axis not in (self.mesh.mesh_dim_names or ()):
            raise ValueError(
                f"Mesh {self.mesh.mesh_dim_names} has no {batch_axis!r} axis")
        self.rules = rules
        self.batch_axis = batch_axis
        self.model_axis = model_axis
        self.shard_opt_state = bool(shard_opt_state)
        self.data_size = mesh_axis_size(self.mesh, batch_axis)
        self.data_rank = mesh_axis_index(self.mesh, batch_axis)
        self.replicated = NamedSharding(self.mesh, P())

    @property
    def data_group(self):
        """The process group of this rank's data-axis peers."""
        return self.mesh.get_group(self.batch_axis)

    # ------------------------------------------------------------ batch
    def batch_spec(self, ndim: int) -> PartitionSpec:
        return P(self.batch_axis, *([None] * (ndim - 1)))

    def batch_sharding(self, ndim: int) -> NamedSharding:
        return NamedSharding(self.mesh, self.batch_spec(ndim))

    def batch_sharding_like(self, x):
        """NamedSharding tree for a batch leaf/dict (None passes through)."""
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: self.batch_sharding_like(v) for k, v in x.items()}
        return self.batch_sharding(x.ndim)

    def put_batch(self, x):
        """This rank's rows of a global batch leaf (or dict of leaves).
        A leaf whose leading dim does not divide the data axis stays
        whole — callers that pad (`ParallelWrapper`) never hit that."""
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: self.put_batch(v) for k, v in x.items()}
        nd = getattr(x, "ndim", 0)
        if nd >= 1 and x.shape[0] % self.data_size == 0 and x.shape[0] > 0:
            lo, hi = _split(int(x.shape[0]), self.data_size, self.data_rank)
            return x[lo:hi]
        return x

    # ----------------------------------------------------------- params
    def _param_spec(self, layer_name: str, param_name: str,
                    leaf) -> PartitionSpec:
        if self.rules is None:
            return P()
        spec = self.rules.spec_for(layer_name, param_name)
        nd = getattr(leaf, "ndim", None)
        if nd is not None and len(spec) > nd:
            spec = P()
        return spec

    def param_shardings(self, tree):
        """NamedSharding tree matching a {layer: {param: leaf}} tree.
        Param-name rules apply at the LEAF key."""
        return self._tree_shardings(tree, self._param_spec)

    def state_shardings(self, tree):
        """Layer running state (batch-norm statistics) stays replicated."""
        def rep(sub):
            if isinstance(sub, dict):
                return {k: rep(v) for k, v in sub.items()}
            return self.replicated
        return rep(tree)

    # -------------------------------------------------- optimizer state
    def moment_spec(self, layer_name: str, param_name: str,
                    leaf) -> PartitionSpec:
        """Spec for one optimizer-moment leaf (shaped like its param)."""
        spec = self._param_spec(layer_name, param_name, leaf)
        if any(a is not None for a in spec):
            return spec                 # FSDP: moments follow the param
        if not self.shard_opt_state or self.data_size <= 1:
            return P()
        shape = getattr(leaf, "shape", ())
        for i, d in enumerate(shape):
            if d > 0 and d % self.data_size == 0:
                return P(*([None] * i), self.batch_axis)
        return P()                      # too small to split evenly

    def opt_shardings(self, tree, moment_keys=None):
        """NamedSharding tree for an updater-state tree
        ({layer: {"m": {param: leaf}, ...}} or {layer: ()}). Leaves under
        a state key in `moment_keys` (default: every param-shaped moment
        key a built-in updater declares) get `moment_spec`; anything
        else follows its param's spec."""
        if moment_keys is None:
            from deeplearning4j_tpu_torch.optim.updaters import (
                MOMENT_STATE_KEYS,
            )
            moment_keys = MOMENT_STATE_KEYS

        def spec_fn(layer_name, param_name, leaf, _state_key=None):
            if _state_key is not None and _state_key in moment_keys:
                return self.moment_spec(layer_name, param_name, leaf)
            return self._param_spec(layer_name, param_name, leaf)

        return self._tree_shardings(tree, spec_fn, state_keyed=True)

    # ---------------------------------------------------------- helpers
    def _tree_shardings(self, tree, spec_fn, *, state_keyed: bool = False):
        """Walk {layer: subtree}; rules apply at the LEAF key (so updater
        state like {'m': {'W': ...}} resolves against param 'W'), with the
        top-level state key threaded through when `state_keyed`."""
        def build(layer_name, sub, state_key=None):
            if not isinstance(sub, dict):
                return () if isinstance(sub, tuple) and not sub \
                    else self.replicated
            out = {}
            for k, v in sub.items():
                if isinstance(v, dict):
                    sk = k if state_keyed and state_key is None else state_key
                    out[k] = build(layer_name, v, sk)
                else:
                    spec = (spec_fn(layer_name, k, v) if state_key is None
                            else spec_fn(layer_name, k, v, state_key))
                    out[k] = NamedSharding(self.mesh, spec)
            return out

        return {ln: build(ln, sub) for ln, sub in tree.items()}


# The active spine: one a process normally; the thread-local stack keeps
# concurrent fits (serving + training in one process) apart.
_SPINE_TLS = threading.local()
_SPINE_DEFAULT: Optional[MeshContext] = None


def set_mesh_context(ctx: Optional[MeshContext]) -> Optional[MeshContext]:
    """Install `ctx` as the process-wide default spine; returns the
    previous default (restore it when done)."""
    global _SPINE_DEFAULT
    prev, _SPINE_DEFAULT = _SPINE_DEFAULT, ctx
    return prev


def current_mesh_context() -> Optional[MeshContext]:
    """The innermost `use_mesh_context` on this thread, else the
    process default, else None (single-device semantics everywhere)."""
    stack = getattr(_SPINE_TLS, "stack", None)
    if stack:
        return stack[-1]
    return _SPINE_DEFAULT


@contextlib.contextmanager
def use_mesh_context(ctx: Optional[MeshContext]):
    """Scope `ctx` as the active spine for this thread."""
    stack = getattr(_SPINE_TLS, "stack", None)
    if stack is None:
        stack = _SPINE_TLS.stack = []
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()
