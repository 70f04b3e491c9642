"""One-pass fused Adam and Nesterovs — the port of
`deeplearning4j_tpu/ops/fused_update.py` (kernels B1a, `_adam_kernel`,
and B1b, `_nesterov_kernel`).

A group of leaves is updated in ONE launch of a hand-written CUDA kernel
(`csrc/fused_update.cu`): p and the moments are updated in place, as the
TPU kernels' `input_output_aliases` make their update in place, each in
its stored dtype with float32 math. The TPU launches once a leaf; here a
device table of the leaves' addresses and sizes drives one launch for
all of them.

The launch plan. `UpdatePlan` is built once for one dtype group's
(p, m, v) or (p, v): it checks device, dtype, contiguity and sizes once,
and holds the device table (the p/m/v columns, the chunk layout and each
block's run of chunks). A call checks the gradients (count, numel,
dtype, device, contiguity: a training step's are new tensors every step)
and passes their addresses by value in the launch's own parameters, so
nothing is copied to the card before the launch. `LeafPlans` is what the
updaters keep: the plans of one leaf set's dtype groups, found by the
params tree's first leaf and valid while every p, m and v tensor is the
one it was built on (identity, not addresses: a rebound tensor builds a
new plan; one that dies drops it). A plan made while a CUDA graph is
captured keeps the table the graph reads alive for the process.

Two designs (`DESIGNS`): "multi" (design 1, a grid-stride loop with a
search a chunk) and "persistent" (design 2, two blocks an SM, each over
a contiguous run of chunks, fed by TMA bulk copies through a 3-stage
ring); see the source's note. Every launch takes design 2
(`DEFAULT_DESIGN`); design 1 stays reachable through `design=`.
`LAUNCHES_BY_DESIGN` counts each.

Adam's `lrbc` = lr · sqrt(1 - β2^t) / (1 - β1^t) and Nesterovs' `lr`
(its schedule's value) are float32 tensors on the device, read by the
kernel, so no step count goes to the host; `LeafPlans.adam_lrbc` makes
Adam's on the card from the step counter in one launch (`adam_lrbc`).

`adam_update_plain`, `nesterov_update_plain` and `adam_lrbc_plain` are
the plain versions: the lines of `_adam_kernel`, `_nesterov_kernel` and
of the updater's bias correction. A wrapper takes its plain version only
for tensors on the CPU; on CUDA tensors it launches the kernel or
raises. `LAUNCHES` and `PLAIN_ON_CUDA` count as in `ops/attention.py`.
"""

from __future__ import annotations

import array
import bisect
import collections
import operator
import weakref
from itertools import chain
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_KERNELS = ("adam_update", "nesterov_update")
LAUNCHES: Dict[str, int] = {"adam_update": 0, "nesterov_update": 0,
                            "adam_lrbc": 0}
PLAIN_ON_CUDA: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
DESIGNS = ("multi", "persistent")
DEFAULT_DESIGN = "persistent"
LAUNCHES_BY_DESIGN: Dict[Tuple[str, str], int] = {
    (k, d): 0 for k in _KERNELS for d in DESIGNS}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# elements a chunk: design 1's 2 float4 vectors a thread of a 256-thread
# block, and design 2's stage (persist::kChunk in the source)
CHUNK = 1 << 11
# the SM count a plan lays its blocks out for where there is no card;
# design 2's blocks an SM (`__launch_bounds__` in the source)
DEFAULT_SMS = 132
BLOCKS_PER_SM = 2
# leaves a launch takes: the gradients' addresses go in its parameters
# (kMaxLeaves in the source); leaf sets kept
MAX_LEAVES = 4000
_PLANS_KEPT = 64
# device tables read by captured CUDA graphs (with their pinned host
# rows, which a graph copies in at every replay): kept for the process
_GRAPH_TABLES: list = []
_DATA_PTR = torch.Tensor.data_ptr
_DTYPE = operator.attrgetter("dtype")
_GET_DEVICE = torch.Tensor.get_device
_SMS: Dict[int, int] = {}


def reset_counts() -> None:
    for d in (LAUNCHES, LAUNCHES_BY_DESIGN, PLAIN_ON_CUDA):
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


def _step_f32(step, device) -> torch.Tensor:
    return torch.as_tensor(step, device=device).to(torch.float32)


def adam_lrbc_plain(step, lr, beta1: float, beta2: float, device=None):
    """Plain version of `adam_lrbc`: Adam's bias-corrected rate
    lr · sqrt(1 - β2^t) / (1 - β1^t), t = step + 1, as float32 tensor
    operations (`lr` a float, or a float32 tensor from a schedule)."""
    device = device or getattr(step, "device", None) or "cpu"
    t = _step_f32(step, device) + 1.0
    if torch.device(device).type == "cuda":
        PLAIN_ON_CUDA["adam_lrbc"] += 1
    lr_t = (lr if isinstance(lr, torch.Tensor)
            else torch.full_like(t - 1.0, float(lr)))
    return lr_t * torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)


_LIB: list = []


def _lib():
    """The kernels' library, built and loaded at first use; design 2's
    shared-memory limit is raised here, once, outside any capture."""
    if not _LIB:
        from deeplearning4j_tpu_torch.ops import cuda_build

        lib = cuda_build.library("fused_update")
        cuda_build.check(lib, lib.dl4j_fused_update_prepare(),
                         "fused_update prepare")
        _LIB.append(lib)
    return _LIB[0]


def _check(lib, rc: int, what: str) -> None:
    from deeplearning4j_tpu_torch.ops import cuda_build

    cuda_build.check(lib, rc, what)


def _stream(device: torch.device) -> int:
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _sm_count(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def block_layout(first_chunks: Sequence[int], n_chunks: int,
                 sms: int) -> List[Tuple[int, int, int]]:
    """Design 2's blocks: min(n_chunks, BLOCKS_PER_SM x sms) contiguous
    runs of chunks, as even as integer division makes them, each (first
    chunk, end chunk, the leaf of its first chunk). `first_chunks[i]` is
    leaf i's first chunk (leaves in table order; an empty leaf owns
    none)."""
    g = min(n_chunks, BLOCKS_PER_SM * sms)
    out = []
    for b in range(g):
        c0, c1 = b * n_chunks // g, (b + 1) * n_chunks // g
        out.append((c0, c1, bisect.bisect_right(first_chunks, c0) - 1))
    return out


def _upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`host` (int64) on the card. Eagerly from pinned memory without a
    wait; inside a capture the copy is the graph's own, so its rows and
    its device table are kept for the process."""
    if device.type != "cuda":
        return host
    host = host.pin_memory()
    dev = host.to(device, non_blocking=True)
    if torch.cuda.is_current_stream_capturing():
        _GRAPH_TABLES.append((host, dev))
    return dev


def _check_scalar(scalar, device) -> None:
    if not isinstance(scalar, torch.Tensor) or \
            scalar.dtype != torch.float32 or scalar.numel() != 1 or \
            scalar.device != device:
        raise ValueError("the step's scalar (lrbc or lr) must be a float32 "
                         "scalar tensor on the leaves' device")


class UpdatePlan:
    """One launch's leaves: a dtype group's p, m (Adam; None for
    Nesterovs) and v, checked once, with the device table built once
    (at most `MAX_LEAVES` leaves on the card).
    The plan holds its tensors by weak reference (`refs`: the caller's,
    whose callbacks drop a `LeafPlans` when a tensor dies), so a kept
    plan never keeps a net's memory alive. `launch` runs B1a or B1b over
    them with the call's gradients (a list in the plan's order)."""

    def __init__(self, kind: str, params, ms, vs, refs=None,
                 sms: Optional[int] = None):
        if kind not in ("adam", "nesterov"):
            raise ValueError(f"unknown fused update {kind!r}")
        self.kind = kind
        self.kernel = "adam_update" if kind == "adam" else "nesterov_update"
        params, vs = list(params), list(vs)
        ms = None if ms is None else list(ms)
        if not params:
            raise ValueError("a plan needs at least one leaf")
        self.device, self.dtype = params[0].device, params[0].dtype
        self.cuda = self.device.type == "cuda"
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no fused update kernel for device "
                             f"{self.device}")
        if self.cuda and len(params) > MAX_LEAVES:
            raise ValueError(f"{len(params)} leaves: a launch takes at most "
                             f"{MAX_LEAVES}")
        self._check_leaves(params, ms, vs)
        self.numels = [p.numel() for p in params]
        self.first_chunks, c = [], 0
        for n in self.numels:
            self.first_chunks.append(c)
            c += -(-n // CHUNK)
        self.n_chunks = c
        self.n_leaves = len(params)
        self.sms = sms or (_sm_count(self.device) if self.cuda
                           else DEFAULT_SMS)
        self.blocks = block_layout(self.first_chunks, self.n_chunks,
                                   self.sms)
        self.rows = [
            [p.data_ptr(), 0 if ms is None else m.data_ptr(), v.data_ptr(),
             n, fc]
            for p, m, v, n, fc in zip(params, ms or params, vs, self.numels,
                                      self.first_chunks)]
        self._host = torch.tensor(
            [w for r in self.rows for w in r]
            + [w for b in self.blocks for w in b], dtype=torch.int64)
        self._graph_only = self.cuda and \
            torch.cuda.is_current_stream_capturing()
        self._set_table(_upload(self._host, self.device))
        self._kept = self._graph_only
        if refs is None:
            refs = [weakref.ref(t)
                    for t in chain(params, ms or (), vs)]
        self.refs = refs

    def _set_table(self, table: torch.Tensor) -> None:
        self.table = table
        self._table_ptr = table.data_ptr()
        self._blocks_ptr = self._table_ptr + 8 * 5 * self.n_leaves

    def _check_leaves(self, params, ms, vs) -> None:
        """Device, dtype, contiguity and sizes, once a plan: one dtype a
        launch on the card (float32 or bfloat16), sizes on both."""
        names, cols = ("pv", (params, vs)) if ms is None else \
            ("pmv", (params, ms, vs))
        if any(len(c) != len(params) for c in cols):
            raise ValueError(f"{', '.join(names)} differ in length")
        dev, dtype = self.device, self.dtype
        if self.cuda and dtype not in _DTYPE_CODES:
            raise TypeError(f"the fused update kernels take float32 or "
                            f"bfloat16 leaves, got {dtype}")
        for i, leaf in enumerate(zip(*cols)):
            n = leaf[0].numel()
            for name, t in zip(names, leaf):
                if t.numel() != n:
                    raise ValueError(f"leaf {i}: {name} has {t.numel()} "
                                     f"elements, p has {n}")
                if not self.cuda:
                    continue
                if t.device != dev:
                    raise ValueError(f"leaf {i} {name} on {t.device}, "
                                     f"not {dev}")
                if t.dtype != dtype:
                    raise TypeError(f"leaf {i} {name} is {t.dtype}; one "
                                    f"launch takes one dtype ({dtype})")
                if not t.is_contiguous():
                    raise ValueError(f"leaf {i} {name} must be contiguous")

    def leaves(self):
        """(params, ms or None, vs): the plan's tensors (raises if one
        was freed)."""
        ts = [r() for r in self.refs]
        if any(t is None for t in ts):
            raise RuntimeError("a tensor of this update plan was freed")
        n = self.n_leaves
        ms = ts[n:2 * n] if self.kind == "adam" else None
        return ts[:n], ms, ts[-n:]

    def _check_grads(self, grads) -> None:
        """Every gradient's count, numel, dtype, device and contiguity,
        in a few passes in C; where one is wrong, the first such raises."""
        if len(grads) != self.n_leaves:
            raise ValueError(f"{len(grads)} gradients for {self.n_leaves} "
                             f"leaves")
        try:
            if list(map(torch.Tensor.numel, grads)) == self.numels and \
                    set(map(_DTYPE, grads)) == {self.dtype} and \
                    (not self.cuda or (
                        set(map(_GET_DEVICE, grads)) == {self.device.index}
                        and all(map(torch.Tensor.is_contiguous, grads)))):
                return
        except (TypeError, AttributeError):
            raise TypeError("every gradient must be a tensor") from None
        for i, (g, n) in enumerate(zip(grads, self.numels)):
            if g.numel() != n:
                raise ValueError(f"leaf {i}: the gradient has {g.numel()} "
                                 f"elements, p has {n}")
            if g.dtype != self.dtype:
                raise TypeError(f"leaf {i}: the gradient is {g.dtype}, p "
                                f"is {self.dtype}")
            if self.cuda and (g.device != self.device or
                              not g.is_contiguous()):
                raise ValueError(f"leaf {i}: the gradient must be "
                                 f"contiguous on {self.device}")

    def launch(self, grads: Sequence[torch.Tensor], scalar, *,
               design: Optional[str] = None, beta1: float = 0.9,
               beta2: float = 0.999, eps: float = 1e-8,
               momentum: float = 0.9) -> None:
        """B1a (Adam: `scalar` is lrbc; beta1, beta2, eps) or B1b
        (Nesterovs: `scalar` is lr; momentum) over the plan's leaves, in
        place: one launch in `design` (default `DEFAULT_DESIGN`) on the
        card, the plain version leaf by leaf on the CPU. The gradients are
        checked on every call (`_check_grads`)."""
        from deeplearning4j_tpu_torch.ops.kernel_defaults import (
            fused_update_policy,
        )

        self._check_grads(grads)
        if not self.cuda:
            fused_update_policy(self.kind, self.device)
            self._plain(grads, scalar, beta1, beta2, eps, momentum)
            return
        _check_scalar(scalar, self.device)
        design = design or DEFAULT_DESIGN
        if design not in DESIGNS:
            raise ValueError(f"no B1 design {design!r}")
        capturing = torch.cuda.is_current_stream_capturing()
        if self._graph_only and not capturing:
            # built inside a capture, whose copy never ran eagerly
            self._set_table(_upload(self._host, self.device))
            self._graph_only = False
        if capturing and not self._kept:
            _GRAPH_TABLES.append(self.table)
            self._kept = True
        lib = _lib()
        # the gradients' addresses, copied into the launch's parameters
        gaddr = array.array("q", map(_DATA_PTR, grads))
        common = (self._table_ptr, gaddr.buffer_info()[0])
        shape = (self.n_leaves, self.n_chunks, CHUNK)
        if design == "persistent":
            common += (self._blocks_ptr, len(self.blocks))
        code, st = _DTYPE_CODES[self.dtype], _stream(self.device)
        if self.kind == "adam":
            fn = (lib.dl4j_adam_persistent if design == "persistent"
                  else lib.dl4j_adam_multi)
            rc = fn(*common, *shape, scalar.data_ptr(), beta1, 1.0 - beta1,
                    beta2, 1.0 - beta2, eps, code, st)
        else:
            fn = (lib.dl4j_nesterov_persistent if design == "persistent"
                  else lib.dl4j_nesterov_multi)
            rc = fn(*common, *shape, scalar.data_ptr(), momentum, code, st)
        if rc:
            _check(lib, rc, f"{self.kernel} ({design})")
        LAUNCHES[self.kernel] += 1
        LAUNCHES_BY_DESIGN[(self.kernel, design)] += 1
        fused_update_policy(self.kind, self.device, design)

    @torch.no_grad()
    def _plain(self, grads, scalar, beta1, beta2, eps, momentum) -> None:
        params, ms, vs = self.leaves()
        if self.kind == "adam":
            for p, g, m, v in zip(params, grads, ms, vs):
                pn, mn, vn = adam_update_plain(p, g, m, v, scalar,
                                               beta1=beta1, beta2=beta2,
                                               eps=eps)
                p.copy_(pn)
                m.copy_(mn)
                v.copy_(vn)
        else:
            for p, g, v in zip(params, grads, vs):
                pn, vn = nesterov_update_plain(p, g, v, scalar,
                                               momentum=momentum)
                p.copy_(pn)
                v.copy_(vn)


# ------------------------------------------------------------ leaf sets
def _fast_leaves(tree) -> Optional[list]:
    """The leaves of a two-level dict tree (layer -> name -> tensor) in
    `tree_leaves` order, in C; None where the tree is not dicts of
    dicts (deeper levels come out as dicts: the plan then walks with
    `tree_leaves`)."""
    try:
        return list(chain.from_iterable(map(dict.values, tree.values())))
    except (TypeError, AttributeError):
        return None


def _iter_fast(tree):
    return chain.from_iterable(map(dict.values, tree.values()))


class LeafPlans:
    """The update plans of one leaf set (a params tree and its moment
    trees), one a dtype group in first-seen order (one launch each; a
    group of more than `MAX_LEAVES` leaves is cut into launches of at
    most that many), as
    `Adam` / `Nesterovs.update_with_params` keep them. Valid while each
    p, m and v is the tensor it was built on: `ids` (their `id`s, which
    stay theirs while they live; any of them dying drops the plans from
    `_PLANS` through a weak-reference callback). `fast`: the three trees
    are two-level dicts, walked in C."""

    def __init__(self, kind: str, params, ms, vs, key):
        from deeplearning4j_tpu_torch.optim.updaters import tree_leaves

        trees = (params, vs) if ms is None else (params, ms, vs)
        flat = [tree_leaves(t) for t in trees]
        if any(len(f) != len(flat[0]) for f in flat):
            raise ValueError("the params and state trees differ in their "
                             "leaves")
        if not flat[0]:
            raise ValueError("an updater needs at least one parameter")
        fast = [_fast_leaves(t) for t in trees]
        self.fast = all(f is not None and len(f) == len(g) and
                        all(a is b for a, b in zip(f, g))
                        for f, g in zip(fast, flat))
        self.kind, self.n = kind, len(flat[0])
        self.device = flat[0][0].device
        self.ids = [id(t) for t in chain.from_iterable(flat)]
        self.token = object()
        drop = _dropper(key, self.token)
        refs = [weakref.ref(t, drop) for t in chain.from_iterable(flat)]
        n = self.n
        prefs, vrefs = refs[:n], refs[-n:]
        mrefs = refs[n:2 * n] if ms is not None else None
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, p in enumerate(flat[0]):
            by_dtype.setdefault(p.dtype, []).append(i)
        # a launch takes at most MAX_LEAVES leaves
        groups = [idx[k:k + MAX_LEAVES] for idx in by_dtype.values()
                  for k in range(0, len(idx), MAX_LEAVES)]
        self.groups = []
        for idx in groups:
            pick = lambda xs: [xs[i] for i in idx]  # noqa: E731
            plan = UpdatePlan(
                kind, pick(flat[0]), None if ms is None else pick(flat[1]),
                pick(flat[-1]),
                refs=pick(prefs) + (pick(mrefs) if mrefs else []) +
                pick(vrefs))
            self.groups.append((None if len(groups) == 1 else idx, plan))
        self._lrbc: Optional[torch.Tensor] = None
        self._constants: Dict[float, torch.Tensor] = {}

    def grads(self, tree) -> list:
        """The gradient tree's leaves in the plan's order."""
        if self.fast:
            leaves = _fast_leaves(tree)
            if leaves is not None:
                return leaves
        from deeplearning4j_tpu_torch.optim.updaters import tree_leaves

        return tree_leaves(tree)

    def run(self, grads: list, scalar, **hyper) -> None:
        """One launch a dtype group over `grads` (in the plan's order)."""
        if len(grads) != self.n:
            raise ValueError(f"{len(grads)} gradients for {self.n} leaves")
        for idx, plan in self.groups:
            plan.launch(grads if idx is None else [grads[i] for i in idx],
                        scalar, **hyper)

    def _keep(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            _GRAPH_TABLES.append(t)
        return t

    def constant(self, value: float) -> torch.Tensor:
        """A float32 scalar tensor of `value` on the leaves' device, made
        once (a constant learning rate)."""
        t = self._constants.get(value)
        if t is None:
            t = self._constants[value] = torch.tensor(
                value, dtype=torch.float32, device=self.device)
        return self._keep(t)

    def adam_lrbc(self, step, lr, beta1: float, beta2: float
                  ) -> torch.Tensor:
        """Adam's lrbc for `step` (`lr` a float or a float32 tensor from
        a schedule): kernel `adam_lrbc` into a scalar of the plans' own
        on the card (read by the launch that follows on the stream), the
        plain version on the CPU."""
        if self.device.type != "cuda":
            return adam_lrbc_plain(step, lr, beta1, beta2, self.device)
        if self._lrbc is None:
            self._lrbc = torch.empty((), dtype=torch.float32,
                                     device=self.device)
        return adam_lrbc(step, lr, beta1, beta2, out=self._keep(self._lrbc))


# (kind, id of the params tree's first leaf) -> LeafPlans, least recently
# used first
_PLANS: "collections.OrderedDict[tuple, LeafPlans]" = \
    collections.OrderedDict()


def _dropper(key, token, plans=_PLANS):
    # `plans` is bound now: the callback may run while the interpreter
    # tears the module down
    def drop(_ref):
        cur = plans.get(key)
        if cur is not None and cur.token is token:
            del plans[key]
    return drop


def leaf_plans(kind: str, params, ms, vs) -> LeafPlans:
    """The kept `LeafPlans` of these trees (`ms` None for Nesterovs),
    built anew when any p, m or v is another tensor than the kept plans
    were built on. A call walks the three trees once, comparing each
    tensor's `id` with the plans' (sound: the plans' tensors all live)."""
    from deeplearning4j_tpu_torch.optim.updaters import tree_leaves

    try:
        first = next(_iter_fast(params), None)
    except (TypeError, AttributeError):
        first = None
    if first is None:
        leaves = tree_leaves(params)
        if not leaves:
            raise ValueError("an updater needs at least one parameter")
        first = leaves[0]
    key = (kind, id(first))
    plans = _PLANS.get(key)
    if plans is not None:
        trees = (params, vs) if ms is None else (params, ms, vs)
        try:
            ids = list(map(id, chain.from_iterable(map(
                _iter_fast if plans.fast else tree_leaves, trees))))
        except (TypeError, AttributeError):
            ids = None
        if ids == plans.ids:
            return plans
    plans = _PLANS[key] = LeafPlans(kind, params, ms, vs, key)
    _PLANS.move_to_end(key)
    while len(_PLANS) > _PLANS_KEPT:
        _PLANS.popitem(last=False)
    return plans


# ------------------------------------------------------------- wrappers
def adam_lrbc(step, lr, beta1: float, beta2: float, *,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Adam's bias-corrected rate for the device step counter `step`
    (int64, 0-d; another integer is moved there first) and `lr` (a
    float, or a float32 scalar tensor on the card: a schedule's value):
    one launch of `adam_lrbc_kernel` into `out` (a float32 scalar on the
    card, made when not given)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    if dev is None or dev.type != "cuda":
        dev = out.device if out is not None else torch.device("cuda")
    if not isinstance(step, torch.Tensor) or step.device != dev or \
            step.dtype != torch.int64 or step.dim():
        step = torch.as_tensor(step, device=dev).to(torch.int64).reshape(())
    lr_ptr = None
    if isinstance(lr, torch.Tensor):
        _check_scalar(lr, dev)
        lr_ptr, lr = lr.data_ptr(), 0.0
    if out is None:
        out = torch.empty((), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.dl4j_adam_lrbc(step.data_ptr(), lr_ptr, float(lr), beta1,
                            beta2, out.data_ptr(), _stream(dev))
    if rc:
        _check(lib, rc, "adam_lrbc")
    LAUNCHES["adam_lrbc"] += 1
    return out


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], lrbc: torch.Tensor, *,
                beta1: float = 0.9, beta2: float = 0.999,
                eps: float = 1e-8, design: Optional[str] = None) -> None:
    """Kernel B1a over a group of leaves, in place: one launch on CUDA
    tensors (in `design`, default `DEFAULT_DESIGN`; one a `MAX_LEAVES`
    leaves past that many), the plain version leaf by leaf on CPU
    tensors. Checks everything on every call (a throw-away plan); the
    updaters keep their plans (`leaf_plans`)."""
    params, grads, ms, vs = (list(x) for x in (params, grads, ms, vs))
    if not (len(params) == len(grads) == len(ms) == len(vs)):
        raise ValueError("params, grads, m and v differ in length")
    for k in range(0, len(params), MAX_LEAVES):
        cut = slice(k, k + MAX_LEAVES)
        UpdatePlan("adam", params[cut], ms[cut], vs[cut]).launch(
            grads[cut], lrbc, design=design, beta1=beta1, beta2=beta2,
            eps=eps)


def nesterov_update(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    vs: Sequence[torch.Tensor], lr: torch.Tensor, *,
                    momentum: float = 0.9,
                    design: Optional[str] = None) -> None:
    """Kernel B1b over a group of leaves, in place: one launch on CUDA
    tensors, the plain version leaf by leaf on CPU tensors (a throw-away
    plan, as `adam_update`)."""
    params, grads, vs = (list(x) for x in (params, grads, vs))
    if not (len(params) == len(grads) == len(vs)):
        raise ValueError("params, grads and v differ in length")
    for k in range(0, len(params), MAX_LEAVES):
        cut = slice(k, k + MAX_LEAVES)
        UpdatePlan("nesterov", params[cut], None, vs[cut]).launch(
            grads[cut], lr, design=design, momentum=momentum)
