"""MultiLayerNetwork — the sequential-stack runtime of the PyTorch port
(port of `deeplearning4j_tpu/models/multilayer.py`): inference, the
slot-indexed serving sessions, stateful stepping (`rnn_time_step`) of
recurrent and attention stacks (lockstep KV caches), training (`init`
with updaters, `make_step_fn`, `fit` with truncated BPTT and gradient
checkpointing, `score`) and evaluation (`predict`, `evaluate*`: the
argmax on the device, class indices to the host).

Parameters are a dict of per-layer tensor dicts (nested for the
bidirectional wrappers) keyed exactly like the JAX `params_tree`, so `models.convert.params_from_numpy` loads a JAX
net's weights unchanged; `updater_state` mirrors JAX's per-layer
updater state, loaded by `updater_state_from_numpy`; `state_tree` holds
the batch-norm running statistics, which every forward reads. The net
lives on one device: CUDA unless the caller passes `device="cpu"`.

A train step takes gradients with `torch.autograd.grad` over detached
copies of the parameter leaves, then updates parameters and optimizer
moments IN PLACE, as the JAX step donates them and the TPU kernels alias
them: one `update_with_params` call a group of layers that share an
updater, so the zoo transformer's Adam is one launch of kernel B1a a
step. Its step counter lives on the device, and the loss stays there
until the fit loop reads it once an epoch (`optim/executor.py`).

On the card, `fit(steps_per_dispatch=K)` runs K train steps as one CUDA
graph, and each `session_decode_window`, speculative
`session_propose_window` / `session_verify_window` and `rnn_time_step`
call is one graph replay (`utils/cuda_graphs.py`): so a step reads and
writes every tensor of the net where the graph found it. Parameters, optimizer
moments, the batch-norm running statistics and the step counter are
updated in place, never rebound. `cuda_graphs = False` runs those calls
eagerly instead (the plain version of the graphs).

`pretrain` trains each pretrainable layer (AutoEncoder, RBM, VAE) on
its `reconstruction_score`, layer by layer, through that layer's own
updater (kernel B1a under Adam, B1b under Nesterovs); a configuration
whose `optimization_algo` is not SGD fits each batch with a full-batch
solver (`optim/solvers.py`) over the flat parameter view (`params()` /
`set_params()`, which copy into the net's tensors in place).

Slot-indexed sessions thread their carries through `session_step` and
`session_decode_window` as arguments, as in JAX, but the KV caches
inside those carries are updated in place (see
`nn/layers/attention.py`): only per-slot position vectors are new
tensors after a step, and every lane that must not write is masked out
of the cache write itself.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (
    DevicePrefetchIterator, as_iterator,
)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.models.decode_state import DecodeState
from deeplearning4j_tpu_torch.nn.layers import (
    BaseRecurrentLayer, Bidirectional, EmbeddingSequenceLayer,
    GravesBidirectionalLSTM, LastTimeStep, Layer,
)
from deeplearning4j_tpu_torch.nn.layers.attention import new_kv_cache
from deeplearning4j_tpu_torch.nn.layers.base import RngTape
from deeplearning4j_tpu_torch.nn.layers.special import CenterLossOutputLayer
from deeplearning4j_tpu_torch.optim.executor import (
    LossTracker, TrainingExecutor,
)
from deeplearning4j_tpu_torch.optim.listeners import TrainingListener
from deeplearning4j_tpu_torch.optim.updaters import (
    NoOp, Updater, resolve_updater, tree_leaves, tree_map,
)
from deeplearning4j_tpu_torch.utils.cuda_graphs import NetGraphs
from deeplearning4j_tpu_torch.utils.device import resolve_device
from deeplearning4j_tpu_torch.utils.pytrees import (
    copy_flat_, flatten_params,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _is_recurrent(layer: Layer) -> bool:
    return isinstance(layer, (BaseRecurrentLayer, Bidirectional,
                              GravesBidirectionalLSTM))


def _decode_limit(decode_layers) -> Optional[int]:
    """Smallest KV-cache/position bound among decode layers; rolling
    caches are buffers, not length bounds."""
    limits = []
    for l in decode_layers:
        if not getattr(l, "rolling_cache", False):
            mc = getattr(l, "max_cache", None)
            if mc is not None:
                limits.append(mc)
        ml = getattr(l, "max_length", None)
        if ml is not None:
            limits.append(ml)
    return min(limits) if limits else None


def _check_decode_budget(pos0: int, decode_layers, t_step: int) -> None:
    """The host-side decode-length guard of `rnn_time_step`: raises
    before a step that would run past the smallest cache/position limit,
    from the decode position the net keeps on the host (`DecodeState`),
    so a graphed step never reads one. The caller advances it only
    after a step that succeeded."""
    limit = _decode_limit(decode_layers)
    if limit is not None and pos0 + t_step > limit:
        raise ValueError(
            f"decode position {pos0} + step {t_step} exceeds the "
            f"smallest cache/position limit {limit}; raise "
            f"max_cache/max_length or rnn_clear_previous_state()")


def _validate_causal_decode(named_layers, kind: str = "layer") -> None:
    """Validate every (name, layer) before seeding any carry: a raise
    midway would leave partial carries behind and disarm the budget
    guard."""
    for name, l in named_layers:
        if not getattr(l, "causal", True):
            raise ValueError(
                f"rnn_time_step requires causal attention; {kind} {name!r} is "
                f"non-causal (stepped decoding cannot see future tokens, "
                f"so it cannot reproduce a bidirectional forward)")


def _checkpointed(apply_fn, params, x, st, rng, mask):
    """One layer (or vertex) apply of the train path under gradient
    checkpointing (`torch.utils.checkpoint`, non-reentrant): its
    activations are recomputed in the backward instead of stored. The
    recompute replays the forward's dropout draws from an `RngTape`, so
    a checkpointed step equals the plain one bit for bit. Shared by
    `MultiLayerNetwork` and `ComputationGraph`, as JAX's `_checkpointed`
    is."""
    tape = None if rng is None else RngTape(rng)

    def run(p, inp):
        if tape is not None:
            tape.start()
        return apply_fn(p, inp, state=st, train=True, rng=tape, mask=mask)

    return torch.utils.checkpoint.checkpoint(
        run, params, x, use_reentrant=False, preserve_rng_state=False)


def _with_stats_group(layer, apply_fn, group):
    """`apply_fn` with a data-parallel step's `group` bound where the
    layer reduces over the batch (`Layer.BATCH_STATS`)."""
    if group is None or not layer.BATCH_STATS:
        return apply_fn
    return functools.partial(apply_fn, stats_group=group)


def _stateful_step(net, fwd, xs: tuple, carries):
    """One `rnn_time_step` call of either runtime: `fwd(xs, carries) ->
    (out, new carries)`, as one graph replay per (inputs' layout,
    carries present) on the card (`utils/cuda_graphs`). The KV caches
    are written in place where they lie (the graph is keyed by their
    addresses), and the other carry leaves (positions, recurrent h/c)
    live in the graph's static buffers, which the step writes back in
    place: the returned carries hold the caches and those buffers, so
    the next call copies nothing. With `cuda_graphs` off, `fwd` runs
    eagerly."""
    if not net.cuda_graphs:
        return fwd(xs, carries)
    leaves = sorted(_carry_leaves(carries or {}), key=lambda pa: pa[0])
    small = [(path, a) for path, a in leaves
             if path[-1] not in ("cache_k", "cache_v")]
    in_place = tuple(a.data_ptr() for path, a in leaves
                     if path[-1] in ("cache_k", "cache_v"))

    def step(xs_, small_):
        c = None if carries is None else _with_leaves(
            carries, dict(zip((p for p, _ in small), small_)))
        out, new = fwd(xs_, c)
        if c is None:
            return out, new
        _copy_states(c, new)       # written back in place
        return out, None

    out, new = net._graphs.run(
        ("rnn_time_step", carries is not None), step,
        (xs, tuple(a for _, a in small)),
        addresses=in_place + tuple(
            t.data_ptr() for t in tree_leaves(net.params_tree)))
    if new is None:
        static = net._graphs.inputs(net._graphs.last_key)[1]
        new = _with_leaves(carries, dict(zip((p for p, _ in small),
                                             static)))
    return out, new


def _reorder_carries(carries, idx, device):
    """Beam reselection over the stepping carries: gather each batch-
    leading leaf's rows to `idx` (0-d positions pass through). A
    reorder that keeps the batch gathers in place (a graph keyed by
    the caches' addresses replays over them); one that expands it
    builds new tensors, caches with their drop row (`new_kv_cache`)."""
    ix = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=device)

    def gather(a):
        if a.ndim < 1:
            return a
        if a.shape[0] == ix.shape[0]:
            return a.copy_(a[ix])
        out = new_kv_cache((ix.shape[0], *a.shape[1:]), a.dtype, a.device)
        return torch.index_select(a, 0, ix, out=out)

    return tree_map(gather, carries)


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _to_device(a, dtype, device) -> Optional[torch.Tensor]:
    """A host batch array as a tensor on `device`: cast on the host,
    then, on a CUDA device, a non-blocking copy from pinned memory (the
    host never waits for it). `dtype` None keeps integer arrays integer
    and makes floating ones float32."""
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    if dtype is None:
        dtype = torch.float32 if t.is_floating_point() else torch.int64
    if t.device == device:
        return t.to(dtype)
    t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host numpy array (bfloat16 as float32,
    which numpy lacks)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _argmax_i32(y: torch.Tensor) -> torch.Tensor:
    """Class indices of the last axis, on `y`'s device, as int32 (what
    crosses to the host in `evaluate`)."""
    return torch.argmax(y, dim=-1).to(torch.int32)


def _norm(tree) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in tree_leaves(tree)))


def _normalize_grads(grads, mode: str, threshold: float):
    """Gradient normalization/clipping per layer subtree (reference:
    `GradientNormalization`), the five modes of the JAX package."""
    if mode == "none":
        return grads
    if mode == "clip_elementwise_absolute_value":
        return tree_map(lambda g: torch.clamp(g, -threshold, threshold),
                        grads)

    def clip(g, n):
        return g * torch.clamp(threshold / torch.clamp(n, min=1e-8), max=1.0)

    def per_layer(sub):
        if mode == "renormalize_l2_per_layer":
            n = _norm(sub)
            return tree_map(lambda g: g / torch.clamp(n, min=1e-8), sub)
        if mode == "clip_l2_per_layer":
            n = _norm(sub)
            return tree_map(lambda g: clip(g, n), sub)
        if mode == "renormalize_l2_per_param_type":
            return tree_map(lambda g: g / torch.clamp(
                torch.linalg.vector_norm(g), min=1e-8), sub)
        if mode == "clip_l2_per_param_type":
            return tree_map(lambda g: clip(g, torch.linalg.vector_norm(g)),
                            sub)
        raise ValueError(mode)

    return {name: per_layer(sub) for name, sub in grads.items()}


def _updater_groups(updaters: Dict[str, Updater]
                    ) -> List[Tuple[Updater, List[str]]]:
    """Layers (or vertices) sharing one updater configuration (equal
    dataclasses), in order: each group is one `update_with_params` call,
    so its leaves go through one fused launch. Frozen ones (NoOp) are
    left out."""
    groups: List[Tuple[Updater, List[str]]] = []
    for name, u in updaters.items():
        if isinstance(u, NoOp):
            continue
        for gu, names in groups:
            if gu == u:
                names.append(name)
                break
        else:
            groups.append((u, [name]))
    return groups


def _grad_and_update(loss_fn, params, opt_state, groups, mode: str,
                     threshold: float, step, dp=None):
    """One train step's gradients and update. `loss_fn(live)` returns
    (loss, aux) for `live`, the params with every trained leaf replaced
    by a detached view that requires grad: the stored tensors stay plain,
    so the update, IN PLACE into `params` and `opt_state`, needs no
    autograd bookkeeping. Gradients are made contiguous (the fused update
    kernels read them densely; a convolution's weight gradient can come
    back permuted). Under a `ParallelWrapper`, `dp` (the net's `_dp`)
    turns the rank's loss and gradients into the global means before
    the normalization, hands the updaters the rank's slices of the
    parameters and gradients, and gathers every rank's updated slices
    after them. Returns (loss detached, aux)."""
    trained = [n for _, names in groups for n in names]
    live = {n: (tree_map(lambda v: v.detach().requires_grad_(True), sub)
                if n in trained else sub)
            for n, sub in params.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(live)
        wrt = [leaf for n in trained for leaf in tree_leaves(live[n])]
        got = torch.autograd.grad(loss, wrt, allow_unused=True)
    it = iter(got)

    def grad_of(v):
        g = next(it)
        return torch.zeros_like(v) if g is None else g.contiguous()

    grads = {n: tree_map(grad_of, params[n]) for n in trained}
    loss = loss.detach()
    if dp is not None:
        loss, grads = dp.reduce(loss, grads)
    grads = _normalize_grads(grads, mode, threshold)
    upd_params, upd_grads = (params, grads) if dp is None else \
        dp.slices(params, grads)
    for u, names in groups:
        st = {n: opt_state[n] for n in names}
        first = st[names[0]]
        group_state = ({key: {n: st[n][key] for n in names} for key in first}
                       if isinstance(first, dict) else ())
        u.update_with_params({n: upd_grads[n] for n in names}, group_state,
                             {n: upd_params[n] for n in names}, step)
    if dp is not None:
        dp.gather(params)
    return loss, aux


def _copy_states(states: dict, new: dict) -> None:
    """Copy a step's new states into `states`' tensors in place, key by
    key (a leaf the step passed through is the same tensor: skipped). A
    key `states` lacks, or a leaf whose dtype or shape the step changed
    (a float64 net's float32 statistics), is bound anew, as JAX's step
    returns it; the next dispatch then captures its graph anew."""
    for k, nxt in new.items():
        old = states.get(k)
        if isinstance(nxt, dict):
            if old is None:
                old = states[k] = {}
            _copy_states(old, nxt)
        elif old is None or old.dtype != nxt.dtype or \
                old.shape != nxt.shape:
            states[k] = nxt
        elif nxt is not old:
            old.copy_(nxt)


def _field_lists(fields):
    """K batches' fields (each batch a tuple: tensors, dicts of tensors
    by input or output name, or None) as one entry a field: a list of K
    tensors, a dict of such lists, or None for a field the batches
    lack."""
    out = []
    for i, f0 in enumerate(fields[0]):
        if f0 is None:
            out.append(None)
        elif isinstance(f0, dict):
            out.append({k: [f[i][k] for f in fields] for k in f0})
        else:
            out.append([f[i] for f in fields])
    return out


def _field_at(a, j):
    """Step j's slice of a stacked field (`_field_lists`' layout)."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: v[j] for k, v in a.items()}
    return a[j]


def _carry_leaves(tree, path=()):
    """(path, tensor) of every leaf of a carry tree, in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _carry_leaves(v, (*path, k))
        else:
            yield (*path, k), v


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _with_leaves(tree, leaves: dict, path=()):
    """A copy of the dict tree with the leaves at `leaves`' paths
    replaced (every other leaf is the same tensor)."""
    return {k: (_with_leaves(v, leaves, (*path, k)) if isinstance(v, dict)
                else leaves.get((*path, k), v))
            for k, v in tree.items()}


_GRAPH_LEAVES = ("pos", "page_table")


def _write_back(old_tree, new_tree):
    """`new_tree` with every leaf but the positions and page tables
    copied into `old_tree`'s tensor where the step built a new one (the
    recurrent h/c; the KV caches were written in place already): the
    pool's carries keep their addresses, which a captured window reads
    and writes, and the caller's tree advances."""
    out = {}
    for k, new in new_tree.items():
        old = old_tree.get(k) if old_tree else None
        if isinstance(new, dict):
            out[k] = _write_back(old, new)
        elif old is None or new is old or k in _GRAPH_LEAVES:
            out[k] = new
        else:
            out[k] = old.copy_(new)
    return out


def _lane_pack(values, dev) -> torch.Tensor:
    """Per-lane arrays as one float64 [len(values), S] tensor on `dev`
    (tokens, seed words, counts and float32 knobs are all exact in
    float64): one pinned copy to the card when they are host arrays."""
    if any(isinstance(v, torch.Tensor) and v.device.type != "cpu"
           for v in values):
        return torch.stack([_as_tensor(v, torch.float64, dev)
                            for v in values])
    host = torch.from_numpy(np.stack([
        (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        .astype(np.float64) for v in values]))
    if dev.type == "cuda":
        return host.pin_memory().to(dev, non_blocking=True)
    return host


def _window_k(k, what: str) -> int:
    k = int(k)
    if k < 1:
        raise ValueError(f"{what} k must be >= 1, got {k}")
    return k


def _fit_with_plan(net, step, data, labels, epochs, batch_size,
                   steps_per_dispatch, device_prefetch, sync_every, **rec):
    """The fit loop both nets share: the recovery plan (None without a
    recovery argument), the device prefetch, the executor."""
    from deeplearning4j_tpu_torch.optim.recovery import (
        build_plan, run_with_recovery,
    )

    plan = build_plan(net, **rec)
    k = max(1, int(steps_per_dispatch))
    it = as_iterator(data, labels, batch_size)
    if device_prefetch:
        it = DevicePrefetchIterator(it, net._put_batch, depth=max(2, k),
                                    device=net.device)
    net._loss_tracker.sync_every = int(sync_every)
    net._start_steps()
    execu = TrainingExecutor(
        net, step=step, fused_step=net._fused_dispatch,
        can_fuse=net._can_fuse, steps_per_dispatch=k,
        before_batch=plan.before_batch if plan else None,
        after_dispatch=plan.after_dispatch if plan else None,
        epoch_start=plan.epoch_start if plan else None,
        epoch_end=plan.epoch_end if plan else None)
    run_with_recovery(execu, plan, it, epochs)
    net.stopped_early = execu.stopped
    return net


class MultiLayerNetwork:
    """Sequential network runtime over a MultiLayerConfiguration."""

    # set by a `ParallelWrapper`: its data-parallel step hooks, the
    # owner tag its collectives are priced under, the placements of the
    # replica-sharded moments (the checkpointer reads them)
    _dp = None
    _comm_owner = None
    _placements = None
    stopped_early = False

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.layers: Tuple[Layer, ...] = tuple(conf.layers)
        self.dtype = _DTYPES[conf.dtype]
        self.device = resolve_device(device)
        self.params_tree: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.state_tree: Dict[str, Any] = {}
        self.updater_state: Optional[Dict[str, Any]] = None
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[TrainingListener] = []
        self.last_batch_size: Optional[int] = None
        self.last_seq_len: Optional[int] = None
        self._loss_tracker = LossTracker()
        self._layer_updaters: Dict[str, Updater] = {}
        self._stateful: set = set()
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(int(conf.seed))
        self._step_t: Optional[torch.Tensor] = None
        self._decode_state = DecodeState()
        self.cuda_graphs = True
        self._graphs = NetGraphs(self.device, owner=self)
        self.fit_stats = {"graph_windows": 0, "eager_steps": 0}
        self._solver = None
        self.pretrain_losses: Dict[str, List[torch.Tensor]] = {}

    @property
    def score_(self) -> Optional[float]:
        """Most recent training loss as a float. Reading it waits for the
        device (a host sync) unless the fit loop already read it."""
        return self._loss_tracker.value

    # ------------------------------------------------------------- init
    def init(self) -> "MultiLayerNetwork":
        """Seeded init from `conf.seed` with a torch.Generator on the CPU,
        then moved to the device; then the per-layer updaters and their
        state. Not the JAX weights for the same seed: parity tests load
        those with `params_from_numpy`."""
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        params, states = {}, {}
        it = self.conf.input_type
        for i, layer in enumerate(self.layers):
            if it is not None and i in self.conf.preprocessors:
                it = self.conf.preprocessors[i].output_type(it)
            p, st = layer.init_params(gen, it, self.dtype)
            params[layer.name] = tree_map(lambda v: v.to(self.device), p)
            states[layer.name] = tree_map(lambda v: v.to(self.device), st)
            if st:
                self._stateful.add(layer.name)
            if it is not None:
                it = layer.output_type(it)
        self.params_tree = params
        self.state_tree = states
        self._build_updaters()
        self.updater_state = {name: u.init(params[name])
                              for name, u in self._layer_updaters.items()}
        self._start_steps()
        return self

    def _build_updaters(self):
        """Per-layer updaters honoring per-layer overrides and freezing
        (reference: MultiLayerUpdater / UpdaterBlock grouping)."""
        global_u = resolve_updater(self.conf.updater or "sgd")
        for layer in self.layers:
            u = layer.updater if layer.updater is not None else global_u
            u = resolve_updater(u)
            if layer.learning_rate is not None and \
                    hasattr(u, "learning_rate"):
                u = dataclasses.replace(u, learning_rate=layer.learning_rate)
            if layer.frozen:
                u = NoOp()
            self._layer_updaters[layer.name] = u

    def _check_init(self):
        if self.params_tree is None:
            raise RuntimeError("network not initialized: call init()")

    # ---------------------------------------------------------- forward
    def _forward(self, params, x, *, train: bool = False, rng=None,
                 fmask=None, carries=None, stop: Optional[int] = None,
                 states=None, acts: Optional[list] = None,
                 stats_group=None):
        """Run layers[:stop] (all by default), each after its input
        preprocessor; returns (output, new states by layer name). A
        layer's state is its entry in `carries` (recurrent carries), else
        in `states` (`state_tree` by default: batch-norm running
        statistics). Dropout draws from the generator `rng` when
        `train`. Under `gradient_checkpointing` every layer but the
        output layer is checkpointed in training (`_checkpointed`); the
        output layer's input is kept for the loss anyway. With `acts` a
        list, each layer's output is appended to it. `stats_group` (a
        data-parallel step's ranks) goes to every batch-norm layer."""
        new_states = {}
        pps = self.conf.preprocessors
        states = self.state_tree if states is None else states
        n = len(self.layers)
        for i, layer in enumerate(self.layers[:stop]):
            if i in pps:
                x = pps[i].apply(x, fmask)
            if carries and layer.name in carries:
                st = carries[layer.name]
            else:
                st = states.get(layer.name) or None
            apply = _with_stats_group(layer, layer.apply, stats_group)
            if train and self.conf.gradient_checkpointing and not (
                    layer.is_output_layer and i == n - 1):
                x, new_st = _checkpointed(apply, params[layer.name],
                                          x, st, rng, fmask)
            else:
                x, new_st = apply(params[layer.name], x, state=st,
                                  train=train, rng=rng, mask=fmask)
            new_states[layer.name] = new_st
            if acts is not None:
                acts.append(x)
        return x, new_states

    # ------------------------------------------------------------- loss
    def _loss(self, params, features, labels, fmask, lmask, rng,
              train: bool = True, carries=None, states=None,
              stats_group=None):
        """Score = output-layer loss + L1/L2 regularization + any layer's
        `aux_loss`. The output layer scores its INPUT (its softmax is
        fused into the loss), so the stack runs up to it. A
        `CenterLossOutputLayer` adds its center term and returns its
        moved centers as its new state."""
        out_layer = self.layers[-1]
        if not out_layer.is_output_layer:
            raise ValueError(f"the last layer ({out_layer.name}) is not an "
                             f"output layer; nothing to score")
        last = len(self.layers) - 1
        out_in, new_states = self._forward(
            params, features, train=train, rng=rng, fmask=fmask,
            carries=carries, stop=last, states=states,
            stats_group=stats_group)
        if last in self.conf.preprocessors:
            out_in = self.conf.preprocessors[last].apply(out_in, fmask)
        score_mask = lmask if lmask is not None else (
            fmask if labels is not None and labels.ndim == 3 else None)
        if isinstance(out_layer, CenterLossOutputLayer):
            st = (self.state_tree if states is None else states)
            score, new_states[out_layer.name] = out_layer.score_and_state(
                params[out_layer.name], out_in, labels, st[out_layer.name],
                score_mask)
        else:
            score = out_layer.score(params[out_layer.name], out_in, labels,
                                    score_mask)
        reg = sum(layer.regularization(params[layer.name])
                  for layer in self.layers
                  if any((layer.l1, layer.l2, layer.l1_bias, layer.l2_bias)))
        aux = sum(st["aux_loss"] for st in new_states.values()
                  if isinstance(st, dict) and "aux_loss" in st)
        return score + reg + aux, new_states

    # ------------------------------------------------------- train step
    def make_step_fn(self, tbptt: bool = False):
        """The train step: `step_fn(params, opt_state, states, step,
        features, labels, fmask, lmask, rng, carries)` returns
        `(params, opt_state, states, loss, carries)`, as JAX's does.
        Params and opt_state are updated IN PLACE and returned; the loss
        is a 0-dim tensor on the device. With `tbptt` the returned
        carries are the recurrent layers' final states, detached, for
        the next chunk; else `{}`."""
        mode = self.conf.gradient_normalization
        thr = self.conf.gradient_normalization_threshold
        groups = _updater_groups(self._layer_updaters)
        stateful = self._stateful
        rnn_names = self._rnn_layer_names
        dp = self._dp
        stats_group = dp.stats_group if dp is not None else None

        def step_fn(params, opt_state, states, step, features, labels,
                    fmask, lmask, rng, carries):
            loss, new_states = _grad_and_update(
                lambda live: self._loss(live, features, labels, fmask,
                                        lmask, rng, train=True,
                                        carries=carries, states=states,
                                        stats_group=stats_group),
                params, opt_state, groups, mode, thr, step, dp)
            persist = {n: (tree_map(torch.detach, new_states[n])
                           if n in stateful else states.get(n, {}))
                       for n in states}
            out_carries = {n: tree_map(torch.detach, new_states[n])
                           for n in rnn_names} if tbptt else {}
            return params, opt_state, persist, loss, out_carries

        return step_fn

    # ---------------------------------------------------------- fit API
    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 32, steps_per_dispatch: int = 1,
            device_prefetch: bool = True, sync_every: int = 0,
            checkpointer=None, checkpoint_every: int = 1, resume=None,
            stop_fn=None, preemption=None):
        """Train on arrays, a DataSet, a DataSetIterator or any iterable
        of DataSets (reference: `fit(DataSetIterator)`). The loss stays
        on the device (``score_`` reads it; ``sync_every=N`` reads it
        every N steps); ``device_prefetch`` keeps max(2, K) batches'
        copies to the card in flight on a side stream
        (`DevicePrefetchIterator`).

        ``steps_per_dispatch=K`` runs K same-shape batches as one
        dispatch (`_fused_dispatch`: one CUDA graph of K train steps on
        the card). A tail shorter than K, a batch whose shapes differ
        from the window's and a tBPTT batch run per step, as in JAX;
        `fit_stats` counts graph windows and eager steps.

        With ``conf.tbptt_fwd_length > 0`` a 3-D batch trains by
        truncated BPTT (`_fit_tbptt`).

        ``conf.gradient_checkpointing`` recomputes each layer's
        activations in the backward (`_checkpointed`).

        Under a non-SGD ``conf.optimization_algo`` each batch is one
        full-batch solver run of ``conf.solver_iterations`` iterations
        (`optim/solvers.fit_with_solver`), never fused.

        Recovery (`optim/recovery.RecoveryPlan`): a ``checkpointer`` (a
        `parallel.ShardedCheckpointer`) saves every ``checkpoint_every``
        iterations, asynchronously; ``resume`` ("auto" or a position
        dict) continues mid-epoch from the exact batch, generator state
        and step, and ``epochs`` then counts the whole run's epochs;
        ``stop_fn`` / ``preemption=True`` stop cleanly at a batch
        boundary with a final exact-position snapshot. None of these
        adds a host sync a step."""
        self._check_init()
        return _fit_with_plan(self, self._dispatch_batch, data, labels,
                              epochs, batch_size, steps_per_dispatch,
                              device_prefetch, sync_every,
                              checkpointer=checkpointer,
                              checkpoint_every=checkpoint_every,
                              resume=resume, stop_fn=stop_fn,
                              preemption=preemption)

    def _start_steps(self):
        """Fill the device step counter from `iteration` (a fill, no
        copy), in place once it exists, so a graph captured in an earlier
        fit reads the live counter: every fit starts there, so a loaded
        or resumed net carries on with Adam's bias correction and a
        schedule's rate where it stopped."""
        if self._step_t is None:
            self._step_t = torch.zeros((), dtype=torch.int64,
                                       device=self.device)
        self._step_t.fill_(self.iteration)

    def _state_addresses(self) -> tuple:
        """Where a train step reads and writes in place: a graph
        captured over other addresses is captured anew."""
        return tuple(t.data_ptr() for t in (
            *tree_leaves(self.params_tree),
            *tree_leaves(self.updater_state),
            *tree_leaves(self.state_tree), self._step_t))

    def _generators(self) -> tuple:
        return (self._rng,) if self.device.type == "cuda" else ()

    def _put_batch(self, ds: DataSet) -> DataSet:
        """A batch on the net's device: features and masks in the net's
        dtype, floating labels as float32, integer labels as int64."""
        dev = self.device
        return DataSet(_to_device(ds.features, self.dtype, dev),
                       _to_device(ds.labels, None, dev),
                       _to_device(ds.features_mask, self.dtype, dev),
                       _to_device(ds.labels_mask, self.dtype, dev))

    def _check_input(self, x, any_length: bool = False):
        """Raise ValueError unless `x` fits the configured input type;
        `any_length` (stepping) checks a sequence's feature width only."""
        it = self.conf.input_type
        if it is None:
            return
        expect = it.shape(int(x.shape[0]))
        if it.kind == "rnn" and (it.timesteps is None or any_length):
            ok = x.ndim == 3 and x.shape[-1] == it.size
        else:
            ok = tuple(x.shape) == tuple(expect)
        if not ok:
            raise ValueError(
                f"Input shape {tuple(x.shape)} does not match configured "
                f"{it!r} (expected {tuple(expect)} for batch={x.shape[0]})")

    def _on_device(self, ds: DataSet) -> DataSet:
        if not isinstance(ds.features, torch.Tensor) or \
                ds.features.device != self.device:
            ds = self._put_batch(ds)
        self.last_batch_size = ds.num_examples()
        self.last_seq_len = (int(ds.features.shape[1])
                             if ds.features.ndim == 3 else None)
        return ds

    def _dispatch_batch(self, ds: DataSet):
        if self.conf.optimization_algo != "stochastic_gradient_descent":
            return self._fit_solver(ds)
        if self.conf.tbptt_fwd_length > 0 and ds.features.ndim == 3:
            return self._fit_tbptt(ds)
        return self._fit_batch(ds)

    def _fit_solver(self, ds):
        """One batch under the configured full-batch solver; returns the
        final loss on the device (shared with `ComputationGraph`)."""
        from deeplearning4j_tpu_torch.optim.solvers import fit_with_solver

        ds = self._on_device(ds)
        self._check_batch(ds)
        self._note_features(ds)
        self.fit_stats["eager_steps"] += 1
        return fit_with_solver(self, *self._batch_fields(ds))

    def _solver_loss(self, params, states, fields):
        """The deterministic train-mode loss (no dropout) a solver
        minimizes: (loss, new states) of `params` on one batch's
        fields."""
        features, labels, fmask, lmask = fields
        return self._loss(params, features, labels, fmask, lmask, None,
                          train=True, states=states)

    def _solver_finish(self, fields, passes: int, loss) -> None:
        """After a solver run has copied its parameters into
        `params_tree`: `passes` train-mode forwards at them refresh the
        stateful layers' running statistics, written back in place (the
        JAX package's loop), and the score becomes `loss` (shared with
        `ComputationGraph`)."""
        if self._stateful and self.state_tree:
            cur = self.state_tree
            with torch.no_grad():
                for _ in range(passes):
                    _, ns = self._solver_loss(self.params_tree, cur, fields)
                    cur = {n: (ns[n] if n in self._stateful and n in ns
                               else cur[n]) for n in cur}
            _copy_states(self.state_tree, cur)
        self._loss_tracker.set(loss)

    def _check_batch(self, ds: DataSet) -> None:
        self._check_input(ds.features)

    def _note_features(self, ds: DataSet) -> None:
        """Keep the batch's features (on the device) for the listeners
        that run a forward of their own (`ui.StatsListener`'s activation
        statistics, `ConvolutionalIterationListener`): the JAX package's
        `_last_features`, set by its per-step and K-step dispatch."""
        self._last_features = ds.features

    def _fit_batch(self, ds: DataSet):
        """One train step on one batch; returns the device loss."""
        ds = self._on_device(ds)
        self._check_batch(ds)
        self._note_features(ds)
        self.fit_stats["eager_steps"] += 1
        return self._train_step(*self._batch_fields(ds))

    @staticmethod
    def _batch_fields(ds: DataSet) -> tuple:
        """A batch as `_train_step`'s arguments."""
        return ds.features, ds.labels, ds.features_mask, ds.labels_mask

    def _train_step(self, features, labels, fmask, lmask):
        """The train step over the net's own trees, all in place: the
        new running statistics are copied into `state_tree` and the step
        counter advances where it lies. Returns the device loss."""
        _, _, persist, loss, _ = self.make_step_fn()(
            self.params_tree, self.updater_state, self.state_tree,
            self._step_t, features, labels, fmask, lmask, self._rng, None)
        _copy_states(self.state_tree, persist)
        self._step_t.add_(1)
        return loss

    def _can_fuse(self, ds: DataSet) -> bool:
        """Fused dispatch takes the plain SGD step: a 3-D batch under
        truncated BPTT runs per step (its chunks hand carries on)."""
        return (self.conf.optimization_algo == "stochastic_gradient_descent"
                and not (self.conf.tbptt_fwd_length > 0
                         and ds.features.ndim == 3))

    def _fused_dispatch(self, batches: List[DataSet]):
        """K same-shape batches as ONE dispatch (JAX's `lax.scan` of the
        step; `ComputationGraph` shares it): on the card one CUDA graph
        of K whole train steps, cached by K and the batches' shapes,
        dtypes and mask presence. The batches are stacked into the
        graph's static [K, ...] buffers and step j reads slice j. The
        first window of a key runs its K steps eagerly (the warm-up),
        then is captured; later windows replay. Returns the (K,) device
        losses."""
        batches = [self._on_device(b) for b in batches]
        self._check_batch(batches[0])
        self._note_features(batches[-1])
        k = len(batches)
        if not self.cuda_graphs:
            return torch.stack([self._fit_batch(b) for b in batches])

        def k_steps(*stacked):
            return torch.stack([
                self._train_step(*(_field_at(a, j) for a in stacked))
                for j in range(k)])

        losses = self._graphs.run(
            ("fit", k), k_steps,
            _field_lists([self._batch_fields(b) for b in batches]),
            addresses=self._state_addresses(),
            generators=self._generators())
        if self._graphs.replayed:
            self.fit_stats["graph_windows"] += 1
        else:
            self.fit_stats["eager_steps"] += k
        return losses

    def _fit_tbptt(self, ds: DataSet):
        """Truncated BPTT on one batch: time is cut into chunks of
        `tbptt_fwd_length`, each chunk is one train step, and the
        recurrent carries are handed from chunk to chunk detached. When
        `tbptt_back_length` is shorter, the head of each chunk only
        advances the carries (no gradient, no update) and the step covers
        the last `back` timesteps. Every chunk sees the same step count:
        the iteration, and so Adam's bias correction and a schedule's
        rate, advance once a batch. Returns the mean of the chunk losses,
        taken on the device."""
        L = self.conf.tbptt_fwd_length
        Lb = min(self.conf.tbptt_back_length or L, L)
        ds = self._on_device(ds)
        self._check_input(ds.features)
        if ds.labels is None or ds.labels.ndim != 3:
            raise ValueError(
                "Truncated BPTT requires per-timestep (3-D [batch, time, "
                "n_out]) labels; for sequence-level labels use "
                "tbptt_fwd_length=0")
        T = ds.features.shape[1]
        step_fn = self.make_step_fn(tbptt=True)
        carries, losses = {}, []
        for lo in range(0, T, L):
            hi = min(lo + L, T)
            t_lo = lo
            if Lb < hi - lo:
                t_lo = hi - Lb
                carries = self._advance_carries(
                    ds.features[:, lo:t_lo],
                    None if ds.features_mask is None
                    else ds.features_mask[:, lo:t_lo], carries)

            def sl(a):
                return None if a is None else a[:, t_lo:hi]

            _, _, persist, loss, carries = step_fn(
                self.params_tree, self.updater_state, self.state_tree,
                self._step_t, sl(ds.features), sl(ds.labels),
                sl(ds.features_mask), sl(ds.labels_mask), self._rng,
                carries or None)
            _copy_states(self.state_tree, persist)
            losses.append(loss)
        self._step_t.add_(1)
        self.fit_stats["eager_steps"] += 1
        return torch.stack(losses).mean()

    @torch.no_grad()
    def _advance_carries(self, feats, fmask, carries):
        """Gradient-free forward that only moves the recurrent carries
        along: the no-update head of a fwd > back tBPTT chunk."""
        _, new_states = self._forward(self.params_tree, feats, fmask=fmask,
                                      carries=carries or None)
        return {n: new_states[n] for n in self._rnn_layer_names}

    @torch.no_grad()
    def score(self, data, labels=None) -> float:
        """Mean loss (score + regularization) on data, no dropout
        (reference: `score(DataSet)`)."""
        self._check_init()
        ds = data if isinstance(data, DataSet) else DataSet(
            np.asarray(data), np.asarray(labels))
        ds = self._put_batch(ds)
        loss, _ = self._loss(self.params_tree, ds.features, ds.labels,
                             ds.features_mask, ds.labels_mask, None,
                             train=False)
        return float(loss)

    @torch.no_grad()
    def output(self, x) -> torch.Tensor:
        """Forward to final activations (full-context, no carries)."""
        self._check_init()
        x = _as_tensor(x, self.dtype, self.device)
        self._check_input(x)
        y, _ = self._forward(self.params_tree, x)
        return y

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions (int32). Reference:
        `predict(INDArray)`."""
        return _argmax_i32(self.output(x)).cpu().numpy()

    def _output_host(self, x) -> np.ndarray:
        return _host(self.output(x))

    def evaluate(self, iterator):
        """Classification metrics over an iterator of DataSets.
        Reference: `MultiLayerNetwork.evaluate(DataSetIterator)`.

        For plain per-example labels the argmax runs ON THE DEVICE and
        only int32 class indices cross to the host; masked or
        time-series labels take the full output through `output_fn`,
        which the Evaluation flattens on the host."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        self._check_init()
        width = getattr(self.layers[-1], "n_out", None)
        return Evaluation().evaluate_iterator(
            iterator, output_fn=self._output_host,
            predict_indices_fn=lambda feats: (self.predict(feats), width))

    def evaluate_regression(self, iterator):
        """Reference: `MultiLayerNetwork.evaluateRegression`."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        from deeplearning4j_tpu_torch.eval.regression import (
            RegressionEvaluation,
        )

        self._check_init()
        return Evaluation.run_evaluation(RegressionEvaluation(), iterator,
                                         self._output_host)

    def evaluate_roc(self, iterator, threshold_steps: int = 0):
        """Binary ROC. Reference: `evaluateROC`."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        from deeplearning4j_tpu_torch.eval.roc import ROC

        self._check_init()
        return Evaluation.run_evaluation(ROC(threshold_steps), iterator,
                                         self._output_host)

    def evaluate_roc_multi_class(self, iterator):
        """One-vs-all ROC per class. Reference: `evaluateROCMultiClass`."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        from deeplearning4j_tpu_torch.eval.roc import ROCMultiClass

        self._check_init()
        return Evaluation.run_evaluation(ROCMultiClass(), iterator,
                                         self._output_host)

    def num_params(self) -> int:
        self._check_init()
        return sum(p.numel() for p in tree_leaves(self.params_tree))

    @torch.no_grad()
    def feed_forward(self, x, train: bool = False) -> List[torch.Tensor]:
        """Every layer's activations, in order (reference:
        `feedForward`); no dropout."""
        self._check_init()
        acts: List[torch.Tensor] = []
        self._forward(self.params_tree, _as_tensor(x, self.dtype, self.device),
                      train=train, acts=acts)
        return acts

    # ------------------------------------------------------ pretraining
    def pretrain(self, data, *, epochs: int = 1, batch_size: int = 32):
        """Greedy layerwise unsupervised pretraining (reference:
        `pretrain`): each pretrainable layer in order (AutoEncoder, RBM,
        VAE) is trained for `epochs` passes over `data` (features only)
        on its `reconstruction_score` of its input, the batch featurized
        through the layers before it and their preprocessors in eval
        mode. One gradient a batch, applied by the layer's own updater
        (`_grad_and_update` with a one-layer group: one B1a launch a step
        under Adam, one B1b under Nesterovs), from fresh optimizer state
        and a step count from 0, as in JAX; a frozen layer is skipped.
        The losses stay on the device, in `pretrain_losses[layer name]`.
        Returns the net."""
        self._check_init()
        it = as_iterator(data, None, batch_size)
        self.pretrain_losses = {}
        for idx, layer in enumerate(self.layers):
            if not layer.is_pretrainable:
                continue

            def featurize(feats, idx=idx):
                x, _ = self._forward(self.params_tree, feats, stop=idx)
                if idx in self.conf.preprocessors:
                    x = self.conf.preprocessors[idx].apply(x)
                return x

            self._pretrain_layer(layer, layer.name,
                                 self._layer_updaters[layer.name], featurize,
                                 it, epochs, lambda ds: ds.features)
        return self

    def _pretrain_layer(self, layer, name: str, updater: Updater, featurize,
                        it, epochs: int, features_of):
        """`pretrain`'s loop for one layer (or layer vertex) `name` under
        its `updater`; `featurize(batch features) -> its input`,
        `features_of(batch on the device)` picks what `featurize`
        reads."""
        if isinstance(updater, NoOp):
            return
        params = {name: self.params_tree[name]}
        opt = {name: updater.init(params[name])}
        step = torch.zeros((), dtype=torch.int64, device=self.device)
        losses = self.pretrain_losses.setdefault(name, [])
        for _ in range(epochs):
            for ds in it:
                with torch.no_grad():
                    x = featurize(features_of(self._put_batch(ds)))
                loss, _ = _grad_and_update(
                    lambda live: (layer.reconstruction_score(
                        live[name], x, rng=self._rng), None),
                    params, opt, [(updater, [name])], "none", 1.0, step)
                losses.append(loss)
                step.add_(1)

    # ------------------------------------------------------ param views
    def params(self) -> torch.Tensor:
        """Every parameter in one flat vector, on the net's device
        (reference: `Model.params()`), in the JAX package's order (keys
        sorted, depth first): equal element for element to the JAX net's
        `params()` on the same weights."""
        self._check_init()
        return flatten_params(self.params_tree)[0]

    def set_params(self, flat) -> None:
        """Load a flat vector (a tensor or an array, `params()`'s order)
        by copying into the net's tensors in place: a captured CUDA graph
        keeps reading the live weights."""
        self._check_init()
        if not isinstance(flat, torch.Tensor):
            flat = torch.tensor(np.asarray(flat))
        copy_flat_(self.params_tree, flat.to(self.device))

    def set_listeners(self, *listeners: TrainingListener) -> None:
        self.listeners = list(listeners)

    def add_listener(self, listener: TrainingListener) -> None:
        self.listeners.append(listener)

    def clone(self) -> "MultiLayerNetwork":
        """A new net on the same configuration and device with copies of
        the parameters and layer states (reference: `clone()`)."""
        self._check_init()
        other = type(self)(self.conf, device=self.device).init()
        with torch.no_grad():
            tree_map(lambda d, s: d.copy_(s), other.params_tree,
                     self.params_tree)
            _copy_states(other.state_tree, self.state_tree)
        return other

    # ------------------------------------------------ stateful stepping
    @property
    def _rnn_layer_names(self):
        """Layers that carry RNN state (tBPTT / rnn_time_step)."""
        return [l.name for l in self.layers if _is_recurrent(l)]

    @torch.no_grad()
    def rnn_time_step(self, x) -> torch.Tensor:
        """Stateful inference over one or more timesteps; the carries
        persist across calls (reference: `rnnTimeStep`). `x` is
        [B, T, F], or [B, F] for one step. Attention stacks step the same
        way: on the first call every layer with `decode_carry` is
        validated (causal attention only), then seeded with a lockstep
        carry (a KV cache and a 0-d position), so a transformer
        generates token by token without re-running its prefix. Before
        each step the host-side budget (`_check_decode_budget`) refuses
        one that would run past the smallest cache or position limit;
        the decode position advances only after a step that succeeded.
        The whole read-step-write runs under the decode-state lock.

        One graph per (x's shape and dtype, carries present), as JAX
        jits one program per pair (`_stateful_step`)."""
        self._check_init()
        x = _as_tensor(x, self.dtype, self.device)
        if x.ndim == 2:
            x = x[:, None, :]
        self._check_input(x, any_length=True)
        decode = [l for l in self.layers if hasattr(l, "decode_carry")]
        names = self._rnn_layer_names + [l.name for l in decode]
        st = self._decode_state
        with st.lock():
            if not st.carries and decode:
                _validate_causal_decode((l.name, l) for l in decode)
                st.seed({l.name: l.decode_carry(x.shape[0], self.dtype,
                                                device=self.device)
                         for l in decode})
            if decode:
                _check_decode_budget(st.pos, decode, x.shape[1])

            def fwd(xs, c):
                out, new_states = self._forward(self.params_tree, xs[0],
                                                carries=c)
                return out, {n: new_states[n] for n in names}

            out, new = _stateful_step(self, fwd, (x,), st.carries or None)
            # advance only after a successful step
            st.update(new, advance=x.shape[1] if decode else 0)
        return out

    def rnn_clear_previous_state(self) -> None:
        """Drop the carries and the decode position: the next call
        starts from zeros."""
        self._decode_state.clear()

    def rnn_reorder_state(self, idx) -> None:
        """Reorder (or expand) the stepping carries along the batch
        dimension: a beam search gathers each beam's KV cache and h/c
        rows to follow its parent (`_reorder_carries`). Every carry leaf
        but a 0-d position is batch-leading."""
        self._decode_state.reorder(
            lambda c: _reorder_carries(c, idx, self.device))

    # ------------------------------------------- slot-indexed sessions
    def decode_limit(self) -> Optional[int]:
        """Smallest non-rolling cache/position bound across decode layers
        (None = unbounded): the session manager's budget ceiling."""
        return _decode_limit(l for l in self.layers
                             if hasattr(l, "decode_carry"))

    def session_carries(self, slots: int, kv_dtype: Optional[str] = None,
                        page_len: Optional[int] = None,
                        pages: Optional[int] = None, device=None):
        """Per-slot decode carries for `slots` sessions on the net's
        device (or `device`: "meta" gives the tree's shapes and dtypes
        without memory): the KVSlotPool's backing tree. Attention layers
        get per-slot positions and caches, recurrent layers their h/c
        carries [slots, n] (held by the step's mask, so a padded chunk or
        an inactive lane keeps them). `page_len` switches every attention
        cache to the paged layout, which needs a uniform `max_cache`
        across decode layers (one logical page id = one physical row in
        every layer's pool); `pages` defaults to `slots * max_cache /
        page_len`."""
        self._check_init()
        decode = [l for l in self.layers if hasattr(l, "decode_carry")]
        rnn = [l for l in self.layers if _is_recurrent(l)]
        if not decode and not rnn:
            raise ValueError(
                "session_carries needs at least one stateful decode "
                "layer (attention decode_carry or recurrent carry)")
        for l in rnn:
            if isinstance(l, (Bidirectional, GravesBidirectionalLSTM,
                              LastTimeStep)):
                raise ValueError(
                    f"session decoding is causal left-to-right; layer "
                    f"{l.name!r} ({type(l).__name__}) cannot stream")
        for l in decode:
            if not getattr(l, "causal", True):
                raise ValueError(
                    f"session decoding requires causal attention; layer "
                    f"{l.name!r} is non-causal")
        if page_len is not None:
            caches = {l.max_cache for l in decode if hasattr(l, "max_cache")}
            if len(caches) > 1:
                raise ValueError(
                    f"paged session carries need a uniform max_cache "
                    f"across decode layers; got {sorted(caches)}")
            if pages is None and caches:
                pages = slots * (next(iter(caches)) // page_len)
        dev = device or self.device
        carries = {l.name: l.decode_carry(slots, self.dtype, per_slot=True,
                                          kv_dtype=kv_dtype,
                                          page_len=page_len, pages=pages,
                                          device=dev)
                   for l in decode}
        for l in rnn:
            carries[l.name] = l.initial_carry(slots, self.dtype, device=dev)
        return carries

    @property
    def _session_layer_names(self):
        """Layers whose state a session step carries: the recurrent ones
        and the attention decode layers."""
        return [l.name for l in self.layers
                if _is_recurrent(l) or hasattr(l, "decode_carry")]

    def spec_decode_capable(self) -> bool:
        """Every carry position-addressed, so a rejected token is
        un-written by rewinding `pos`: recurrent h/c carries hold state
        that cannot be un-written, and rolling rings misattribute stale
        slots, so either disqualifies the net (the rewind condition
        paged prefix caching shares)."""
        if self._rnn_layer_names:
            return False
        decode = [l for l in self.layers if hasattr(l, "decode_carry")]
        return bool(decode) and not any(
            getattr(l, "rolling_cache", False) for l in decode)

    def prefix_cache_capable(self) -> bool:
        """Can the session carries run paged? No recurrent carries, no
        rolling rings and one uniform max_cache across decode layers."""
        if not self.spec_decode_capable():
            return False
        caches = {l.max_cache for l in self.layers
                  if hasattr(l, "decode_carry") and hasattr(l, "max_cache")}
        return len(caches) == 1

    @staticmethod
    def _lane_merge(old_tree, new_tree, act):
        """Revert inactive lanes' position leaves (`pos`). Every other
        leaf passes through: the KV caches (slot pools and paged pools
        alike) were updated in place and an inactive lane never wrote
        them — its tokens are masked out of the cache write — a page
        table never changes during a step, and a recurrent layer held an
        inactive lane's h/c, because `active` is folded into the mask it
        sees."""
        def merge(old, new):
            if isinstance(new, dict):
                return {k: (torch.where(act, new[k], old[k]) if k == "pos"
                            else merge(old[k], new[k]))
                        for k in new}
            return new
        return merge(old_tree, new_tree)

    @torch.no_grad()
    def session_step(self, x, carries, *, active=None, valid=None):
        """One slot-indexed step: `x` [S, T, F] (T = the chunk bucket),
        `valid` an optional [S, T] prefix mask, `active` an optional [S]
        bool. Inactive lanes compute but do not write: `active` is folded
        into the mask (the caches update in place and the recurrent
        layers hold the lane's h/c, as a padded position of `valid`
        holds them) and their positions are reverted. The new h/c are
        copied into `carries`' own tensors (`_write_back`), so a pool's
        carries keep their addresses. Returns (out, new_carries)."""
        self._check_init()
        dev = self.device
        x = _as_tensor(x, self.dtype, dev)
        if x.ndim == 2:
            x = x[:, None, :]
        S, T = x.shape[0], x.shape[1]
        fmask = None if valid is None else _as_tensor(valid, self.dtype, dev)
        act = None
        if active is not None:
            act = _as_tensor(active, torch.bool, dev)
            base = fmask if fmask is not None else torch.ones(
                (S, T), dtype=self.dtype, device=dev)
            fmask = base * act[:, None].to(self.dtype)
        out, new_states = self._forward(self.params_tree, x, fmask=fmask,
                                        carries=carries)
        new = {n: new_states[n] for n in self._session_layer_names}
        if act is not None:
            new = self._lane_merge(carries, new, act)
        return out, _write_back(carries, new)

    @torch.no_grad()
    def session_decode_window(self, tokens, carries, *, active, k,
                              temperature, top_k, top_p, greedy,
                              keys, offsets, budgets, eos_ids):
        """K decode steps in one call: each step forwards every active
        lane's token, samples the next one on the device
        (`utils.sampling.sample_token_lanes`), feeds it back, and retires
        a lane AT its EOS token or at its budget through the active mask.
        No host read inside: the caller reads the packed result once per
        window.

        Arguments are per lane (S = slots): `tokens` i32[S] first inputs;
        `active` bool[S]; sampling knobs f32/i32/f32/bool[S]; `keys`
        u32[S, 2] per-lane seed words — token i of a lane always draws
        with the counter `offsets + i`, so streams are invariant to K and
        to co-batching; `offsets` i32[S] tokens already generated;
        `budgets` i32[S] tokens left; `eos_ids` i32[S] (-1 = none).

        One graph replay a window (`utils/cuda_graphs`), keyed by k, S,
        the carries' layout and the addresses of the KV caches and the
        parameters, which the graph reads and writes where they lie (a
        pool rebuilt elsewhere is captured anew). The per-lane arguments
        go to the card as one packed copy; the carries' `pos` and
        `page_table` leaves are copied into the graph's buffers, the
        recurrent h/c are written back into the caller's tensors, and
        the returned carries are the caller's tree with new `pos`
        leaves. With `cuda_graphs` off, the same K steps run eagerly.

        Returns (tokens i32[S, k], emitted bool[S, k], new_carries);
        positions not emitted hold -1."""
        self._check_init()
        k = _window_k(k, "window length")
        keys = np.asarray(keys).astype(np.int64)
        lanes = (tokens, active, temperature, top_k, top_p, greedy,
                 keys[:, 0], keys[:, 1], offsets, budgets, eos_ids)
        (toks, emits), new = self._run_window(
            "decode_window", k, self._window,
            _lane_pack(lanes, self.device), carries)
        return toks, emits, new

    def _run_window(self, kind: str, k: int, body, packed, carries,
                    extra: tuple = ()):
        """`body(packed, carries, k, *extra)` -> (outputs, new carries)
        as one graph replay keyed (kind, k), S, the carries' layout and
        the addresses of the KV caches and the parameters, which the
        graph reads and writes where they lie (a pool rebuilt elsewhere
        is captured anew). The carries' `pos` and `page_table` leaves are
        copied into the graph's buffers; the recurrent h/c, which a step
        builds anew, are copied back into the caller's tensors inside the
        window (`_write_back`), so a replay reads and advances the pool's
        own carries; the returned carries are the caller's tree with the
        new `pos` leaves. With `cuda_graphs` off, `body` runs eagerly,
        with the same write-back."""
        if not self.cuda_graphs:
            out, new = body(packed, carries, k, *extra)
            return out, _write_back(carries, new)
        # by path: a step returns a layer's carry keys in another order
        leaves = sorted(_carry_leaves(carries), key=lambda pa: pa[0])
        small = [(path, a) for path, a in leaves
                 if path[-1] in _GRAPH_LEAVES]
        in_place = tuple(a.data_ptr() for path, a in leaves
                         if path[-1] not in _GRAPH_LEAVES)
        pos_paths = [p for p, _ in small if p[-1] == "pos"]

        def window(packed, leaves, *extra):
            c = _with_leaves(carries, dict(zip((p for p, _ in small),
                                               leaves)))
            out, new = body(packed, c, k, *extra)
            new = _write_back(c, new)
            return out, [_leaf_at(new, p) for p in pos_paths]

        out, pos = self._graphs.run(
            (kind, k), window,
            (packed, tuple(a for _, a in small), *extra),
            addresses=in_place + tuple(
                t.data_ptr() for t in tree_leaves(self.params_tree)))
        return out, _with_leaves(carries, dict(zip(pos_paths, pos)))

    def _encode_ids(self, tok: torch.Tensor) -> torch.Tensor:
        """Token ids [S] or [S, T] as the first layer's input [S, T, F]:
        the id itself for an embedding layer, else one-hot."""
        if tok.ndim == 1:
            tok = tok[:, None]
        if isinstance(self.layers[0], EmbeddingSequenceLayer):
            return tok[:, :, None].to(self.dtype)
        return torch.nn.functional.one_hot(
            tok, int(self.layers[0].n_in)).to(self.dtype)

    def _window(self, packed, carries, k: int):
        """The K steps of `session_decode_window` over its per-lane
        arguments packed as float64 rows (every value exact)."""
        from deeplearning4j_tpu_torch.utils import sampling as _sampling

        dt = self.dtype
        (tok, act, temps, tks, tps, grdy, key0, key1, offs, buds,
         eos) = packed
        tok = tok.to(torch.int64)
        act = act.to(torch.bool)
        temps, tps = temps.to(torch.float32), tps.to(torch.float32)
        tks, grdy = tks.to(torch.int64), grdy.to(torch.bool)
        keys_ = torch.stack((key0, key1), dim=1).to(torch.int64)
        offs, buds, eos = (a.to(torch.int64) for a in (offs, buds, eos))
        S = tok.shape[0]
        n = torch.zeros((S,), dtype=torch.int64, device=tok.device)
        toks_out = torch.full((S, k), -1, dtype=torch.int32,
                              device=tok.device)
        emits = torch.zeros((S, k), dtype=torch.bool, device=tok.device)
        c = carries
        for i in range(k):
            val = act.to(dt)[:, None]
            out, new_states = self._forward(self.params_tree,
                                            self._encode_ids(tok),
                                            fmask=val, carries=c)
            new = {nm: new_states[nm] for nm in self._session_layer_names}
            c = self._lane_merge(c, new, act)
            nxt = _sampling.sample_token_lanes(
                out[:, -1, :], temps, tks, tps, grdy, keys_, offs + n)
            emit = act
            n2 = n + emit.to(torch.int64)
            finished = emit & ((nxt == eos) | (n2 >= buds))
            toks_out[:, i] = torch.where(emit, nxt, -1).to(torch.int32)
            emits[:, i] = emit
            tok = torch.where(emit, nxt, tok)
            act = act & ~finished
            n = n2
        return (toks_out, emits), c

    # ------------------------------------------- speculative decoding
    #
    # The draft/target window pair shares one invariant: every carry is
    # position-addressed (linear caches and per-slot positions:
    # `spec_decode_capable`), so a rejected token is un-written by
    # rewinding `pos`: entries past it are invisible and the next write
    # overwrites them. For a lane that accepted n_acc of k drafts and
    # emitted n = n_acc + 1 tokens:
    #   target: the verify writes k+1 entries, pos snaps back to old + n;
    #   draft:  the propose wrote k entries ([t0, d_1..d_{k-1}]); the next
    #           window enters with rewind = max(k - n, 0), and after full
    #           acceptance (n = k+1) it first writes d_k's entry, which it
    #           never wrote (pre_tokens / pre_valid).
    # The acceptance and residual draws come from streams of their own
    # (salts), independent of both models' sampling draws: the rejection
    # rule assumes the acceptance coin is independent of the proposal.
    _SPEC_U_SALT = 0x5EC0DE
    _SPEC_R_SALT = 0xDEC0DE5

    @staticmethod
    def _pos_rewind(carries, delta):
        """Subtract `delta` [S] from every per-slot `pos` leaf (every
        other leaf is the same tensor)."""
        return {kk: (MultiLayerNetwork._pos_rewind(v, delta)
                     if isinstance(v, dict)
                     else v - delta.to(v.dtype) if kk == "pos" else v)
                for kk, v in carries.items()}

    @torch.no_grad()
    def session_propose_window(self, tokens, carries, *, active, k,
                               temperature, top_k, top_p, greedy, keys,
                               offsets, rewind, pre_tokens, pre_valid):
        """The draft half of a speculative window: k decode steps in one
        call, each proposal sampled on the device from the warped
        distribution it records (the q the rejection rule needs). On
        entry `rewind` [S] is subtracted from the active lanes' positions
        and, where `pre_valid`, one masked catch-up step writes
        `pre_tokens`' entry first. Proposals draw from the same stream as
        the plain window (counter `offsets + i`); there is no EOS or
        budget cut here: the verify applies them.

        One graph replay a window, keyed ("propose_window", k), as
        `session_decode_window` is. Returns (draft_tokens i32[S, k],
        draft_probs f32[S, k, V], new_carries)."""
        self._check_init()
        k = _window_k(k, "draft window")
        keys = np.asarray(keys).astype(np.int64)
        lanes = (tokens, active, temperature, top_k, top_p, greedy,
                 keys[:, 0], keys[:, 1], offsets, rewind, pre_tokens,
                 pre_valid)
        (toks, probs), new = self._run_window(
            "propose_window", k, self._propose,
            _lane_pack(lanes, self.device), carries)
        return toks, probs, new

    def _propose(self, packed, carries, k: int):
        from deeplearning4j_tpu_torch.utils import sampling as _sampling

        dt = self.dtype
        (tok, act, temps, tks, tps, grdy, key0, key1, offs, rew, ptok,
         pval) = packed
        tok, ptok = tok.to(torch.int64), ptok.to(torch.int64)
        act, pval, grdy = (a.to(torch.bool) for a in (act, pval, grdy))
        temps, tps = temps.to(torch.float32), tps.to(torch.float32)
        tks, offs = tks.to(torch.int64), offs.to(torch.int64)
        keys_ = torch.stack((key0, key1), dim=1).to(torch.int64)
        names = self._session_layer_names
        c = self._pos_rewind(carries, torch.where(act, rew, 0))
        cu = act & pval
        _, st = self._forward(self.params_tree, self._encode_ids(ptok),
                              fmask=cu.to(dt)[:, None], carries=c)
        c = self._lane_merge(c, {nm: st[nm] for nm in names}, cu)
        toks, pws = [], []
        for i in range(k):
            out, st = self._forward(self.params_tree, self._encode_ids(tok),
                                    fmask=act.to(dt)[:, None], carries=c)
            c = self._lane_merge(c, {nm: st[nm] for nm in names}, act)
            p = out[:, -1, :].to(torch.float32)
            pw = _sampling.warp_probs_lanes(p, temps, tks, tps)
            drawn = _sampling.draw_lanes(
                pw, _sampling.lane_uniforms(keys_, offs + i))
            nxt = torch.where(grdy, torch.argmax(p, dim=-1), drawn)
            toks.append(nxt)
            pws.append(pw)
            tok = torch.where(act, nxt, tok)
        return (torch.stack(toks, dim=1).to(torch.int32),
                torch.stack(pws, dim=1)), c

    @torch.no_grad()
    def session_verify_window(self, tokens, carries, *, active, k,
                              draft_tokens, draft_probs, temperature,
                              top_k, top_p, greedy, keys, offsets,
                              budgets, eos_ids):
        """The target half of a speculative window: one chunked forward
        over [t0, d_1..d_k] scores every draft position, accept/reject
        runs on the device (`utils.sampling.spec_accept_lanes`), the EOS
        and budget prefix cuts apply (a lane stops AT its EOS token), and
        the positions snap back to old + n_emit, which rewinds the
        rejected entries. An active lane emits n_acc + 1 tokens unless
        cut.

        One graph replay a window, keyed ("verify_window", k): the
        per-lane arguments go in as one packed copy, `draft_tokens` and
        `draft_probs` (the propose window's outputs, on the device) are
        copied into the graph's buffers. Returns (packed i32[S, k+4],
        new_carries), rows `[n_emit, n_acc, last_draft, tok_0..tok_k]`
        (-1 past n_emit): one tensor, so the caller's one host read
        covers counts, the catch-up token and the emissions. `n_acc` is
        the verdict before the cuts, so that a caller can count the
        accepted drafts actually emitted, min(n_acc, n_emit)."""
        self._check_init()
        k = _window_k(k, "verify window")
        keys = np.asarray(keys).astype(np.int64)
        lanes = (tokens, active, temperature, top_k, top_p, greedy,
                 keys[:, 0], keys[:, 1], offsets, budgets, eos_ids)
        dev = self.device
        d_toks = _as_tensor(draft_tokens, torch.int32, dev)
        d_probs = _as_tensor(draft_probs, torch.float32, dev)
        return self._run_window(
            "verify_window", k, self._verify, _lane_pack(lanes, dev),
            carries, (d_toks, d_probs))

    def _verify(self, packed, carries, k: int, d_toks, q_pw):
        from deeplearning4j_tpu_torch.utils import sampling as _sampling

        (tok, act, temps, tks, tps, grdy, key0, key1, offs, buds,
         eos) = packed
        tok = tok.to(torch.int64)
        act, grdy = act.to(torch.bool), grdy.to(torch.bool)
        temps, tps = temps.to(torch.float32), tps.to(torch.float32)
        tks = tks.to(torch.int64)
        offs, buds, eos = (a.to(torch.int64) for a in (offs, buds, eos))
        keys_ = torch.stack((key0, key1), dim=1).to(torch.int64)
        d = d_toks.to(torch.int64)
        S = tok.shape[0]
        chunk = torch.cat([tok[:, None], d], dim=1)              # [S, k+1]
        val = act.to(self.dtype)[:, None].expand(S, k + 1).contiguous()
        out, _ = self._forward(self.params_tree, self._encode_ids(chunk),
                               fmask=val, carries=carries)
        p_raw = out.to(torch.float32)                            # [S, k+1, V]
        V = p_raw.shape[-1]
        rep = k + 1
        pw = _sampling.warp_probs_lanes(
            p_raw.reshape(S * rep, V), temps.repeat_interleave(rep),
            tks.repeat_interleave(rep),
            tps.repeat_interleave(rep)).reshape(S, rep, V)
        u = torch.stack([_sampling.lane_uniforms(keys_, offs + i,
                                                 self._SPEC_U_SALT)
                         for i in range(k)], dim=1)
        ru = _sampling.lane_uniforms(keys_, offs, self._SPEC_R_SALT)
        n_acc, extra = _sampling.spec_accept_lanes(p_raw, pw, q_pw, d, grdy,
                                                   u, ru)
        idx = torch.arange(k + 1, device=tok.device)[None, :]
        d_pad = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
        cand = torch.where(idx == n_acc[:, None], extra[:, None], d_pad)
        base = idx <= n_acc[:, None]
        eos_hit = base & (cand == eos[:, None]) & (eos[:, None] >= 0)
        prior_eos = torch.cumsum(eos_hit.to(torch.int64), dim=1) - \
            eos_hit.to(torch.int64)
        emitted = (base & (prior_eos == 0) & (idx < buds[:, None])
                   & act[:, None])
        n_emit = emitted.sum(dim=1)
        toks_out = torch.where(emitted, cand, -1)
        # the caches were written in place; the confirmed history is
        # old + n_emit for an active lane, old for the others
        new = self._pos_rewind(carries, -torch.where(act, n_emit, 0))
        rows = torch.cat([n_emit[:, None], n_acc[:, None], d[:, -1:],
                          toks_out], dim=1)
        return rows.to(torch.int32), new
