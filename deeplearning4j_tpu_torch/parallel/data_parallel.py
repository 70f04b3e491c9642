"""ParallelWrapper — data-parallel training over ranks (port of
`deeplearning4j_tpu/parallel/data_parallel.py`).

Reference parity: `parallelism/ParallelWrapper.java` (averaging with
frequency 1: an exact gradient mean every step). The JAX package runs
ONE sharded program over a mesh; the port runs one process a device
(a rank), each holding the whole model:

- Every rank reads the same global iterator. A partial batch is first
  padded to a multiple of the data size by repeating row 0 (JAX's
  `_pad_to_divisible`), then each rank takes its rows. So n ranks
  compute what JAX's wrapper computes on an n-device mesh.
- A step is the local forward and backward, then ONE all-reduce a dtype
  of the flattened gradients (and one of the loss) to the global mean,
  then the updater. Batch normalization's statistics span the data
  group: the step hands every batch-norm layer the group
  (`parallel.distributed.BatchStatsGroup`), so it normalizes by the
  mean and variance of the GLOBAL batch, as the sharded JAX step does.
- Replica-sharded moments (`shard_opt_state=True`, data size > 1,
  arXiv:2004.13336): each rank keeps only its slice of every moment
  that `MeshContext.moment_spec` splits, runs the updater — B1a/B1b
  through `ops/fused_update.leaf_plans` for Adam and Nesterovs — on its
  slice of each parameter and gradient, then the ranks all-gather the
  updated slices (one all-gather a dtype). A slice along dim 0 is a
  view of the parameter, updated in place; a slice along another dim
  is not contiguous, so it is staged in a tensor of the rank's own
  (copied in, updated, copied back). Leaves too small to split keep a
  whole moment on every rank and update whole.
- Parameter sharding rules (`param_rules`: FSDP's `fsdp_rules` on the
  data axis, tensor-parallel rules on another) are not ported: every
  rank keeps whole parameters, so the wrapper refuses them naming
  ROADMAP A6's second part rather than train with another memory
  contract than the rules ask for.
- `steps_per_dispatch=K` gives K 1's result: on one rank the window is
  the net's CUDA graph of K steps; with more ranks the K steps run
  eagerly (a collective inside a captured graph is not tried).

Every collective goes through `parallel/distributed.py` and lands in
commsmon's ledger; the first step of each batch signature is priced
into the watchdog (`owner_comm_totals`). Recovery (checkpoints,
resume, stop, preemption) is `optim/recovery.RecoveryPlan`, as in
`MultiLayerNetwork.fit`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    DataSetIterator, DevicePrefetchIterator, as_iterator,
)
from deeplearning4j_tpu_torch.observe import commsmon, donatemon
from deeplearning4j_tpu_torch.observe.watchdog import get_watchdog, owner_tag
from deeplearning4j_tpu_torch.optim.executor import (
    TrainingExecutor, batch_signature,
)
from deeplearning4j_tpu_torch.optim.recovery import (
    RecoveryPlan, run_with_recovery,
)
from deeplearning4j_tpu_torch.optim.updaters import tree_leaves, tree_map
from deeplearning4j_tpu_torch.parallel import distributed as pd
from deeplearning4j_tpu_torch.parallel.mesh import (
    AXIS_DATA, MeshContext, make_mesh,
)
from deeplearning4j_tpu_torch.parallel.sharding import ShardingRules

__all__ = ["ParallelWrapper"]


def _is_graph(net) -> bool:
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph,
    )
    return isinstance(net, ComputationGraph)


def _rows(a, idx):
    """Rows `idx` (an index array or a slice) of an array or tensor."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor) and not isinstance(idx, slice):
        return a[torch.as_tensor(idx, device=a.device)]
    return a[idx]


def _map_rows(ds, idx):
    if isinstance(ds, MultiDataSet):
        return MultiDataSet(
            [_rows(f, idx) for f in ds.features],
            [_rows(l, idx) for l in ds.labels],
            None if not ds.features_masks else
            [_rows(m, idx) for m in ds.features_masks],
            None if not ds.labels_masks else
            [_rows(m, idx) for m in ds.labels_masks])
    return DataSet(_rows(ds.features, idx), _rows(ds.labels, idx),
                   _rows(ds.features_mask, idx), _rows(ds.labels_mask, idx))


class _Rows(DataSetIterator):
    """Each batch of `base` through `fn` (a rank's rows)."""

    def __init__(self, base, fn):
        self._base, self._fn = base, fn

    def __iter__(self):
        return (self._fn(ds) for ds in iter(self._base))

    def reset(self):
        reset = getattr(self._base, "reset", None)
        if reset is not None:
            reset()


class _Leaf:
    """One parameter whose moments a rank holds a slice of: the split
    dim and every rank's [lo, hi) on it."""

    __slots__ = ("layer", "name", "dim", "bounds", "shape")

    def __init__(self, layer, name, dim, n, shape):
        self.layer, self.name, self.dim = layer, name, dim
        self.shape = tuple(shape)
        size = shape[dim] // n
        self.bounds = [(r * size, (r + 1) * size) for r in range(n)]

    def slice_of(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        lo, hi = self.bounds[rank]
        return t.narrow(self.dim, lo, hi - lo)


class _DataParallelStep:
    """The net's data-parallel hooks (`net._dp`), which the train step
    (`models/multilayer._grad_and_update`) calls: `reduce` turns a
    rank's loss and gradients into the global means, `slices` gives the
    updaters the rank's slices of the parameters and gradients, `gather`
    assembles every rank's updated slices; `stats_group` is what batch
    normalization reduces over."""

    def __init__(self, wrapper):
        spine = wrapper.spine
        self.group = spine.data_group
        self.n = spine.data_size
        self.rank = spine.data_rank
        self.stats_group = pd.BatchStatsGroup(self.group)
        self.leaves: Dict[Tuple[str, str], _Leaf] = {}
        self._slices: Dict[Tuple[str, str], torch.Tensor] = {}
        self._staged: List[Tuple[torch.Tensor, torch.Tensor]] = []

    # ------------------------------------------------------------ grads
    def reduce(self, loss, grads):
        """Global-mean loss and gradients: one all-reduce a gradient
        dtype over the flattened leaves, one for the loss."""
        leaves = tree_leaves(grads)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, g in enumerate(leaves):
            by_dtype.setdefault(g.dtype, []).append(i)
        out = list(leaves)
        for idx in by_dtype.values():
            flat = torch.cat([leaves[i].reshape(-1) for i in idx])
            pd.all_reduce(flat, op="avg", group=self.group, purpose="grads")
            off = 0
            for i in idx:
                n = leaves[i].numel()
                out[i] = flat[off:off + n].view(leaves[i].shape)
                off += n
        it = iter(out)
        new = tree_map(lambda _: next(it), grads)
        loss = pd.all_reduce(loss.clone(), op="avg",
                             group=self.group, purpose="loss")
        return loss, new

    # ----------------------------------------------------------- update
    def _param_slice(self, key, p: torch.Tensor) -> torch.Tensor:
        """The rank's slice of `p` as a tensor the updater updates in
        place: a view along dim 0, else a staged copy of its own (kept,
        so the fused update's launch plans stay valid), which `gather`
        copies back."""
        leaf = self.leaves[key]
        view = leaf.slice_of(p, self.rank)
        if leaf.dim == 0:
            kept = self._slices.get(key)
            if kept is None or kept.data_ptr() != view.data_ptr():
                kept = self._slices[key] = view
            return kept
        stage = self._slices.get(key)
        if stage is None or stage.shape != view.shape or \
                stage.dtype != view.dtype:
            stage = self._slices[key] = torch.empty_like(
                view, memory_format=torch.contiguous_format)
        stage.copy_(view)
        self._staged.append((view, stage))
        return stage

    def slices(self, params, grads):
        """(params, grads) of the trained layers with every split leaf
        replaced by the rank's slice; the other leaves stay whole."""
        p_sl, g_sl = {}, {}
        for n, sub in grads.items():
            p_sl[n], g_sl[n] = {}, {}
            for k, g in sub.items():
                p = params[n][k]
                if (n, k) in self.leaves:
                    p_sl[n][k] = self._param_slice((n, k), p)
                    g = self.leaves[(n, k)].slice_of(g, self.rank)
                    g_sl[n][k] = g if g.is_contiguous() else g.contiguous()
                else:
                    p_sl[n][k], g_sl[n][k] = p, g
        return p_sl, g_sl

    def gather(self, params) -> None:
        """The staged slices back into their parameters, then every
        rank's updated slices into every rank's parameters: one
        all-gather a dtype of the packed slices."""
        with torch.no_grad():
            for dst, src in self._staged:
                dst.copy_(src)
            self._staged.clear()
            self._all_gather(params)

    def _all_gather(self, params) -> None:
        by_dtype: Dict[torch.dtype, List[_Leaf]] = {}
        for key, leaf in self.leaves.items():
            p = params[leaf.layer][leaf.name]
            by_dtype.setdefault(p.dtype, []).append(leaf)
        for leaves in by_dtype.values():
            mine = [leaf.slice_of(params[leaf.layer][leaf.name], self.rank)
                    for leaf in leaves]
            send = torch.cat([m.reshape(-1) for m in mine])
            parts = pd.all_gather(send, group=self.group, purpose="params")
            for r, part in enumerate(parts):
                if r == self.rank:
                    continue
                off = 0
                for leaf, m in zip(leaves, mine):
                    n = m.numel()
                    leaf.slice_of(params[leaf.layer][leaf.name], r).copy_(
                        part[off:off + n].view(m.shape))
                    off += n


class ParallelWrapper:
    """Data-parallel trainer over a mesh of ranks.

    Kwargs mirror the reference Builder (`ParallelWrapper.java:562-715`)
    where meaningful: `prefetch_buffer` is the host iterator's prefetch
    depth; the number of workers is the mesh's data-axis size. Placement
    comes from ONE `MeshContext`: pass a prebuilt `spine`, or let the
    wrapper assemble one from `mesh` / `param_rules` / `batch_axis`.
    `shard_opt_state=False` keeps whole moments on every rank.
    `param_rules` that split a parameter raise NotImplementedError
    (ROADMAP A6, its second part)."""

    def __init__(self, net, *, mesh=None,
                 param_rules: Optional[ShardingRules] = None,
                 prefetch_buffer: int = 2,
                 batch_axis: str = AXIS_DATA,
                 spine: Optional[MeshContext] = None,
                 shard_opt_state: bool = True):
        if net.params_tree is None:
            raise RuntimeError("Model must be init()ed before wrapping")
        if getattr(net.conf, "optimization_algo",
                   "stochastic_gradient_descent") != \
                "stochastic_gradient_descent":
            raise ValueError(
                "ParallelWrapper trains with the sharded SGD step; "
                f"optimization_algo={net.conf.optimization_algo!r} is a "
                "full-batch single-device solver — fit the model directly")
        rules = spine.rules if spine is not None else param_rules
        if rules is not None and rules.axes():
            raise NotImplementedError(
                f"parameter sharding rules (on the mesh axes "
                f"{sorted(rules.axes())}: FSDP on the data axis, tensor or "
                f"channel parallelism on another) are not ported yet "
                f"(ROADMAP.md A6, its second part); the port's "
                f"ParallelWrapper keeps whole parameters on every rank and "
                f"refuses the rules rather than ignore them")
        if spine is None:
            spine = MeshContext(
                mesh if mesh is not None else make_mesh(
                    device_type=net.device.type),
                param_rules, batch_axis=batch_axis,
                shard_opt_state=shard_opt_state)
        self.net = net
        self.spine = spine
        self.mesh = spine.mesh
        self.batch_axis = spine.batch_axis
        self.param_rules = spine.rules
        self.prefetch = prefetch_buffer
        self._graph = _is_graph(net)
        self.last_batch_index = -1   # in-epoch position (elastic resume)
        self.stopped_early = False   # did the last fit() stop via stop_fn?
        self.data_size = spine.data_size
        self.rank = spine.data_rank
        self.owner_tag = owner_tag(self)
        self._priced: set = set()
        self._opt_sh = spine.opt_shardings(net.updater_state,
                                           self._moment_keys())
        if self.data_size > 1:
            self._place()

    # ------------------------------------------------------- placement
    def _moment_keys(self):
        """State keys the spine may replica-shard: what this net's
        updaters declare, or every built-in moment key."""
        ups = getattr(self.net, "_layer_updaters", None) or \
            getattr(self.net, "_vertex_updaters", None)
        if not ups:
            return None
        return frozenset(k for u in ups.values()
                         for k in getattr(u, "sharded_state", ()))

    def _place(self) -> None:
        """Start every rank from rank 0's parameters and state, then keep
        only this rank's slice of each split moment."""
        net, dp = self.net, _DataParallelStep(self)
        group = self.spine.data_group
        src = torch.distributed.get_global_rank(group, 0)
        for t in (*tree_leaves(net.params_tree),
                  *tree_leaves(net.state_tree)):
            pd.broadcast(t.data, src=src, group=group, purpose="init")
        placements: Dict[str, Any] = {}
        dropped = []
        for layer, sub in net.updater_state.items():
            if not isinstance(sub, dict):
                continue
            for skey, moments in sub.items():
                for pname, m in moments.items():
                    if not isinstance(m, torch.Tensor):
                        continue        # a nested subtree stays whole
                    sh = self._opt_sh[layer][skey][pname]
                    split = [d for d, a in enumerate(sh.spec)
                             if a is not None]
                    if not split:
                        continue
                    d = split[0]
                    if m.shape[d] % self.data_size:
                        raise ValueError(
                            f"{layer}/{pname}: dim {d} of size "
                            f"{m.shape[d]} does not split over "
                            f"{self.data_size} ranks")
                    leaf = dp.leaves.setdefault(
                        (layer, pname),
                        _Leaf(layer, pname, d, self.data_size, m.shape))
                    mine = leaf.slice_of(m, self.rank).clone(
                        memory_format=torch.contiguous_format)
                    placements[f"{layer}/{skey}/{pname}"] = (
                        list(m.shape), sh.bounds(m.shape))
                    dropped.append(m)
                    moments[pname] = mine
        wit = donatemon.get_donation_witness()
        if wit is not None and dropped:
            wit.mark_donated(dropped, "updater_state",
                             "ParallelWrapper.shard_opt_state")
        net._placements = {"updater": placements}
        net._dp = dp

    # -------------------------------------------------------------- fit
    def _pad_to_divisible(self, ds):
        b = ds.num_examples()
        div = self.data_size
        if b % div == 0:
            return ds
        pad = div - (b % div)
        idx = np.concatenate([np.arange(b), np.zeros(pad, np.int64)])
        return _map_rows(ds, idx)

    def _local_rows(self, ds):
        """This rank's rows of the padded global batch."""
        ds = self._pad_to_divisible(ds)
        if self.data_size == 1:
            return ds
        per = ds.num_examples() // self.data_size
        return _map_rows(ds, slice(self.rank * per, (self.rank + 1) * per))

    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 128, checkpointer=None,
            checkpoint_every: int = 1, resume=None,
            stop_fn=None, preemption=None, steps_per_dispatch: int = 1,
            device_prefetch: bool = True, sync_every: int = 0):
        """Reference: `ParallelWrapper.fit(DataSetIterator):409`. `data`
        and `batch_size` are GLOBAL: every rank passes the same iterator
        and trains on its rows of each batch.

        Recovery (`optim/recovery.RecoveryPlan`, as `MultiLayerNetwork.
        fit`): `checkpointer` (a ShardedCheckpointer) saves every
        `checkpoint_every` iterations, asynchronously, each rank its own
        slices; `resume` takes the position dict `restore_into_wrapper`
        returns, or "auto"; `epochs` counts TOTAL epochs over the whole
        (resumed) run. `stop_fn` / `preemption=True` end training cleanly
        at a batch boundary (ElasticTrainer's seam).
        `steps_per_dispatch=K` gives K 1's result (see the module
        docstring); `device_prefetch` keeps max(2, K) batches' copies to
        the card in flight."""
        net = self.net
        data_size = self.data_size
        # the wrapper always runs under a plan: last_batch_index must
        # track even checkpointer-less fits (ElasticTrainer reads it).
        # Padding and a rank's rows happen in the iterator (before the
        # copy to the card), so the plan has no `prepare`.
        plan = RecoveryPlan(
            net, checkpointer=checkpointer, checkpoint_every=checkpoint_every,
            resume=resume, stop_fn=stop_fn, preemption=preemption,
            restore_fn=(lambda: checkpointer.restore_into_wrapper(self))
            if checkpointer is not None else None)

        if isinstance(data, MultiDataSet):
            iterable: Any = as_iterator(data)
        else:
            iterable = as_iterator(data, labels, batch_size)
            if self.prefetch:
                iterable = iterable.async_(self.prefetch)
        k = max(1, int(steps_per_dispatch))
        if device_prefetch:
            iterable = DevicePrefetchIterator(
                iterable, lambda ds: net._put_batch(self._local_rows(ds)),
                depth=max(2, k), device=net.device)
        else:
            iterable = _Rows(iterable, self._local_rows)

        def epoch_start():
            plan.epoch_start()
            self.last_batch_index = plan.last_batch_index

        def after_dispatch(bi):
            plan.after_dispatch(bi)
            self.last_batch_index = plan.last_batch_index

        net._loss_tracker.sync_every = int(sync_every)
        from deeplearning4j_tpu_torch.observe import get_flight, get_registry

        reg = get_registry()
        reg.gauge("train_replicas").set(int(self.mesh.size()))
        reg.gauge("train_steps_per_dispatch").set(k)
        get_flight().record(
            "parallel_fit", replicas=int(self.mesh.size()),
            steps_per_dispatch=k, processes=pd.process_count(),
            mesh_axes={str(a): int(self.mesh.size(i)) for i, a in
                       enumerate(self.mesh.mesh_dim_names)},
            opt_state_sharded=bool(self.spine.shard_opt_state))
        net._start_steps()
        graphs = net.cuda_graphs
        if data_size > 1:
            net.cuda_graphs = False
        net._comm_owner = self.owner_tag
        step = net._fit_batch if self._graph else net._dispatch_batch
        execu = TrainingExecutor(
            net, step=lambda ds: self._priced_call(
                ("step", batch_signature(ds)), step, ds),
            fused_step=lambda bs: self._priced_call(
                ("window", len(bs), batch_signature(bs[0])),
                net._fused_dispatch, bs),
            can_fuse=net._can_fuse, steps_per_dispatch=k,
            before_batch=plan.before_batch, after_dispatch=after_dispatch,
            epoch_start=epoch_start, epoch_end=plan.epoch_end,
            mesh_ctx=self.spine)
        try:
            run_with_recovery(execu, plan, iterable, epochs)
        finally:
            net.cuda_graphs = graphs
        self.last_batch_index = plan.last_batch_index
        self.stopped_early = execu.stopped  # authoritative for ElasticTrainer
        return net

    def _step(self, ds):
        """One data-parallel step on a GLOBAL batch outside `fit` (the
        early-stopping trainer's seam): this rank's rows, batch
        statistics over the data group. Returns the device loss."""
        net = self.net
        step = net._fit_batch if self._graph else net._dispatch_batch
        return self._priced_call(("step", batch_signature(ds)), step,
                                 self._local_rows(ds))

    def _priced_call(self, key, fn, arg):
        """Run a step or window; its first run under `key` is the
        owner's first call of a new key (the watchdog counts it, as the
        JAX package counts the step's compile) and is priced: the
        collectives it ran go to the watchdog's ledger."""
        if key in self._priced:
            return fn(arg)
        ledger = commsmon.get_comm_ledger()
        mark = ledger.mark()
        out = fn(arg)
        self._priced.add(key)
        wd, owner = get_watchdog(), type(self).__name__
        wd.record_compile(self.owner_tag, owner, key)
        wd.record_collectives(self.owner_tag, owner, key,
                              ledger.summary(mark))
        return out
