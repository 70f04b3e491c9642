"""ComputationGraph — the DAG runtime of the PyTorch port (port of
`deeplearning4j_tpu/models/computation_graph.py`): `init` with per-vertex
updaters, the forward fold over the topological order, the loss (the
sum of the output layers' scores, regularization and any vertex's
`aux_loss`), the train step, `fit`, `output` and `score`.

Parameters, states and updater states are dicts keyed by vertex name,
each a dict of tensors keyed like the JAX trees, so
`models.convert.params_from_numpy` / `state_from_numpy` load a JAX
graph's trees unchanged. The net lives on one device: CUDA unless the
caller passes `device="cpu"`.

As `MultiLayerNetwork`: the step takes gradients with
`torch.autograd.grad`, updates parameters and optimizer moments IN PLACE
(one fused launch per group of vertices that share an updater and a
dtype), keeps its step counter and its loss on the device, and the fit
loop reads the loss once an epoch. Batch-norm running statistics are
vertex state, replaced after every step.

Not ported yet, and refused by `fit` rather than ignored: truncated BPTT
and `rnn_time_step` (ROADMAP A3), `steps_per_dispatch > 1` and the
full-batch solvers and `pretrain` (A1), the recovery arguments (A6) and
gradient checkpointing (A4). Batches are `DataSet`s: one network input
and one output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (
    DevicePrefetchIterator, as_iterator,
)
from deeplearning4j_tpu_torch.models.multilayer import (
    _DTYPES, _as_tensor, _grad_and_update, _refuse, _to_device,
    _updater_groups,
)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraphConfiguration, LayerVertex, resolve_output_type,
)
from deeplearning4j_tpu_torch.optim.executor import (
    LossTracker, TrainingExecutor,
)
from deeplearning4j_tpu_torch.optim.listeners import TrainingListener
from deeplearning4j_tpu_torch.optim.updaters import (
    NoOp, Updater, resolve_updater, tree_map,
)
from deeplearning4j_tpu_torch.utils.device import resolve_device


class ComputationGraph:
    """DAG network runtime over a ComputationGraphConfiguration."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.dtype = _DTYPES[conf.dtype]
        self.device = resolve_device(device)
        self.params_tree: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.state_tree: Dict[str, Any] = {}
        self.updater_state: Optional[Dict[str, Any]] = None
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[TrainingListener] = []
        self.last_batch_size: Optional[int] = None
        self._loss_tracker = LossTracker()
        self._vertex_updaters: Dict[str, Updater] = {}
        self._stateful: set = set()
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(int(conf.seed))
        self._step_t: Optional[torch.Tensor] = None

    @property
    def score_(self) -> Optional[float]:
        """Most recent training loss as a float (a host sync unless the
        fit loop already read it)."""
        return self._loss_tracker.value

    # ------------------------------------------------------------- init
    def init(self) -> "ComputationGraph":
        """Seeded init from `conf.seed` with a torch.Generator on the CPU,
        vertex by vertex in topological order, then moved to the device;
        then the per-vertex updaters and their state. Not the JAX weights
        for the same seed: parity tests load those with
        `params_from_numpy` and `state_from_numpy`."""
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        params, states = {}, {}
        known = dict(self.conf.input_types)
        for name in self.conf.topological_order:
            v = self.conf.vertices[name]
            ins = self.conf.vertex_inputs[name]
            in_types = [known[i] for i in ins if i in known]
            p, st = v.init_params(gen, in_types, self.dtype)
            params[name] = tree_map(lambda t: t.to(self.device), p)
            states[name] = tree_map(lambda t: t.to(self.device), st)
            if st:
                self._stateful.add(name)
            resolve_output_type(name, v, in_types, len(ins), known)
        self.params_tree = params
        self.state_tree = states
        self._build_updaters()
        self.updater_state = {n: u.init(params[n])
                              for n, u in self._vertex_updaters.items()}
        return self

    def _build_updaters(self):
        """Per-vertex updaters honouring a layer's own updater, learning
        rate and freezing."""
        global_u = resolve_updater(self.conf.updater or "sgd")
        for name in self.conf.topological_order:
            v = self.conf.vertices[name]
            u = global_u
            if isinstance(v, LayerVertex):
                layer = v.layer
                if layer.updater is not None:
                    u = resolve_updater(layer.updater)
                if layer.learning_rate is not None and \
                        hasattr(u, "learning_rate"):
                    u = dataclasses.replace(u,
                                            learning_rate=layer.learning_rate)
                if layer.frozen:
                    u = NoOp()
            self._vertex_updaters[name] = u

    def _check_init(self):
        if self.params_tree is None:
            raise RuntimeError("network not initialized: call init()")

    # ---------------------------------------------------------- forward
    def _is_output(self, v) -> bool:
        return isinstance(v, LayerVertex) and v.layer.is_output_layer

    def _forward(self, params, states, inputs: Dict[str, Any], *,
                 train: bool, rng=None, fmasks=None,
                 scoring: bool = False):
        """Fold over the topological order. Returns (values, out_inputs,
        new_states): `out_inputs[name]` is the input each output layer
        saw (after its preprocessor), which its fused loss scores. With
        `scoring` the output layers themselves are not applied."""
        values: Dict[str, Any] = dict(inputs)
        out_inputs: Dict[str, Any] = {}
        new_states: Dict[str, Any] = {}
        for name in self.conf.topological_order:
            v = self.conf.vertices[name]
            ins = [values[i] for i in self.conf.vertex_inputs[name]]
            st = states.get(name) or None
            mask = None
            if fmasks:
                mask = next((fmasks[i] for i in self.conf.vertex_inputs[name]
                             if i in fmasks), None)
            if self._is_output(v):
                x = ins[0]
                if v.preprocessor is not None:
                    x = v.preprocessor.apply(x)
                out_inputs[name] = x
                if scoring:
                    new_states[name] = st
                    continue
                y, new_st = v.layer.apply(params[name], x, state=st,
                                          train=train, rng=rng, mask=mask)
            else:
                y, new_st = v.apply(params[name], ins, state=st, train=train,
                                    rng=rng, mask=mask)
            values[name] = y
            new_states[name] = new_st
        return values, out_inputs, new_states

    # ------------------------------------------------------------- loss
    def _loss(self, params, states, inputs, labels: Dict[str, Any], fmasks,
              lmasks, rng, train: bool = True):
        _, out_inputs, new_states = self._forward(
            params, states, inputs, train=train, rng=rng, fmasks=fmasks,
            scoring=True)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for name in self.conf.network_outputs:
            v = self.conf.vertices[name]
            if not self._is_output(v):
                continue
            lm = lmasks.get(name) if lmasks else None
            total = total + v.layer.score(params[name], out_inputs[name],
                                          labels[name], lm)
        for name, v in self.conf.vertices.items():
            if isinstance(v, LayerVertex) and any(
                    (v.layer.l1, v.layer.l2, v.layer.l1_bias,
                     v.layer.l2_bias)):
                total = total + v.layer.regularization(params[name])
        for st in new_states.values():
            if isinstance(st, dict) and "aux_loss" in st:
                total = total + st["aux_loss"]
        return total, new_states

    # ------------------------------------------------------- train step
    def make_step_fn(self):
        """The train step: `step_fn(params, opt_state, states, step,
        inputs, labels, fmasks, lmasks, rng)` returns `(params, opt_state,
        states, loss)`, as JAX's does; params and opt_state are updated IN
        PLACE, the loss is a 0-dim tensor on the device, and the stateful
        vertices' new states (batch-norm running statistics) replace the
        old."""
        mode = self.conf.gradient_normalization
        thr = self.conf.gradient_normalization_threshold
        groups = _updater_groups(self._vertex_updaters)
        stateful = self._stateful

        def step_fn(params, opt_state, states, step, inputs, labels, fmasks,
                    lmasks, rng):
            loss, new_states = _grad_and_update(
                lambda live: self._loss(live, states, inputs, labels, fmasks,
                                        lmasks, rng, train=True),
                params, opt_state, groups, mode, thr, step)
            persist = {n: (tree_map(torch.detach, new_states[n])
                           if n in stateful else states.get(n, {}))
                       for n in states}
            return params, opt_state, persist, loss

        return step_fn

    # ---------------------------------------------------- data plumbing
    def _put_batch(self, ds: DataSet) -> DataSet:
        """A batch on the net's device: features and masks in the net's
        dtype, floating labels as float32, integer labels as int64."""
        dev = self.device
        return DataSet(_to_device(ds.features, self.dtype, dev),
                       _to_device(ds.labels, None, dev),
                       _to_device(ds.features_mask, self.dtype, dev),
                       _to_device(ds.labels_mask, self.dtype, dev))

    def _to_dicts(self, ds: DataSet):
        """A DataSet onto the first network input and output by name:
        (features, labels, feature masks, label masks)."""
        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        if len(ins) != 1 or len(outs) != 1:
            _refuse(f"feeding a graph of {len(ins)} inputs and {len(outs)} "
                    f"outputs (MultiDataSet)", "A1")
        feats = {ins[0]: ds.features}
        labs = {outs[0]: ds.labels} if ds.labels is not None else {}
        fmasks = ({ins[0]: ds.features_mask}
                  if ds.features_mask is not None else None)
        lmasks = ({outs[0]: ds.labels_mask}
                  if ds.labels_mask is not None else None)
        return feats, labs, fmasks, lmasks

    def _check_inputs(self, inputs: Dict[str, torch.Tensor]) -> None:
        for name, x in inputs.items():
            it = self.conf.input_types.get(name)
            if it is None or it.kind == "rnn":
                continue
            expect = it.shape(int(x.shape[0]))
            if tuple(x.shape) != tuple(expect):
                raise ValueError(
                    f"input {name!r}: shape {tuple(x.shape)} does not match "
                    f"configured {it!r} (expected {tuple(expect)} for "
                    f"batch={x.shape[0]})")

    # ---------------------------------------------------------- fit API
    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 32, steps_per_dispatch: int = 1,
            sync_every: int = 0, checkpointer=None, resume=None,
            stop_fn=None, preemption=None):
        """Train on arrays, a DataSet, a DataSetIterator or any iterable
        of DataSets. The loss stays on the device (``score_`` reads it;
        ``sync_every=N`` reads it every N steps) and each batch's copy to
        the card is enqueued one batch ahead. Refused rather than ignored,
        until ported: truncated BPTT, ``steps_per_dispatch > 1``, the
        recovery arguments, gradient checkpointing and non-SGD solvers."""
        self._check_init()
        if self.conf.tbptt_fwd_length > 0:
            _refuse("truncated BPTT of a ComputationGraph", "A3")
        if int(steps_per_dispatch) > 1:
            _refuse("steps_per_dispatch > 1 (a CUDA graph of K steps)",
                    "A1")
        if checkpointer is not None or resume is not None or \
                stop_fn is not None or preemption:
            _refuse("checkpointed, resumable or stoppable fit "
                    "(optim/recovery.py)", "A6")
        if self.conf.gradient_checkpointing:
            _refuse("gradient checkpointing (rematerialization)", "A4")
        if self.conf.optimization_algo != "stochastic_gradient_descent":
            _refuse(f"solver {self.conf.optimization_algo!r} "
                    f"(optim/solvers.py)", "A1")
        it = DevicePrefetchIterator(as_iterator(data, labels, batch_size),
                                    self._put_batch)
        self._loss_tracker.sync_every = int(sync_every)
        self._step_t = torch.full((), self.iteration, dtype=torch.int64,
                                  device=self.device)
        TrainingExecutor(self, step=self._fit_batch).run(it, epochs)
        return self

    def _fit_batch(self, ds: DataSet):
        """One train step on one batch; returns the device loss."""
        if not isinstance(ds.features, torch.Tensor) or \
                ds.features.device != self.device:
            ds = self._put_batch(ds)
        feats, labs, fmasks, lmasks = self._to_dicts(ds)
        self._check_inputs(feats)
        self.last_batch_size = ds.num_examples()
        (self.params_tree, self.updater_state, self.state_tree,
         loss) = self.make_step_fn()(
            self.params_tree, self.updater_state, self.state_tree,
            self._step_t, feats, labs, fmasks, lmasks, self._rng)
        self._step_t.add_(1)
        return loss

    def pretrain(self, *args, **kwargs):
        _refuse("layerwise pretraining of a ComputationGraph", "A1")

    def rnn_time_step(self, *xs):
        _refuse("rnn_time_step of a ComputationGraph", "A3")

    # -------------------------------------------------------- inference
    @torch.no_grad()
    def output(self, *xs, train: bool = False):
        """Forward; one tensor per network output (a single tensor for
        one output). Batch norm uses its running statistics unless
        `train`."""
        self._check_init()
        inputs = {n: _as_tensor(x, self.dtype, self.device)
                  for n, x in zip(self.conf.network_inputs, xs)}
        self._check_inputs(inputs)
        values, _, _ = self._forward(self.params_tree, self.state_tree,
                                     inputs, train=train)
        outs = [values[o] for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    @torch.no_grad()
    def score(self, data, labels=None) -> float:
        """Mean loss (scores + regularization) on one batch, running
        statistics, no dropout."""
        self._check_init()
        ds = data if isinstance(data, DataSet) else DataSet(
            np.asarray(data), np.asarray(labels))
        feats, labs, fmasks, lmasks = self._to_dicts(self._put_batch(ds))
        loss, _ = self._loss(self.params_tree, self.state_tree, feats, labs,
                             fmasks, lmasks, None, train=False)
        return float(loss)
