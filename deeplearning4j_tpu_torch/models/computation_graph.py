"""ComputationGraph — the DAG runtime of the PyTorch port (port of
`deeplearning4j_tpu/models/computation_graph.py`): `init` with per-vertex
updaters, the forward fold over the topological order, the loss (the
sum of the output layers' scores, regularization and any vertex's
`aux_loss`), the train step, `fit`, `output`, `score`, and evaluation
(`predict`, `evaluate*`).

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
vertex state, copied into the stored tensors after every step, and
`fit(steps_per_dispatch=K)` runs K steps as one CUDA graph on the card,
as `MultiLayerNetwork`'s does.

Batches are `DataSet`s (the first network input and output) or
`MultiDataSet`s (every input and output, by position). `rnn_time_step`
steps recurrent and attention vertices alike, as the sequential
runtime's does (lockstep KV caches, one graph replay a call), for
`utils/textgen`'s `generate` and `beam_search` too; gradient
checkpointing recomputes each layer vertex in the backward.

`pretrain` trains the pretrainable layer vertices in topological
order, and a non-SGD `optimization_algo` fits each batch with a
full-batch solver, as `MultiLayerNetwork`'s do; `params()` /
`set_params()` are the flat view (vertex names sorted, depth first).

Truncated BPTT (`tbptt_fwd_length`, `tbptt_back_length`) cuts every
3-D input and label of a batch into chunks of time, one train step a
chunk, and hands the recurrent vertices' carries from chunk to chunk
detached, as JAX's `_fit_tbptt` does.

Not ported yet, and refused rather than ignored: the recovery arguments
(ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    DevicePrefetchIterator, as_iterator,
)
from deeplearning4j_tpu_torch.models.decode_state import DecodeState
from deeplearning4j_tpu_torch.models.multilayer import (
    _DTYPES, MultiLayerNetwork, _argmax_i32, _as_tensor, _check_decode_budget,
    _checkpointed, _copy_states, _grad_and_update, _host, _is_recurrent,
    _refuse, _reorder_carries, _stateful_step, _to_device, _updater_groups,
    _validate_causal_decode,
)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraphConfiguration, LayerVertex, resolve_output_type,
)
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
        self.cuda_graphs = True
        self._graphs = NetGraphs(self.device)
        self.fit_stats = {"graph_windows": 0, "eager_steps": 0}
        self._decode_state = DecodeState()
        self._solver = None
        self.pretrain_losses: Dict[str, List[torch.Tensor]] = {}

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
        self._start_steps()
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

    @property
    def _rnn_vertex_names(self) -> List[str]:
        """Vertices that carry RNN state (`rnn_time_step`)."""
        return [n for n, v in self.conf.vertices.items()
                if isinstance(v, LayerVertex) and _is_recurrent(v.layer)]

    @property
    def _decode_vertex_names(self) -> List[str]:
        """Vertices with KV-cache decode carries (attention stepping)."""
        return [n for n, v in self.conf.vertices.items()
                if isinstance(v, LayerVertex)
                and hasattr(v.layer, "decode_carry")]

    def _forward(self, params, states, inputs: Dict[str, Any], *,
                 train: bool, rng=None, fmasks=None,
                 scoring: bool = False, carries=None,
                 stop_before: Optional[str] = None):
        """Fold over the topological order. Returns (values, out_inputs,
        new_states): `out_inputs[name]` is the input each output layer
        saw (after its preprocessor), which its fused loss scores. With
        `scoring` the output layers themselves are not applied. A
        vertex's state is its entry in `carries` (stepping carries), else
        in `states`. A vertex gets the mask of its first input that has
        one, or, with `key_mask_input` (`CrossAttentionVertex`), only the
        named network input's. Under `gradient_checkpointing` every
        layer vertex but an output layer is checkpointed in training
        (`_checkpointed`); parameterless vertices are not wrapped. The
        fold stops at `stop_before`, which is not run."""
        values: Dict[str, Any] = dict(inputs)
        out_inputs: Dict[str, Any] = {}
        new_states: Dict[str, Any] = {}
        ckpt = train and self.conf.gradient_checkpointing
        for name in self.conf.topological_order:
            if name == stop_before:
                break
            v = self.conf.vertices[name]
            ins = [values[i] for i in self.conf.vertex_inputs[name]]
            st = states.get(name) or None
            if carries is not None and name in carries:
                st = carries[name]
            mask = None
            if fmasks:
                pref = getattr(v, "key_mask_input", None)
                if pref is not None:
                    # the named input's mask only: another stream's mask
                    # would be taken for a key mask
                    mask = fmasks.get(pref)
                else:
                    mask = next((fmasks[i]
                                 for i in self.conf.vertex_inputs[name]
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
            elif ckpt and isinstance(v, LayerVertex):
                y, new_st = _checkpointed(v.apply, params[name], ins, st,
                                          rng, mask)
            else:
                y, new_st = v.apply(params[name], ins, state=st, train=train,
                                    rng=rng, mask=mask)
            values[name] = y
            new_states[name] = new_st
        return values, out_inputs, new_states

    # ------------------------------------------------------------- loss
    def _loss(self, params, states, inputs, labels: Dict[str, Any], fmasks,
              lmasks, rng, train: bool = True, carries=None):
        _, out_inputs, new_states = self._forward(
            params, states, inputs, train=train, rng=rng, fmasks=fmasks,
            scoring=True, carries=carries)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for name in self.conf.network_outputs:
            v = self.conf.vertices[name]
            if not self._is_output(v):
                continue
            lm = lmasks.get(name) if lmasks else None
            if isinstance(v.layer, CenterLossOutputLayer):
                sc, new_states[name] = v.layer.score_and_state(
                    params[name], out_inputs[name], labels[name],
                    states[name], lm)
            else:
                sc = v.layer.score(params[name], out_inputs[name],
                                   labels[name], lm)
            total = total + sc
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
    def make_step_fn(self, tbptt: bool = False):
        """The train step: `step_fn(params, opt_state, states, step,
        inputs, labels, fmasks, lmasks, rng, carries=None)` returns
        `(params, opt_state, states, loss)`, as JAX's does; params and
        opt_state are updated IN PLACE, the loss is a 0-dim tensor on the
        device, and the stateful vertices' new states (batch-norm running
        statistics) replace the old. With `tbptt` the recurrent vertices
        start from `carries` and the step also returns their final
        states, detached, for the next chunk."""
        mode = self.conf.gradient_normalization
        thr = self.conf.gradient_normalization_threshold
        groups = _updater_groups(self._vertex_updaters)
        stateful = self._stateful
        rnn_names = self._rnn_vertex_names

        def step_fn(params, opt_state, states, step, inputs, labels, fmasks,
                    lmasks, rng, carries=None):
            loss, new_states = _grad_and_update(
                lambda live: self._loss(live, states, inputs, labels, fmasks,
                                        lmasks, rng, train=True,
                                        carries=carries),
                params, opt_state, groups, mode, thr, step)
            persist = {n: (tree_map(torch.detach, new_states[n])
                           if n in stateful else states.get(n, {}))
                       for n in states}
            if tbptt:
                return params, opt_state, persist, loss, {
                    n: tree_map(torch.detach, new_states[n])
                    for n in rnn_names}
            return params, opt_state, persist, loss

        return step_fn

    # ---------------------------------------------------- data plumbing
    def _put_batch(self, ds):
        """A DataSet or MultiDataSet on the net's device: features and
        masks in the net's dtype, floating labels as float32, integer
        labels as int64."""
        dev = self.device

        def put(a, dtype):
            return _to_device(a, dtype, dev)

        if isinstance(ds, MultiDataSet):
            def each(xs, dtype):
                return None if xs is None else [put(a, dtype) for a in xs]

            return MultiDataSet(each(ds.features, self.dtype),
                                each(ds.labels, None),
                                each(ds.features_masks, self.dtype),
                                each(ds.labels_masks, self.dtype))
        return DataSet(put(ds.features, self.dtype), put(ds.labels, None),
                       put(ds.features_mask, self.dtype),
                       put(ds.labels_mask, self.dtype))

    def _to_dicts(self, ds):
        """A batch onto the network inputs and outputs by name:
        (features, labels, feature masks, label masks). A MultiDataSet
        maps by position; a DataSet feeds the first input and output
        (a graph with more inputs then lacks one, as in JAX)."""
        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        if isinstance(ds, MultiDataSet):
            def named(names, xs):
                return {n: a for n, a in zip(names, xs or ())
                        if a is not None} or None

            return (dict(zip(ins, ds.features)), dict(zip(outs, ds.labels)),
                    named(ins, ds.features_masks),
                    named(outs, ds.labels_masks))
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
            device_prefetch: bool = True, sync_every: int = 0,
            checkpointer=None, resume=None, stop_fn=None, preemption=None):
        """Train on arrays, a DataSet, a DataSetIterator or any iterable
        of DataSets. The loss stays on the device (``score_`` reads it;
        ``sync_every=N`` reads it every N steps); ``device_prefetch``
        keeps max(2, K) batches' copies to the card in flight on a side
        stream. ``steps_per_dispatch=K`` runs K same-shape batches as one
        dispatch, a CUDA graph of K train steps on the card, as
        `MultiLayerNetwork.fit`; under truncated BPTT a batch whose inputs
        are all 3-D runs step by step instead (`_fit_tbptt`: its chunks
        hand carries on). A MultiDataSet (or an iterable of them) feeds
        every input and output. Refused rather than ignored, until
        ported: the recovery arguments."""
        self._check_init()
        if checkpointer is not None or resume is not None or \
                stop_fn is not None or preemption:
            _refuse("checkpointed, resumable or stoppable fit "
                    "(optim/recovery.py)", "A6")
        k = max(1, int(steps_per_dispatch))
        it = as_iterator(data, labels, batch_size)
        if device_prefetch:
            it = DevicePrefetchIterator(it, self._put_batch,
                                        depth=max(2, k), device=self.device)
        self._loss_tracker.sync_every = int(sync_every)
        self._start_steps()
        TrainingExecutor(self, step=self._fit_batch,
                         fused_step=self._fused_dispatch,
                         can_fuse=self._can_fuse,
                         steps_per_dispatch=k).run(it, epochs)
        return self

    # the step counter, the addresses a graph reads, the generators it
    # draws from and the K-step dispatch, as `MultiLayerNetwork`'s
    _start_steps = MultiLayerNetwork._start_steps
    _state_addresses = MultiLayerNetwork._state_addresses
    _generators = MultiLayerNetwork._generators
    _fused_dispatch = MultiLayerNetwork._fused_dispatch
    # the solver step, the flat parameter view and the listener calls
    _fit_solver = MultiLayerNetwork._fit_solver
    _solver_finish = MultiLayerNetwork._solver_finish
    params = MultiLayerNetwork.params
    set_params = MultiLayerNetwork.set_params
    set_listeners = MultiLayerNetwork.set_listeners
    add_listener = MultiLayerNetwork.add_listener
    _pretrain_layer = MultiLayerNetwork._pretrain_layer

    def _on_device(self, ds):
        first = ds.features[0] if isinstance(ds, MultiDataSet) \
            else ds.features
        if not isinstance(first, torch.Tensor) or first.device != self.device:
            ds = self._put_batch(ds)
        self.last_batch_size = ds.num_examples()
        return ds

    def _check_batch(self, ds) -> None:
        self._check_inputs(self._to_dicts(ds)[0])

    def _fit_batch(self, ds):
        """One train step on one batch (one solver run under a non-SGD
        algorithm, the chunks of `_fit_tbptt` under truncated BPTT when
        every input is 3-D); returns the device loss."""
        if self.conf.optimization_algo != "stochastic_gradient_descent":
            return self._fit_solver(ds)
        ds = self._on_device(ds)
        self._check_batch(ds)
        self.fit_stats["eager_steps"] += 1
        fields = self._batch_fields(ds)
        if self.conf.tbptt_fwd_length > 0 and all(
                v.ndim == 3 for v in fields[0].values()):
            return self._fit_tbptt(*fields)
        return self._train_step(*fields)

    def _fit_tbptt(self, feats, labs, fmasks, lmasks):
        """Truncated BPTT on one batch (reference: `ComputationGraph.fit`'s
        tBPTT dispatch and `doTruncatedBPTT`): every input, label and mask
        is cut into chunks of `tbptt_fwd_length` steps, each chunk is one
        train step, and the recurrent vertices' carries are handed from
        chunk to chunk detached. When `tbptt_back_length` is shorter, the
        head of each chunk only advances the carries (no gradient, no
        update) and the step covers the last `back` steps. Every chunk
        sees the same step count: the iteration, and so Adam's bias
        correction, advances once a batch. Returns the mean of the chunk
        losses, taken on the device."""
        L = self.conf.tbptt_fwd_length
        Lb = min(self.conf.tbptt_back_length or L, L)
        T = next(iter(feats.values())).shape[1]
        for name, lab in labs.items():
            if lab.ndim != 3:
                raise ValueError(
                    f"Truncated BPTT requires per-timestep 3-D labels; "
                    f"output {name!r} has shape {tuple(lab.shape)}")
        step_fn = self.make_step_fn(tbptt=True)

        def sl(d, a, b):
            return None if d is None else {n: v[:, a:b]
                                           for n, v in d.items()}

        carries, losses = {}, []
        for lo in range(0, T, L):
            hi = min(lo + L, T)
            t_lo = lo
            if Lb < hi - lo:
                t_lo = hi - Lb
                carries = self._advance_carries(
                    sl(feats, lo, t_lo), sl(fmasks, lo, t_lo), carries)
            _, _, persist, loss, carries = step_fn(
                self.params_tree, self.updater_state, self.state_tree,
                self._step_t, sl(feats, t_lo, hi), sl(labs, t_lo, hi),
                sl(fmasks, t_lo, hi), sl(lmasks, t_lo, hi), self._rng,
                carries or None)
            _copy_states(self.state_tree, persist)
            losses.append(loss)
        self._step_t.add_(1)
        return torch.stack(losses).mean()

    @torch.no_grad()
    def _advance_carries(self, feats, fmasks, carries):
        """Gradient-free forward that only moves the recurrent vertices'
        carries along: the no-update head of a fwd > back tBPTT chunk."""
        _, _, new_states = self._forward(
            self.params_tree, self.state_tree, feats, train=False,
            fmasks=fmasks, carries=carries or None)
        return {n: new_states[n] for n in self._rnn_vertex_names}

    def _batch_fields(self, ds) -> tuple:
        """A batch as `_train_step`'s arguments: dicts by name."""
        return self._to_dicts(ds)

    def _train_step(self, feats, labs, fmasks, lmasks):
        """The train step over the net's own trees, all in place (the
        new running statistics copied into `state_tree`, the step
        counter advanced where it lies). Returns the device loss."""
        _, _, persist, loss = self.make_step_fn()(
            self.params_tree, self.updater_state, self.state_tree,
            self._step_t, feats, labs, fmasks, lmasks, self._rng)
        _copy_states(self.state_tree, persist)
        self._step_t.add_(1)
        return loss

    def _can_fuse(self, ds) -> bool:
        """Fused dispatch takes the plain SGD step: a batch whose inputs
        are all 3-D under truncated BPTT runs per step (JAX's
        `_can_fuse`)."""
        if self.conf.optimization_algo != "stochastic_gradient_descent":
            return False
        if self.conf.tbptt_fwd_length > 0:
            fs = ds.features if isinstance(ds, MultiDataSet) \
                else [ds.features]
            if all(f.ndim == 3 for f in fs):
                return False
        return True

    def _solver_loss(self, params, states, fields):
        """The deterministic train-mode loss a solver minimizes: (loss,
        new states) of `params` on one batch's dicts."""
        feats, labs, fmasks, lmasks = fields
        return self._loss(params, states, feats, labs, fmasks, lmasks, None,
                          train=True)

    def pretrain(self, data, *, epochs: int = 1, batch_size: int = 32):
        """Greedy layerwise pretraining of the pretrainable layer vertices
        (AutoEncoder, RBM, VAE) in topological order (reference:
        `ComputationGraph.pretrain`), each on its first input's
        activation: the graph folded in eval mode up to that vertex, then
        its preprocessor. One gradient a batch through the vertex's own
        updater, as `MultiLayerNetwork.pretrain`. Returns the net."""
        self._check_init()
        it = as_iterator(data, None, batch_size)
        self.pretrain_losses = {}
        for name in self.conf.topological_order:
            v = self.conf.vertices[name]
            if not (isinstance(v, LayerVertex) and v.layer.is_pretrainable):
                continue

            def featurize(feats, name=name, v=v):
                values, _, _ = self._forward(self.params_tree,
                                             self.state_tree, feats,
                                             train=False, stop_before=name)
                x = values[self.conf.vertex_inputs[name][0]]
                if v.preprocessor is not None:
                    x = v.preprocessor.apply(x)
                return x

            self._pretrain_layer(v.layer, name, self._vertex_updaters[name],
                                 featurize, it, epochs,
                                 lambda ds: self._to_dicts(ds)[0])
        return self

    # ------------------------------------------------ stateful stepping
    @torch.no_grad()
    def rnn_time_step(self, *xs):
        """Stateful inference, one array per network input ([B, T, F],
        or [B, F] for one step); the carries of recurrent and attention
        vertices persist across calls (reference: `rnnTimeStep`), as in
        `MultiLayerNetwork.rnn_time_step`: attention vertices are
        validated (causal only) and seeded with lockstep carries on the
        first call, and when every input steps by the same T the
        host-side budget guards the step and the decode position
        advances after it. One graph replay a call on the card
        (`_stateful_step`). Returns one tensor per network output (a
        single tensor for one output)."""
        self._check_init()
        inputs = {}
        for n, x in zip(self.conf.network_inputs, xs):
            x = _as_tensor(x, self.dtype, self.device)
            inputs[n] = x[:, None, :] if x.ndim == 2 else x
        decode = [(n, self.conf.vertices[n].layer)
                  for n in self._decode_vertex_names]
        names = self._rnn_vertex_names + [n for n, _ in decode]
        st = self._decode_state
        with st.lock():
            t_step = None
            if decode:
                # a graph whose inputs step by different lengths (a whole
                # encoder context beside one decoder token) has no single
                # position: the NaN poison is its only overflow signal
                lens = {v.shape[1] for v in inputs.values() if v.ndim >= 3}
                if len(lens) == 1:
                    t_step = lens.pop()
                    _check_decode_budget(st.pos, [l for _, l in decode],
                                         t_step)
            if not st.carries and decode:
                _validate_causal_decode(decode, kind="vertex")
                batch = next(iter(inputs.values())).shape[0]
                st.seed({n: l.decode_carry(batch, self.dtype,
                                           device=self.device)
                         for n, l in decode})
            order = list(inputs)

            def fwd(xs_, c):
                values, _, new_states = self._forward(
                    self.params_tree, self.state_tree, dict(zip(order, xs_)),
                    train=False, carries=c)
                return ([values[o] for o in self.conf.network_outputs],
                        {n: new_states[n] for n in names})

            outs, new = _stateful_step(self, fwd, tuple(inputs.values()),
                                       st.carries or None)
            st.update(new, advance=t_step or 0)
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self) -> None:
        """Drop the carries and the decode position (reference:
        `rnnClearPreviousState`)."""
        self._decode_state.clear()

    def rnn_reorder_state(self, idx) -> None:
        """Reorder (or expand) the stepping carries along the batch
        dimension, as `MultiLayerNetwork.rnn_reorder_state`."""
        self._decode_state.reorder(
            lambda c: _reorder_carries(c, idx, self.device))

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
        """Mean loss (scores + regularization) on one batch (a DataSet, a
        MultiDataSet, or arrays), running statistics, no dropout."""
        self._check_init()
        ds = data if isinstance(data, (DataSet, MultiDataSet)) else DataSet(
            np.asarray(data), np.asarray(labels))
        feats, labs, fmasks, lmasks = self._to_dicts(self._put_batch(ds))
        loss, _ = self._loss(self.params_tree, self.state_tree, feats, labs,
                             fmasks, lmasks, None, train=False)
        return float(loss)

    # ------------------------------------------------------- evaluation
    def predict(self, *xs):
        """Argmax class predictions (int32), one array per output."""
        out = self.output(*xs)
        if isinstance(out, list):
            return [_argmax_i32(o).cpu().numpy() for o in out]
        return _argmax_i32(out).cpu().numpy()

    def _first_output_host(self, x) -> np.ndarray:
        out = self.output(x)
        return _host(out[0] if isinstance(out, list) else out)

    def _head_index(self, output_name: Optional[str]) -> int:
        order = list(self.conf.network_outputs)
        if output_name is None:
            return 0
        if output_name not in order:
            raise ValueError(
                f"Unknown output {output_name!r}; graph outputs: {order}")
        return order.index(output_name)

    def evaluate(self, iterator, output_name: Optional[str] = None):
        """Classification metrics of one head (the first output by
        default) over an iterator of DataSets, whose labels belong to
        that head. For plain per-example labels the argmax runs ON THE
        DEVICE and only int32 class indices cross to the host; masked or
        time-series labels take the full output. RecordMetaData from a
        meta-collecting iterator flows into per-example Prediction
        records."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        self._check_init()
        idx = self._head_index(output_name)

        def head(out):
            return out[idx] if isinstance(out, list) else out

        ev = Evaluation()
        for ds in iterator:
            meta = getattr(iterator, "last_meta", None)
            lab = np.asarray(ds.labels)
            mask = ds.labels_mask
            o = head(self.output(ds.features))
            if lab.ndim == 3 or mask is not None:
                ev.eval(lab, _host(o), mask=mask,
                        record_meta=None if lab.ndim == 3 else meta)
                continue
            pred = _argmax_i32(o).cpu().numpy()
            actual = (lab.argmax(-1) if lab.ndim == 2
                      else lab.astype(np.int64))
            n = lab.shape[-1] if lab.ndim == 2 else int(o.shape[-1])
            ev.eval_indices(actual, pred, num_classes=n, record_meta=meta)
        return ev

    def evaluate_outputs(self, iterator,
                         output_names: Optional[Sequence[str]] = None
                         ) -> Dict[str, Any]:
        """Per-output metrics in one forward pass a batch:
        {output_name: Evaluation}. DataSet batches carry one labels
        array, so they evaluate one head (MultiDataSet batches, labels
        per output, are not ported)."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        self._check_init()
        order = list(self.conf.network_outputs)
        names = list(output_names) if output_names is not None else order
        for n in names:
            if n not in order:
                raise ValueError(
                    f"Unknown output {n!r}; graph outputs: {order}")
        if len(order) > 1 and len(names) != 1:
            raise ValueError(
                "DataSet batches carry ONE labels array; evaluating "
                f"{len(names)} heads of a multi-output graph needs "
                "MultiDataSet batches (labels per output)")
        evals = {n: Evaluation() for n in names}
        for ds in iterator:
            outs = self.output(ds.features)
            if not isinstance(outs, list):
                outs = [outs]
            meta = getattr(iterator, "last_meta", None)
            lab = np.asarray(ds.labels)
            for n in names:
                evals[n].eval(
                    lab, _host(outs[order.index(n)]), mask=ds.labels_mask,
                    record_meta=None if lab.ndim == 3 else meta)
        return evals

    def evaluate_regression(self, iterator):
        """Reference: `ComputationGraph.evaluateRegression`."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        from deeplearning4j_tpu_torch.eval.regression import (
            RegressionEvaluation,
        )

        self._check_init()
        return Evaluation.run_evaluation(RegressionEvaluation(), iterator,
                                         self._first_output_host)

    def evaluate_roc(self, iterator, threshold_steps: int = 0):
        """Binary ROC over the first output. Reference: evaluateROC."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        from deeplearning4j_tpu_torch.eval.roc import ROC

        self._check_init()
        return Evaluation.run_evaluation(ROC(threshold_steps), iterator,
                                         self._first_output_host)

    def evaluate_roc_multi_class(self, iterator):
        """Reference: evaluateROCMultiClass."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        from deeplearning4j_tpu_torch.eval.roc import ROCMultiClass

        self._check_init()
        return Evaluation.run_evaluation(ROCMultiClass(), iterator,
                                         self._first_output_host)

    def num_params(self) -> int:
        self._check_init()
        return sum(p.numel() for p in tree_leaves(self.params_tree))
