"""MultiLayerNetwork — the sequential-stack runtime of the PyTorch port
(port of `deeplearning4j_tpu/models/multilayer.py`): inference, the
slot-indexed serving sessions, stateful stepping of recurrent stacks
(`rnn_time_step`), and training (`init` with updaters, `make_step_fn`,
`fit` with truncated BPTT, `score`).

Parameters are a dict of per-layer tensor dicts (nested for the
bidirectional wrappers) keyed exactly like the JAX `params_tree`, so `models.convert.params_from_numpy` loads a JAX
net's weights unchanged; `updater_state` mirrors JAX's per-layer
updater state, loaded by `updater_state_from_numpy`. The net lives on
one device: CUDA unless the caller passes `device="cpu"`.

A train step takes gradients with `torch.autograd.grad` over detached
copies of the parameter leaves, then updates parameters and optimizer
moments IN PLACE, as the JAX step donates them and the TPU kernels alias
them: one `update_with_params` call a group of layers that share an
updater, so the zoo transformer's Adam is one launch of kernel B1a a
step. Its step counter lives on the device, and the loss stays there
until the fit loop reads it once an epoch (`optim/executor.py`).

Slot-indexed sessions thread their carries through `session_step` and
`session_decode_window` as arguments, as in JAX, but the KV caches
inside those carries are updated in place (see
`nn/layers/attention.py`): only per-slot position vectors are new
tensors after a step, and every lane that must not write is masked out
of the cache write itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (
    DevicePrefetchIterator, as_iterator,
)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.models.decode_state import DecodeState
from deeplearning4j_tpu_torch.nn.layers import (
    BaseRecurrentLayer, Bidirectional, EmbeddingSequenceLayer,
    GravesBidirectionalLSTM, Layer,
)
from deeplearning4j_tpu_torch.optim.executor import (
    LossTracker, TrainingExecutor,
)
from deeplearning4j_tpu_torch.optim.listeners import TrainingListener
from deeplearning4j_tpu_torch.optim.updaters import (
    NoOp, Updater, resolve_updater, tree_leaves, tree_map,
)
from deeplearning4j_tpu_torch.utils.device import resolve_device

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
                     threshold: float, step):
    """One train step's gradients and update. `loss_fn(live)` returns
    (loss, aux) for `live`, the params with every trained leaf replaced
    by a detached view that requires grad: the stored tensors stay plain,
    so the update, IN PLACE into `params` and `opt_state`, needs no
    autograd bookkeeping. Gradients are made contiguous (the fused update
    kernels read them densely; a convolution's weight gradient can come
    back permuted). Returns (loss detached, aux)."""
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
    grads = _normalize_grads(grads, mode, threshold)
    for u, names in groups:
        st = {n: opt_state[n] for n in names}
        first = st[names[0]]
        group_state = ({key: {n: st[n][key] for n in names} for key in first}
                       if isinstance(first, dict) else ())
        u.update_with_params({n: grads[n] for n in names}, group_state,
                             {n: params[n] for n in names}, step)
    return loss.detach(), aux


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md {item}); the port refuses "
        f"it rather than ignore it")


class MultiLayerNetwork:
    """Sequential network runtime over a MultiLayerConfiguration."""

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
            states[layer.name] = st
            if st:
                self._stateful.add(layer.name)
            if it is not None:
                it = layer.output_type(it)
        self.params_tree = params
        self.state_tree = states
        self._build_updaters()
        self.updater_state = {name: u.init(params[name])
                              for name, u in self._layer_updaters.items()}
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
                 fmask=None, carries=None, stop: Optional[int] = None):
        """Run layers[:stop] (all by default), each after its input
        preprocessor; returns (output, new states by layer name). Dropout
        draws from the generator `rng` when `train`."""
        new_states = {}
        pps = self.conf.preprocessors
        for i, layer in enumerate(self.layers[:stop]):
            if i in pps:
                x = pps[i].apply(x, fmask)
            st = carries.get(layer.name) if carries else None
            x, new_st = layer.apply(params[layer.name], x, state=st,
                                    train=train, rng=rng, mask=fmask)
            new_states[layer.name] = new_st
        return x, new_states

    # ------------------------------------------------------------- loss
    def _loss(self, params, features, labels, fmask, lmask, rng,
              train: bool = True, carries=None):
        """Score = output-layer loss + L1/L2 regularization + any layer's
        `aux_loss`. The output layer scores its INPUT (its softmax is
        fused into the loss), so the stack runs up to it."""
        out_layer = self.layers[-1]
        if not out_layer.is_output_layer:
            raise ValueError(f"the last layer ({out_layer.name}) is not an "
                             f"output layer; nothing to score")
        last = len(self.layers) - 1
        out_in, new_states = self._forward(
            params, features, train=train, rng=rng, fmask=fmask,
            carries=carries, stop=last)
        if last in self.conf.preprocessors:
            out_in = self.conf.preprocessors[last].apply(out_in, fmask)
        score_mask = lmask if lmask is not None else (
            fmask if labels is not None and labels.ndim == 3 else None)
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

        def step_fn(params, opt_state, states, step, features, labels,
                    fmask, lmask, rng, carries):
            loss, new_states = _grad_and_update(
                lambda live: self._loss(live, features, labels, fmask,
                                        lmask, rng, train=True,
                                        carries=carries),
                params, opt_state, groups, mode, thr, step)
            persist = {n: (new_states[n] if n in stateful
                           else states.get(n, {})) for n in states}
            out_carries = {n: tree_map(torch.detach, new_states[n])
                           for n in rnn_names} if tbptt else {}
            return params, opt_state, persist, loss, out_carries

        return step_fn

    # ---------------------------------------------------------- fit API
    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 32, steps_per_dispatch: int = 1,
            sync_every: int = 0, checkpointer=None, resume=None,
            stop_fn=None, preemption=None):
        """Train on arrays, a DataSet, a DataSetIterator or any iterable
        of DataSets (reference: `fit(DataSetIterator)`). The loss stays
        on the device (``score_`` reads it; ``sync_every=N`` reads it
        every N steps), and each batch's copy to the card is enqueued one
        batch ahead (`DevicePrefetchIterator`).

        With ``conf.tbptt_fwd_length > 0`` a 3-D batch trains by
        truncated BPTT (`_fit_tbptt`).

        Refused rather than ignored, until ported: ``steps_per_dispatch
        > 1``, ``checkpointer``, ``resume``, ``stop_fn``, ``preemption``,
        gradient checkpointing and non-SGD solvers."""
        self._check_init()
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
        # the device step counter starts from the host's: a fill, no copy
        self._step_t = torch.full((), self.iteration, dtype=torch.int64,
                                  device=self.device)
        TrainingExecutor(self, step=self._dispatch_batch).run(it, epochs)
        return self

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
        if self.conf.tbptt_fwd_length > 0 and ds.features.ndim == 3:
            return self._fit_tbptt(ds)
        return self._fit_batch(ds)

    def _fit_batch(self, ds: DataSet):
        """One train step on one batch; returns the device loss."""
        ds = self._on_device(ds)
        self._check_input(ds.features)
        step_fn = self.make_step_fn()
        (self.params_tree, self.updater_state, self.state_tree, loss,
         _) = step_fn(self.params_tree, self.updater_state, self.state_tree,
                      self._step_t, ds.features, ds.labels,
                      ds.features_mask, ds.labels_mask, self._rng, None)
        self._step_t.add_(1)
        return loss

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

            (self.params_tree, self.updater_state, self.state_tree, loss,
             carries) = step_fn(
                self.params_tree, self.updater_state, self.state_tree,
                self._step_t, sl(ds.features), sl(ds.labels),
                sl(ds.features_mask), sl(ds.labels_mask), self._rng,
                carries or None)
            losses.append(loss)
        self._step_t.add_(1)
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

    # ------------------------------------------------ stateful stepping
    @property
    def _rnn_layer_names(self):
        """Layers that carry RNN state (tBPTT / rnn_time_step)."""
        return [l.name for l in self.layers if _is_recurrent(l)]

    @torch.no_grad()
    def rnn_time_step(self, x) -> torch.Tensor:
        """Stateful inference over one or more timesteps; the recurrent
        carries persist across calls (reference: `rnnTimeStep`). `x` is
        [B, T, F], or [B, F] for one step. The whole read-step-write runs
        under the decode-state lock, and the carries are replaced only
        after a step that succeeded. Stacks with attention layers are
        refused: their lockstep KV-cache stepping is not ported yet
        (serving steps them through `session_step`)."""
        self._check_init()
        if self._decode_layer_names:
            _refuse("rnn_time_step over attention layers (lockstep KV-cache "
                    "decode carries)", "A4")
        x = _as_tensor(x, self.dtype, self.device)
        if x.ndim == 2:
            x = x[:, None, :]
        self._check_input(x, any_length=True)
        st = self._decode_state
        with st.lock():
            out, new_states = self._forward(self.params_tree, x,
                                            carries=st.carries or None)
            st.update({n: new_states[n] for n in self._rnn_layer_names})
        return out

    def rnn_clear_previous_state(self) -> None:
        self._decode_state.clear()

    def rnn_reorder_state(self, idx) -> None:
        """Reorder (or expand) the stepping carries along the batch
        dimension (a beam search gathers each beam's h/c rows to follow
        its parent). Every carry leaf is batch-leading."""
        ix = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                             device=self.device)
        self._decode_state.reorder(lambda carries: tree_map(
            lambda a: a[ix] if a.ndim >= 1 else a, carries))

    # ------------------------------------------- slot-indexed sessions
    @property
    def _decode_layer_names(self):
        return [l.name for l in self.layers if hasattr(l, "decode_carry")]

    def decode_limit(self) -> Optional[int]:
        """Smallest non-rolling cache/position bound across decode layers
        (None = unbounded): the session manager's budget ceiling."""
        return _decode_limit(l for l in self.layers
                             if hasattr(l, "decode_carry"))

    def session_carries(self, slots: int, kv_dtype: Optional[str] = None,
                        page_len: Optional[int] = None,
                        pages: Optional[int] = None):
        """Per-slot decode carries for `slots` sessions on the net's
        device: the KVSlotPool's backing tree. `page_len` switches every
        attention cache to the paged layout, which needs a uniform
        `max_cache` across decode layers (one logical page id = one
        physical row in every layer's pool); `pages` defaults to
        `slots * max_cache / page_len`."""
        self._check_init()
        decode = [l for l in self.layers if hasattr(l, "decode_carry")]
        if not decode:
            raise ValueError("session_carries needs at least one decode "
                             "layer (attention decode_carry)")
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
        return {l.name: l.decode_carry(slots, self.dtype, per_slot=True,
                                       kv_dtype=kv_dtype, page_len=page_len,
                                       pages=pages, device=self.device)
                for l in decode}

    def spec_decode_capable(self) -> bool:
        """Every carry position-addressed (no rolling rings): the rewind
        condition paged prefix caching shares."""
        decode = [l for l in self.layers if hasattr(l, "decode_carry")]
        return bool(decode) and not any(
            getattr(l, "rolling_cache", False) for l in decode)

    def prefix_cache_capable(self) -> bool:
        """Can the session carries run paged? No rolling rings and one
        uniform max_cache across decode layers."""
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
        them — its tokens are masked out of the cache write — and a
        page table never changes during a step."""
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
        into the cache-write mask (the caches update in place) and their
        positions are reverted. Returns (out, new_carries)."""
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
        new = {n: new_states[n] for n in self._decode_layer_names}
        if act is not None:
            new = self._lane_merge(carries, new, act)
        return out, new

    @torch.no_grad()
    def session_decode_window(self, tokens, carries, *, active, k,
                              temperature, top_k, top_p, greedy,
                              keys, offsets, budgets, eos_ids):
        """K decode steps in one call: each step forwards every active
        lane's token, samples the next one on the device
        (`utils.sampling.sample_token_lanes`), feeds it back, and retires
        a lane AT its EOS token or at its budget through the active mask.
        A Python loop of K steps with no host read inside: the caller
        reads the packed result once per window.

        Arguments are per lane (S = slots): `tokens` i32[S] first inputs;
        `active` bool[S]; sampling knobs f32/i32/f32/bool[S]; `keys`
        u32[S, 2] per-lane seed words — token i of a lane always draws
        with the counter `offsets + i`, so streams are invariant to K and
        to co-batching; `offsets` i32[S] tokens already generated;
        `budgets` i32[S] tokens left; `eos_ids` i32[S] (-1 = none).

        Returns (tokens i32[S, k], emitted bool[S, k], new_carries);
        positions not emitted hold -1."""
        from deeplearning4j_tpu_torch.utils import sampling as _sampling

        self._check_init()
        k = int(k)
        if k < 1:
            raise ValueError(f"window length k must be >= 1, got {k}")
        dev, dt = self.device, self.dtype
        tok = _as_tensor(tokens, torch.int64, dev)
        act = _as_tensor(active, torch.bool, dev)
        temps = _as_tensor(temperature, torch.float32, dev)
        tks = _as_tensor(top_k, torch.int64, dev)
        tps = _as_tensor(top_p, torch.float32, dev)
        grdy = _as_tensor(greedy, torch.bool, dev)
        keys_ = _as_tensor(np.asarray(keys).astype(np.int64), torch.int64,
                           dev)
        offs = _as_tensor(offsets, torch.int64, dev)
        buds = _as_tensor(budgets, torch.int64, dev)
        eos = _as_tensor(eos_ids, torch.int64, dev)
        ids_input = isinstance(self.layers[0], EmbeddingSequenceLayer)
        feat = None if ids_input else int(self.layers[0].n_in)
        S = tok.shape[0]
        n = torch.zeros((S,), dtype=torch.int64, device=dev)
        toks_out = torch.full((S, k), -1, dtype=torch.int32, device=dev)
        emits = torch.zeros((S, k), dtype=torch.bool, device=dev)
        c = carries
        for i in range(k):
            if ids_input:
                x = tok[:, None, None].to(dt)
            else:
                x = torch.nn.functional.one_hot(tok, feat).to(dt)[:, None]
            val = act.to(dt)[:, None]
            out, new_states = self._forward(self.params_tree, x, fmask=val,
                                            carries=c)
            new = {nm: new_states[nm] for nm in self._decode_layer_names}
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
        return toks_out, emits, c
