"""Network configuration DSL — port of `deeplearning4j_tpu/nn/config.py`.

The fluent builder cascades global defaults into every layer, names the
layers, and wires n_in from the InputType, exactly as the JAX builder
does, so `NeuralNetConfiguration.builder()...build()` here and there
give the same layer list. `MultiLayerConfiguration.from_json` reads a
configuration written by either package; its updater and learning-rate
schedule load as the port's own classes (`optim/updaters.py`,
`optim/schedules.py`, same serde names and fields), so JSON round-trips
in both directions.

At each change of layer family (a convolution after a flat input, a
dense layer after a convolution, ...) the list builder inserts the input
preprocessor JAX inserts (`nn/preprocessors.auto_preprocessor`), unless
`input_preprocessor(idx, pp)` gave one for that layer, and wires n_in
through its output type; the preprocessors travel in the configuration
(and its JSON, keyed by layer index) to `MultiLayerNetwork`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.initializers import WeightInit
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.preprocessors import (
    Preprocessor, auto_preprocessor,
)
from deeplearning4j_tpu_torch.optim import schedules as _schedules  # noqa: F401  (serde registration)
from deeplearning4j_tpu_torch.optim.updaters import Sgd, resolve_updater
from deeplearning4j_tpu_torch.utils.serde import (
    from_json, register_serde, to_json,
)


@register_serde
@dataclasses.dataclass(frozen=True)
class MultiLayerConfiguration:
    """Finalized sequential-network config; the fields mirror the JAX
    package's so JSON round-trips in both directions."""

    layers: Tuple[Layer, ...] = ()
    input_type: Optional[InputType] = None
    preprocessors: Dict[int, Any] = dataclasses.field(default_factory=dict)
    seed: int = 12345
    updater: Any = None
    dtype: str = "float32"
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0
    mini_batch: bool = True
    gradient_checkpointing: bool = False
    tbptt_fwd_length: int = 0
    tbptt_back_length: int = 0
    backprop: bool = True
    pretrain: bool = False
    optimization_algo: str = "stochastic_gradient_descent"
    solver_iterations: int = 100

    def to_json(self) -> str:
        return to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        conf = from_json(s)
        for layer in conf.layers:
            if not isinstance(layer, Layer):
                raise NotImplementedError(
                    f"layer {layer.get('name', layer.get('@class'))!r} "
                    f"({layer.get('@class')}) is not ported yet")
        # JSON keys are strings: restore the int layer indices
        pp = {int(k): v for k, v in conf.preprocessors.items()}
        for idx, v in pp.items():
            if not isinstance(v, Preprocessor):
                raise NotImplementedError(
                    f"input preprocessor {v.get('@class')!r} of layer {idx} "
                    f"is not ported yet")
        return dataclasses.replace(conf, layers=tuple(conf.layers),
                                   preprocessors=pp)

    def layer_names(self) -> List[str]:
        return [l.name for l in self.layers]


OPTIMIZATION_ALGOS = frozenset({"stochastic_gradient_descent",
                                "conjugate_gradient", "lbfgs",
                                "line_gradient_descent"})


class NeuralNetConfiguration:
    """Entry point: `NeuralNetConfiguration.builder()`."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    """Fluent builder holding global defaults; `.list(...)` produces a
    ListBuilder."""

    def __init__(self):
        self._seed = 12345
        self._activation: Optional[str] = None
        self._weight_init: Optional[str] = None
        self._updater: Any = None
        self._learning_rate: Any = None
        self._l1: Optional[float] = None
        self._l2: Optional[float] = None
        self._dropout: Optional[float] = None
        self._dtype = "float32"
        self._grad_norm = "none"
        self._grad_norm_threshold = 1.0
        self._mini_batch = True
        self._grad_ckpt = False
        self._opt_algo = "stochastic_gradient_descent"
        self._solver_iterations = 100

    def seed(self, s: int) -> "Builder":
        self._seed = int(s)
        return self

    def activation(self, a) -> "Builder":
        self._activation = a
        return self

    def weight_init(self, w) -> "Builder":
        self._weight_init = w
        return self

    def updater(self, u) -> "Builder":
        self._updater = None if u is None else resolve_updater(u)
        return self

    def learning_rate(self, lr) -> "Builder":
        self._learning_rate = lr
        return self

    def l1(self, v: float) -> "Builder":
        self._l1 = v
        return self

    def l2(self, v: float) -> "Builder":
        self._l2 = v
        return self

    def dropout(self, p: float) -> "Builder":
        self._dropout = p
        return self

    def dtype(self, d: str) -> "Builder":
        self._dtype = d
        return self

    def gradient_normalization(self, mode: str,
                               threshold: float = 1.0) -> "Builder":
        self._grad_norm = mode
        self._grad_norm_threshold = threshold
        return self

    def mini_batch(self, v: bool) -> "Builder":
        self._mini_batch = v
        return self

    def gradient_checkpointing(self, v: bool = True) -> "Builder":
        """Recompute layer activations in the backward pass
        (`torch.utils.checkpoint` a layer or layer vertex): memory for
        operations."""
        self._grad_ckpt = v
        return self

    def optimization_algo(self, algo: str,
                          iterations: Optional[int] = None) -> "Builder":
        """DL4J's `optimizationAlgo`: stochastic_gradient_descent (or
        "sgd", the default), conjugate_gradient (or "cg"), lbfgs or
        line_gradient_descent; a solver runs `iterations` full-batch
        iterations a fit batch (`optim/solvers.py`)."""
        algo = str(algo).lower()
        algo = {"sgd": "stochastic_gradient_descent",
                "cg": "conjugate_gradient"}.get(algo, algo)
        if algo not in OPTIMIZATION_ALGOS:
            raise ValueError(
                f"Unknown optimization algorithm {algo!r}; known: "
                f"{sorted(OPTIMIZATION_ALGOS)}")
        self._opt_algo = algo
        if iterations is not None:
            self._solver_iterations = int(iterations)
        return self

    def _check_tbptt(self, tbptt_fwd: int) -> None:
        """A full-batch solver cannot hand tBPTT carries from chunk to
        chunk: the combination is refused at build()."""
        if self._opt_algo != "stochastic_gradient_descent" and tbptt_fwd > 0:
            raise ValueError(
                "Truncated BPTT is only supported with "
                "stochastic_gradient_descent; full-batch solvers "
                f"({self._opt_algo}) cannot carry tBPTT state")

    def list(self, *layers: Layer) -> "ListBuilder":
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        return ListBuilder(self, list(layers))

    def graph_builder(self):
        """The ComputationGraph DSL (`nn/graph.GraphBuilder`)."""
        from deeplearning4j_tpu_torch.nn.graph import GraphBuilder

        return GraphBuilder(self)

    def _defaults(self) -> Dict[str, Any]:
        """As the JAX builder: no updater means Sgd at the builder's
        learning rate (default 1e-2); a learning rate overrides the
        updater's own."""
        upd = self._updater
        if upd is None:
            upd = Sgd(self._learning_rate if self._learning_rate is not None
                      else 1e-2)
        elif self._learning_rate is not None and \
                hasattr(upd, "learning_rate"):
            upd = dataclasses.replace(upd, learning_rate=self._learning_rate)
        return dict(activation=self._activation,
                    weight_init=self._weight_init or "xavier",
                    updater=upd, l1=self._l1, l2=self._l2,
                    dropout=self._dropout)


class ListBuilder:
    """Collects layers, wires shapes, builds a MultiLayerConfiguration."""

    def __init__(self, base: Builder, layers: List[Layer]):
        self._base = base
        self._layers = layers
        self._input_type: Optional[InputType] = None
        self._preprocessors: Dict[int, Preprocessor] = {}
        self._tbptt_fwd = 0
        self._tbptt_back = 0
        self._pretrain = False
        self._backprop = True

    def layer(self, l: Layer) -> "ListBuilder":
        self._layers.append(l)
        return self

    def set_input_type(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    def input_preprocessor(self, idx: int,
                           pp: Preprocessor) -> "ListBuilder":
        """Apply `pp` to the input of layer `idx` (it replaces the one the
        builder would insert there)."""
        self._preprocessors[idx] = pp
        return self

    def tbptt(self, fwd_length: int,
              back_length: Optional[int] = None) -> "ListBuilder":
        """Truncated BPTT lengths (reference: `tBPTTForwardLength`)."""
        self._tbptt_fwd = fwd_length
        self._tbptt_back = back_length if back_length is not None \
            else fwd_length
        return self

    def pretrain(self, v: bool) -> "ListBuilder":
        self._pretrain = v
        return self

    def backprop(self, v: bool) -> "ListBuilder":
        self._backprop = v
        return self

    def build(self) -> MultiLayerConfiguration:
        self._base._check_tbptt(self._tbptt_fwd)
        defaults = self._base._defaults()
        layers: List[Layer] = []
        preprocessors = dict(self._preprocessors)
        cur = self._input_type
        for i, layer in enumerate(self._layers):
            layer = layer.with_defaults(**defaults)
            if layer.name is None:
                layer = dataclasses.replace(
                    layer, name=f"layer{i}_{type(layer).__name__.lower()}")
            _validate_layer(layer, i)
            if cur is not None:
                if i not in preprocessors:
                    pp = auto_preprocessor(cur, _expected_kind(layer, cur))
                    if pp is not None:
                        preprocessors[i] = pp
                if i in preprocessors:
                    cur = preprocessors[i].output_type(cur)
                layer = layer.infer_n_in(cur)
                cur = layer.output_type(cur)
            layers.append(layer)
        return MultiLayerConfiguration(
            layers=tuple(layers), input_type=self._input_type,
            preprocessors=preprocessors, seed=self._base._seed,
            updater=defaults["updater"], dtype=self._base._dtype,
            gradient_normalization=self._base._grad_norm,
            gradient_normalization_threshold=self._base._grad_norm_threshold,
            mini_batch=self._base._mini_batch,
            gradient_checkpointing=self._base._grad_ckpt,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            backprop=self._backprop, pretrain=self._pretrain,
            optimization_algo=self._base._opt_algo,
            solver_iterations=self._base._solver_iterations)


def _validate_layer(layer: Layer, idx: int) -> None:
    """Fail at build() on an unknown activation, weight init or loss
    name."""
    from deeplearning4j_tpu_torch.nn.losses import LossFunction

    try:
        Activation.get(layer.activation)
        WeightInit.get(layer.weight_init)
        if hasattr(layer, "loss"):
            LossFunction.get(layer.loss)
    except ValueError as e:
        raise ValueError(f"layer {idx} ({layer.name}): {e}") from None


def _expected_kind(layer: Layer, cur: InputType) -> str:
    """The input family a layer consumes ("cnn", "rnn", "ff", or the
    arriving one for shape-preserving layers), as the JAX builder's
    `_expected_kind` decides it for the layers the port has: a declared
    `CONSUMES` first, then the layer's type."""
    from deeplearning4j_tpu_torch.nn.layers import (
        BaseRecurrentLayer, BatchNormalization, Bidirectional,
        ConvolutionLayer, GlobalPoolingLayer, GravesBidirectionalLSTM,
        LastTimeStep, MultiHeadAttention, RnnOutputLayer, SubsamplingLayer,
        ZeroPaddingLayer,
    )

    declared = getattr(layer, "CONSUMES", None)
    if declared == "any":
        return cur.kind
    if declared is not None:
        return declared
    if isinstance(layer, (ConvolutionLayer, SubsamplingLayer,
                          ZeroPaddingLayer)):
        return "cnn"
    if isinstance(layer, (BaseRecurrentLayer, Bidirectional,
                          GravesBidirectionalLSTM, RnnOutputLayer,
                          LastTimeStep, MultiHeadAttention)):
        return "rnn"
    if isinstance(layer, (BatchNormalization, GlobalPoolingLayer)):
        return cur.kind
    return "ff"
