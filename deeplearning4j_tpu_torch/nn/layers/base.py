"""Layer base class + registry (port of `deeplearning4j_tpu/nn/layers/base.py`).

A layer is a frozen config dataclass with the same fields as the JAX
package's, so configs round-trip between the two through JSON. Its
runtime API works on plain dicts of tensors keyed like the JAX params
tree (`"W"`, `"b"`, `"attn_Wq"`, ...), in the JAX orientation: a kernel
is `[n_in, n_out]` and applies as `x @ W`.

`apply(params, x, *, state=None, train=False, rng=None, mask=None)` has
the JAX signature. `rng` is an explicit `torch.Generator` on the net's
device (or an `RngTape` over one); dropout draws from it, through
`keep_mask`, only when `train` is true. `dropout` is the DROP
probability, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.initializers import WeightInit
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.utils.serde import register_serde

LAYER_REGISTRY: Dict[str, type] = {}

Params = Dict[str, torch.Tensor]
State = Dict[str, Any]


class RngTape:
    """A generator's draws, recorded on the first run of a function and
    replayed in order on every later run: under gradient checkpointing
    the backward recomputes a layer, and its dropout masks must be the
    ones the forward drew. (JAX folds a key per layer, so its recompute
    draws the same bits; `torch.utils.checkpoint` restores only the
    default generators, and a replay of the draws also needs no
    generator state read or written, which a CUDA graph's capture
    would refuse.) `start()` begins a run."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self._draws: list = []
        self._recorded = False
        self._i = 0

    def start(self) -> None:
        self._recorded = self._recorded or bool(self._draws)
        self._i = 0

    def keep(self, shape, keep: float, device) -> torch.Tensor:
        if self._recorded:
            m = self._draws[self._i]
            self._i += 1
            return m
        m = torch.rand(shape, generator=self.gen, device=device) < keep
        self._draws.append(m)
        return m


def keep_mask(shape, keep: float, rng, device) -> torch.Tensor:
    """The dropout keep mask (uniform draws below `keep`) from the
    generator `rng`, or from an `RngTape`."""
    if isinstance(rng, RngTape):
        return rng.keep(shape, keep, device)
    return torch.rand(shape, generator=rng, device=device) < keep


def register_layer(cls):
    """Register a layer class for config serde."""
    LAYER_REGISTRY[cls.__name__] = cls
    return register_serde(cls)


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base layer config/impl; None fields cascade from the builder's
    global defaults at build() time."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    updater: Optional[Any] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dropout: Optional[float] = None
    learning_rate: Optional[Any] = None
    bias_init: Optional[float] = None
    frozen: bool = False

    # ---- wiring API ----
    def with_defaults(self, **defaults) -> "Layer":
        """Fill None fields from global defaults (config cascade)."""
        names = {f.name for f in dataclasses.fields(self)}
        updates = {k: v for k, v in defaults.items()
                   if v is not None and k in names
                   and getattr(self, k) is None}
        return dataclasses.replace(self, **updates) if updates else self

    def infer_n_in(self, input_type: InputType) -> "Layer":
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    # ---- runtime API ----
    def init_params(self, gen: torch.Generator, input_type: InputType,
                    dtype=torch.float32) -> Tuple[Params, State]:
        """Seeded init on the CPU from `gen`; the network moves the
        tensors to its device."""
        return {}, {}

    def apply(self, params: Params, x, *, state: Optional[State] = None,
              train: bool = False, rng: Optional[torch.Generator] = None,
              mask=None) -> Tuple[Any, Optional[State]]:
        raise NotImplementedError

    # ---- shared helpers ----
    def _act(self, x):
        return Activation.get(self.activation)(x)

    def _winit(self):
        return WeightInit.get(self.weight_init)

    def _maybe_dropout(self, x, train: bool, rng):
        """Inverted dropout on the INPUT activations, drawn from the
        explicit generator `rng` (no draw when not training)."""
        p = self.dropout
        if not train or not p or rng is None:
            return x
        keep = 1.0 - p
        mask = keep_mask(x.shape, keep, rng, x.device)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))

    def regularization(self, params: Params) -> torch.Tensor:
        """L1/L2 penalty (0.5 * l2 * sum(w^2)); bias parameters take the
        separate l1_bias/l2_bias coefficients."""
        terms = []
        for k, v in params.items():
            is_bias = k in ("b", "beta", "bias")
            l1 = (self.l1_bias if is_bias else self.l1) or 0.0
            l2 = (self.l2_bias if is_bias else self.l2) or 0.0
            if l1:
                terms.append(l1 * v.abs().sum())
            if l2:
                terms.append(0.5 * l2 * (v * v).sum())
        if not terms:
            dev = next(iter(params.values())).device if params else None
            return torch.zeros((), dtype=torch.float32, device=dev)
        return sum(terms)

    @property
    def is_output_layer(self) -> bool:
        return False
