"""ComputationGraph configuration: graph vertices and the GraphBuilder
DSL (port of `deeplearning4j_tpu/nn/graph.py`, same serde names and
fields, so a graph configuration round-trips through JSON between the
two packages).

The DAG is data: named vertices and their input names. The topological
order is computed once at build() and the runtime
(`models/computation_graph.py`) folds over it. The recurrent vertices
`LastTimeStepVertex` and `DuplicateToTimeSeriesVertex` are DL4J's
seq2seq glue (an encoder's last step broadcast over the decoder's
length); a vertex, layer or preprocessor the port lacks is refused when
a configuration is read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.preprocessors import Preprocessor
from deeplearning4j_tpu_torch.utils.serde import (
    from_json, register_serde, to_json,
)


def resolve_output_type(name, vertex, in_types, n_inputs, known):
    """Shape propagation shared by GraphBuilder.build and
    ComputationGraph.init: with ALL input types known, a failing
    output_type is a configuration error named after the vertex;
    partially known inputs are skipped; a vertex with no inputs tries its
    best."""
    if in_types and len(in_types) == n_inputs:
        try:
            known[name] = vertex.output_type(*in_types)
        except Exception as e:
            raise ValueError(
                f"vertex {name!r} ({type(vertex).__name__}): incompatible "
                f"with its input types {[str(t) for t in in_types]}: {e}"
            ) from e
    elif not n_inputs:
        try:
            known[name] = vertex.output_type(*in_types)
        except Exception:  # an untyped zero-input vertex stays untyped
            pass


@dataclasses.dataclass(frozen=True)
class GraphVertex:
    """Base DAG node that is not a layer: `init_params`/`apply` as a
    layer's, over a list of inputs."""

    name: Optional[str] = None

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def init_params(self, gen, input_types: Sequence[InputType],
                    dtype=torch.float32):
        return {}, {}

    def apply(self, params, inputs: List, *, state=None, train=False,
              rng=None, mask=None):
        raise NotImplementedError


@register_serde
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertex):
    """add | subtract | product | average | max of same-shaped inputs."""

    op: str = "add"

    def output_type(self, *input_types: InputType) -> InputType:
        def sig(t):
            # every shape-bearing field but timesteps (one branch may
            # leave it unknown)
            return (t.kind, t.size, t.height, t.width, t.channels, t.depth)

        t0 = input_types[0]
        for t in input_types[1:]:
            if sig(t) != sig(t0):
                raise ValueError(
                    f"ElementWiseVertex inputs must have identical shapes; "
                    f"got {t0} vs {t}")
        return t0

    def apply(self, params, inputs, **kw):
        op = self.op.lower()
        out = inputs[0]
        if op == "add":
            for x in inputs[1:]:
                out = out + x
        elif op in ("sub", "subtract"):
            out = inputs[0] - inputs[1]
        elif op in ("mul", "product"):
            for x in inputs[1:]:
                out = out * x
        elif op in ("avg", "average"):
            out = sum(inputs) / len(inputs)
        elif op == "max":
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"Unknown elementwise op {self.op!r}")
        return out, kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class PoolHelperVertex(GraphVertex):
    """Drop the first spatial row and column of an NHWC activation (the
    Caffe-import alignment shim)."""

    def output_type(self, *input_types: InputType) -> InputType:
        t = input_types[0]
        if t.kind != "cnn":
            raise ValueError(
                f"PoolHelperVertex needs a 4-D CNN (NHWC) input, got {t}")
        return InputType.convolutional(t.height - 1, t.width - 1, t.channels)

    def apply(self, params, inputs, **kw):
        return inputs[0][:, 1:, 1:, :], kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class MergeVertex(GraphVertex):
    """Concatenate along the trailing (feature / channel) axis."""

    def output_type(self, *input_types: InputType) -> InputType:
        t0 = input_types[0]
        if t0.kind == "ff":
            return InputType.feed_forward(sum(t.size for t in input_types))
        if t0.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in input_types),
                                       t0.timesteps)
        if t0.kind == "cnn":
            return InputType.convolutional(
                t0.height, t0.width, sum(t.channels for t in input_types))
        return t0

    def apply(self, params, inputs, **kw):
        return torch.cat(inputs, dim=-1), kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class SubsetVertex(GraphVertex):
    """Feature range [from_, to], inclusive."""

    from_: int = 0
    to: int = 0

    def output_type(self, *input_types: InputType) -> InputType:
        n = self.to - self.from_ + 1
        t0 = input_types[0]
        if t0.kind == "rnn":
            return InputType.recurrent(n, t0.timesteps)
        return InputType.feed_forward(n)

    def apply(self, params, inputs, **kw):
        return inputs[0][..., self.from_:self.to + 1], kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class StackVertex(GraphVertex):
    """Concatenate along the batch axis."""

    def apply(self, params, inputs, **kw):
        return torch.cat(inputs, dim=0), kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class UnstackVertex(GraphVertex):
    """Batch chunk `from_` of `stack_size` equal chunks."""

    from_: int = 0
    stack_size: int = 1

    def apply(self, params, inputs, **kw):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_ * n:(self.from_ + 1) * n], kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class ScaleVertex(GraphVertex):
    """Multiply by a fixed scalar."""

    scale: float = 1.0

    def apply(self, params, inputs, **kw):
        return inputs[0] * self.scale, kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class ShiftVertex(GraphVertex):
    """Add a fixed scalar."""

    shift: float = 0.0

    def apply(self, params, inputs, **kw):
        return inputs[0] + self.shift, kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class ReshapeVertex(GraphVertex):
    """Reshape every example to `shape` (the batch axis stays)."""

    shape: Tuple[int, ...] = ()

    def apply(self, params, inputs, **kw):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape)), kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(GraphVertex):
    """x / ||x||_2 over the trailing axis."""

    eps: float = 1e-8

    def apply(self, params, inputs, **kw):
        x = inputs[0]
        n = torch.sqrt((x * x).sum(-1, keepdim=True) + self.eps)
        return x / n, kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class L2Vertex(GraphVertex):
    """Pairwise L2 distance of two inputs -> [batch, 1]."""

    eps: float = 1e-8

    def output_type(self, *input_types: InputType) -> InputType:
        return InputType.feed_forward(1)

    def apply(self, params, inputs, **kw):
        d = inputs[0] - inputs[1]
        return torch.sqrt((d * d).sum(-1, keepdim=True) + self.eps), \
            kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class PreprocessorVertex(GraphVertex):
    """An input preprocessor as a vertex."""

    preprocessor: Optional[Preprocessor] = None

    def output_type(self, *input_types: InputType) -> InputType:
        return self.preprocessor.output_type(input_types[0])

    def apply(self, params, inputs, **kw):
        return self.preprocessor.apply(inputs[0]), kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class LastTimeStepVertex(GraphVertex):
    """[B, T, F] -> [B, F], each row's last unmasked step (the last step
    with no mask). Reference: `nn/conf/graph/rnn/LastTimeStepVertex.java`.
    `mask_input` is kept for the configuration, as in the JAX package,
    whose runtime hands a vertex the first network-input mask among its
    own inputs: a vertex fed by a layer gets none and takes `x[:, -1]`,
    which after a masked LSTM is the last valid h (the layer holds it)."""

    mask_input: Optional[str] = None

    def output_type(self, *input_types: InputType) -> InputType:
        return InputType.feed_forward(input_types[0].size)

    def apply(self, params, inputs, *, mask=None, **kw):
        x = inputs[0]
        if mask is None:
            return x[:, -1, :], kw.get("state")
        idx = torch.clamp(mask.sum(dim=1).to(torch.int64) - 1, min=0)
        return torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0, :], \
            kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B, F] -> [B, T, F], broadcast over `timesteps` steps. Reference:
    `nn/conf/graph/rnn/DuplicateToTimeSeriesVertex.java` (which reads T
    from a named input; here, as in the JAX package, it is the config's
    `timesteps`)."""

    timesteps: int = 1

    def output_type(self, *input_types: InputType) -> InputType:
        return InputType.recurrent(input_types[0].flat_size(), self.timesteps)

    def apply(self, params, inputs, **kw):
        x = inputs[0]
        return x[:, None, :].expand(x.shape[0], self.timesteps,
                                    x.shape[-1]), kw.get("state")


@register_serde
@dataclasses.dataclass(frozen=True)
class LayerVertex(GraphVertex):
    """A layer as a DAG node (one input), with an optional preprocessor
    in front of it."""

    layer: Optional[Layer] = None
    preprocessor: Optional[Preprocessor] = None

    def output_type(self, *input_types: InputType) -> InputType:
        it = input_types[0]
        if self.preprocessor is not None:
            it = self.preprocessor.output_type(it)
        return self.layer.output_type(it)

    def init_params(self, gen, input_types, dtype=torch.float32):
        # the input type may be unknown (layers with explicit dims need
        # none)
        it = input_types[0] if input_types else None
        if it is not None and self.preprocessor is not None:
            it = self.preprocessor.output_type(it)
        return self.layer.init_params(gen, it, dtype)

    def apply(self, params, inputs, **kw):
        x = inputs[0]
        if self.preprocessor is not None:
            x = self.preprocessor.apply(x)
        return self.layer.apply(params, x, **kw)


@register_serde
@dataclasses.dataclass(frozen=True)
class CrossAttentionVertex(GraphVertex):
    """Cross-attention: queries from inputs[0], keys and values from
    inputs[1] (the encoder-decoder attention pattern), non-causal: the
    context is visible to every query. With no key mask the core is the
    flash kernels (`ops/attention.flash_attention`: B3a forward, B3b/B3c
    backward, at Tq != Tk); with a key mask the dense masked softmax,
    through `kernel_defaults.attention_policy`, as JAX routes it."""

    num_heads: int = 4
    n_out: Optional[int] = None
    # Name of the network input whose padding mask masks the KEYS (the
    # encoder stream). Without it, a mask is only applied when its length
    # unambiguously matches the context (Tk != Tq).
    key_mask_input: Optional[str] = None

    def output_type(self, *input_types: InputType) -> InputType:
        d = self.n_out or input_types[0].size
        return InputType.recurrent(d, input_types[0].timesteps)

    def init_params(self, gen, input_types: Sequence[InputType],
                    dtype=torch.float32):
        from deeplearning4j_tpu_torch.nn.initializers import xavier

        d_q = input_types[0].size
        d_kv = input_types[1].size
        d = self.n_out or d_q
        if d % self.num_heads:
            raise ValueError(
                f"n_out {d} not divisible by num_heads {self.num_heads}")
        return {
            "Wq": xavier(gen, (d_q, d), dtype),
            "Wk": xavier(gen, (d_kv, d), dtype),
            "Wv": xavier(gen, (d_kv, d), dtype),
            "Wo": xavier(gen, (d, d), dtype),
            "b": torch.zeros((d,), dtype=dtype),
        }, {}

    def _key_mask(self, mask, tq: int, tk: int):
        """The key mask a [B, T] mask gives, or None; JAX's rules."""
        if mask is None:
            return None
        if self.key_mask_input is not None:
            if mask.shape[1] != tk:
                raise ValueError(f"key_mask_input mask length "
                                 f"{mask.shape[1]} != context length {tk}")
            return mask
        if mask.shape[1] == tk and tq != tk:
            return mask
        if mask.shape[1] == tk and tq == tk:
            raise ValueError(
                "ambiguous mask (Tq == Tk): set key_mask_input to the "
                "encoder input's name so the key mask is delivered "
                "unambiguously")
        if mask.shape[1] != tq:
            raise ValueError(
                f"mask time axis {mask.shape[1]} matches neither the query "
                f"length {tq} nor the context length {tk}")
        # a query-length mask carries no attention semantics here: the
        # loss masks the output positions
        return None

    def apply(self, params, inputs, *, state=None, train=False, rng=None,
              mask=None):
        from deeplearning4j_tpu_torch.ops.attention import flash_attention
        from deeplearning4j_tpu_torch.ops.kernel_defaults import (
            attention_policy,
        )

        x, ctx = inputs
        B, Tq, _ = x.shape
        Tk = ctx.shape[1]
        d = params["Wo"].shape[0]
        H = self.num_heads
        Dh = d // H
        q = (x @ params["Wq"]).reshape(B, Tq, H, Dh)
        k = (ctx @ params["Wk"]).reshape(B, Tk, H, Dh)
        v = (ctx @ params["Wv"]).reshape(B, Tk, H, Dh)
        key_mask = self._key_mask(mask, Tq, Tk)
        pol = attention_policy(device=x.device, masked=key_mask is not None,
                               head_dim=Dh)
        if pol.kind == "flash":
            o = flash_attention(q, k, v, False)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
            s = s + torch.where(key_mask[:, None, None, :] > 0, 0.0, -1e30)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        y = o.reshape(B, Tq, d) @ params["Wo"] + params["b"]
        return y, state


@register_serde
@dataclasses.dataclass(frozen=True)
class ComputationGraphConfiguration:
    """A finalized DAG configuration."""

    vertices: Dict[str, GraphVertex] = dataclasses.field(default_factory=dict)
    vertex_inputs: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    network_inputs: Tuple[str, ...] = ()
    network_outputs: Tuple[str, ...] = ()
    input_types: Dict[str, Any] = dataclasses.field(default_factory=dict)
    topological_order: Tuple[str, ...] = ()
    seed: int = 12345
    updater: Any = None
    dtype: str = "float32"
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0
    gradient_checkpointing: bool = False
    tbptt_fwd_length: int = 0
    tbptt_back_length: int = 0
    optimization_algo: str = "stochastic_gradient_descent"
    solver_iterations: int = 100

    def to_json(self) -> str:
        return to_json(self)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        """Read a graph configuration written by either package; a vertex,
        layer or preprocessor the port has not ported yet is refused."""
        conf = from_json(s)
        for name, v in conf.vertices.items():
            parts = [v] if not isinstance(v, LayerVertex) else \
                [v.layer] + ([v.preprocessor] if v.preprocessor else [])
            for p in parts:
                if isinstance(p, dict):
                    raise NotImplementedError(
                        f"vertex {name!r}: {p.get('@class')} is not ported "
                        f"yet")
        return dataclasses.replace(
            conf,
            vertex_inputs={k: tuple(v) for k, v in conf.vertex_inputs.items()},
            network_inputs=tuple(conf.network_inputs),
            network_outputs=tuple(conf.network_outputs),
            topological_order=tuple(conf.topological_order))


def toposort(vertex_inputs: Dict[str, Sequence[str]],
             network_inputs: Sequence[str]) -> List[str]:
    """Kahn's topological order over vertex names, ready vertices taken
    in sorted order (the JAX package's order, so both number vertices
    alike)."""
    indeg = {v: 0 for v in vertex_inputs}
    consumers: Dict[str, List[str]] = {}
    for v, ins in vertex_inputs.items():
        for i in ins:
            if i in vertex_inputs:
                indeg[v] += 1
                consumers.setdefault(i, []).append(v)
            elif i not in network_inputs:
                raise ValueError(f"Vertex {v!r} references unknown input "
                                 f"{i!r}")
    ready = sorted(v for v, d in indeg.items() if d == 0)
    order = []
    while ready:
        v = ready.pop(0)
        order.append(v)
        for c in consumers.get(v, []):
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if len(order) != len(vertex_inputs):
        cyc = set(vertex_inputs) - set(order)
        raise ValueError(f"Graph has a cycle involving: {sorted(cyc)}")
    return order


class GraphBuilder:
    """`NeuralNetConfiguration.builder()...graph_builder()`: add inputs,
    layers and vertices by name, then `build()` cascades the builder's
    defaults into every layer, infers n_in along the topological order
    and checks every vertex's input types."""

    def __init__(self, base):
        self._base = base
        self._vertices: Dict[str, GraphVertex] = {}
        self._inputs: Dict[str, Tuple[str, ...]] = {}
        self._network_inputs: List[str] = []
        self._network_outputs: List[str] = []
        self._input_types: Dict[str, InputType] = {}
        self._tbptt_fwd = 0
        self._tbptt_back = 0

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._network_inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        for name, t in zip(self._network_inputs, types):
            self._input_types[name] = t
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str,
                  preprocessor: Optional[Preprocessor] = None
                  ) -> "GraphBuilder":
        layer = dataclasses.replace(layer, name=name)
        self._vertices[name] = LayerVertex(name=name, layer=layer,
                                           preprocessor=preprocessor)
        self._inputs[name] = tuple(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._vertices[name] = dataclasses.replace(vertex, name=name)
        self._inputs[name] = tuple(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._network_outputs = list(names)
        return self

    def tbptt(self, fwd: int, back: Optional[int] = None) -> "GraphBuilder":
        self._tbptt_fwd = fwd
        self._tbptt_back = back if back is not None else fwd
        return self

    def build(self) -> ComputationGraphConfiguration:
        from deeplearning4j_tpu_torch.nn.config import _validate_layer

        self._base._check_tbptt(self._tbptt_fwd)
        defaults = self._base._defaults()
        order = toposort(self._inputs, self._network_inputs)
        known: Dict[str, InputType] = dict(self._input_types)
        finalized: Dict[str, GraphVertex] = {}
        for name in order:
            v = self._vertices[name]
            in_types = [known[i] for i in self._inputs[name] if i in known]
            if isinstance(v, LayerVertex):
                layer = v.layer.with_defaults(**defaults)
                if in_types:
                    it = in_types[0]
                    if v.preprocessor is not None:
                        it = v.preprocessor.output_type(it)
                    layer = layer.infer_n_in(it)
                _validate_layer(layer, -1)
                v = dataclasses.replace(v, layer=layer)
            finalized[name] = v
            resolve_output_type(name, v, in_types, len(self._inputs[name]),
                                known)
        missing = [o for o in self._network_outputs if o not in finalized]
        if missing:
            raise ValueError(f"set_outputs references unknown vertices: "
                             f"{missing}")
        return ComputationGraphConfiguration(
            vertices=finalized,
            vertex_inputs=dict(self._inputs),
            network_inputs=tuple(self._network_inputs),
            network_outputs=tuple(self._network_outputs),
            input_types=self._input_types,
            topological_order=tuple(order),
            seed=self._base._seed,
            updater=defaults["updater"],
            dtype=self._base._dtype,
            gradient_normalization=self._base._grad_norm,
            gradient_normalization_threshold=self._base._grad_norm_threshold,
            gradient_checkpointing=self._base._grad_ckpt,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            optimization_algo=self._base._opt_algo,
            solver_iterations=self._base._solver_iterations)
