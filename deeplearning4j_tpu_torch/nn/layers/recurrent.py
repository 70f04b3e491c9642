"""Recurrent layers: LSTM family, SimpleRnn, GRU, RnnOutputLayer, wrappers
(port of `deeplearning4j_tpu/nn/layers/recurrent.py`).

As in the JAX package: activations are [batch, time, features]; the input
projection x@W+b for ALL timesteps is one matmul outside the recurrence;
stateful stepping passes and returns the carry in the `state` dict under
"h"/"c"; parameter names follow GravesLSTMParamInitializer ("W" input
weights [n_in, 4H], "RW" recurrent weights [H, 4H], "b" [4H], "P"
peepholes [3, H]; gate order i, f, g, o); a per-timestep mask holds the
carry where it is 0. The dataclasses keep the JAX serde names and fields,
`fused` included, so a JAX configuration loads as it is.

The LSTM recurrence goes to the fused sequence kernels B2a/B2b/B2c
(`ops/lstm.fused_lstm`) whenever the gates are sigmoid and the cell tanh;
any other pair, and a layer with `fused=False`, runs the per-step loop in
plain PyTorch, as the JAX package sends it to `lax.scan`
(`ops/kernel_defaults.lstm_policy` decides and counts). SimpleRnn, GRU
and the wrappers have no kernel in the JAX package either: a plain time
loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer


def _mask_carry(new, old, m):
    """Hold the carry where mask==0. m: [B] for one step."""
    return torch.where(m[:, None] > 0, new, old)


def _time_major(params, x, mask):
    """(xw [T, B, G], m [T, B]): the hoisted input projection of every
    timestep and the mask in x's dtype (ones when there is none)."""
    B, T, _ = x.shape
    xw = (x.reshape(B * T, -1) @ params["W"] + params["b"])
    xw = xw.reshape(B, T, -1).transpose(0, 1)
    m = (mask.to(x.dtype).T if mask is not None
         else torch.ones((T, B), dtype=x.dtype, device=x.device))
    return xw, m


def _last_unmasked(y, mask):
    """y [B, T, F] at each row's last unmasked step (the last step with
    no mask)."""
    if mask is None:
        return y[:, -1, :]
    idx = torch.clamp(mask.sum(dim=1).to(torch.int64) - 1, min=0)
    return torch.take_along_dim(y, idx[:, None, None], dim=1)[:, 0, :]


@register_layer
@dataclasses.dataclass(frozen=True)
class BaseRecurrentLayer(Layer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0

    def infer_n_in(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.size)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        raise NotImplementedError

    def _carry(self, state, x):
        if state and "h" in state:
            return state
        return self.initial_carry(x.shape[0], x.dtype, x.device)


@register_layer
@dataclasses.dataclass(frozen=True)
class LSTM(BaseRecurrentLayer):
    """Standard (peephole-free) LSTM; gate order i, f, g, o."""

    peephole: bool = False
    # fused sequence kernels (ops/lstm.py): None = whenever the gate and
    # cell activations are the kernels' sigmoid/tanh, True = require
    # them, False = the per-step loop
    fused: Optional[bool] = None

    def init_params(self, gen, input_type, dtype=torch.float32):
        h = self.n_out
        winit = self._winit()
        b = torch.zeros((4 * h,), dtype=dtype)
        b[h:2 * h] = self.forget_gate_bias_init
        params = {"W": winit(gen, (self.n_in, 4 * h), dtype),
                  "RW": winit(gen, (h, 4 * h), dtype),
                  "b": b}
        if self.peephole:
            params["P"] = torch.zeros((3, h), dtype=dtype)  # peep i, f, o
        return params, {}

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return {"h": z, "c": z.clone()}

    def _step(self, params, carry, xw_t, m_t):
        """One loop step. xw_t: precomputed x_t @ W + b, [B, 4H]."""
        h_prev, c_prev = carry["h"], carry["c"]
        gates = xw_t + h_prev @ params["RW"]
        i_, f_, g_, o_ = torch.chunk(gates, 4, dim=-1)
        gate_act = Activation.get(self.gate_activation)
        if self.peephole:
            p = params["P"]
            i_ = i_ + c_prev * p[0]
            f_ = f_ + c_prev * p[1]
        i = gate_act(i_)
        f = gate_act(f_)
        g = self._act(g_)
        c = f * c_prev + i * g
        if self.peephole:
            o_ = o_ + c * params["P"][2]
        o = gate_act(o_)
        h = o * self._act(c)
        if m_t is not None:
            h = _mask_carry(h, h_prev, m_t)
            c = _mask_carry(c, c_prev, m_t)
        return {"h": h, "c": c}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        from deeplearning4j_tpu_torch.ops.kernel_defaults import lstm_policy

        x = self._maybe_dropout(x, train, rng)
        carry = self._carry(state, x)
        xw, m = _time_major(params, x, mask)            # [T, B, 4H], [T, B]
        pol = lstm_policy(self.gate_activation, self.activation,
                          fused=self.fused, device=x.device,
                          hidden=self.n_out)
        if pol.kind == "fused":
            from deeplearning4j_tpu_torch.ops.lstm import fused_lstm

            p = params.get("P")
            if p is None:
                p = torch.zeros((3, self.n_out), dtype=x.dtype,
                                device=x.device)
            hs, hT, cT = fused_lstm(xw, params["RW"], p, carry["h"],
                                    carry["c"], m)
            return hs.transpose(0, 1), {"h": hT, "c": cT}
        hs = []
        for t in range(xw.shape[0]):
            carry = self._step(params, carry, xw[t], m[t])
            hs.append(carry["h"])
        return torch.stack(hs, dim=1), carry


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013), the reference's
    workhorse RNN."""

    peephole: bool = True


@register_layer
@dataclasses.dataclass(frozen=True)
class GRU(BaseRecurrentLayer):
    """GRU. `reset_after` True (the cuDNN/Keras-2 variant) multiplies r
    into the already-computed recurrent matmul, False (Cho et al.) into
    the hidden state before the matmul; `recurrent_bias` adds a separate
    bias on the recurrent matmul."""

    reset_after: bool = True
    recurrent_bias: bool = False

    def init_params(self, gen, input_type, dtype=torch.float32):
        h = self.n_out
        winit = self._winit()
        params = {"W": winit(gen, (self.n_in, 3 * h), dtype),
                  "RW": winit(gen, (h, 3 * h), dtype),
                  "b": torch.zeros((3 * h,), dtype=dtype)}
        if self.recurrent_bias:
            params["rb"] = torch.zeros((3 * h,), dtype=dtype)
        return params, {}

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype,
                                 device=device)}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        x = self._maybe_dropout(x, train, rng)
        hsz = self.n_out
        h = self._carry(state, x)["h"]
        xw, m = _time_major(params, x, mask)
        gate_act = Activation.get(self.gate_activation)
        rw = params["RW"]
        hs = []
        for t in range(xw.shape[0]):
            xw_t = xw[t]
            if self.reset_after:
                rh = h @ rw
                if "rb" in params:
                    rh = rh + params["rb"]
                r = gate_act(xw_t[:, :hsz] + rh[:, :hsz])
                z = gate_act(xw_t[:, hsz:2 * hsz] + rh[:, hsz:2 * hsz])
                n = self._act(xw_t[:, 2 * hsz:] + r * rh[:, 2 * hsz:])
            else:
                rz = h @ rw[:, :2 * hsz]
                r = gate_act(xw_t[:, :hsz] + rz[:, :hsz])
                z = gate_act(xw_t[:, hsz:2 * hsz] + rz[:, hsz:])
                n = self._act(xw_t[:, 2 * hsz:]
                              + (r * h) @ rw[:, 2 * hsz:])
            h = _mask_carry((1 - z) * n + z * h, h, m[t])
            hs.append(h)
        return torch.stack(hs, dim=1), {"h": h}


@register_layer
@dataclasses.dataclass(frozen=True)
class SimpleRnn(BaseRecurrentLayer):
    """Vanilla RNN: h = act(x W + h_prev RW + b)."""

    def init_params(self, gen, input_type, dtype=torch.float32):
        h = self.n_out
        winit = self._winit()
        return {"W": winit(gen, (self.n_in, h), dtype),
                "RW": winit(gen, (h, h), dtype),
                "b": torch.zeros((h,), dtype=dtype)}, {}

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype,
                                 device=device)}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        x = self._maybe_dropout(x, train, rng)
        h = self._carry(state, x)["h"]
        xw, m = _time_major(params, x, mask)
        hs = []
        for t in range(xw.shape[0]):
            h = _mask_carry(self._act(xw[t] + h @ params["RW"]), h, m[t])
            hs.append(h)
        return torch.stack(hs, dim=1), {"h": h}


@register_layer
@dataclasses.dataclass(frozen=True)
class Bidirectional(Layer):
    """Bidirectional wrapper over any recurrent layer; merge modes concat,
    add, mul, average. `return_sequences=False` emits only the final
    state of each direction, merged: the forward's last unmasked step
    with the backward's full-sequence state."""

    layer: Optional[Any] = None
    merge: str = "concat"
    return_sequences: bool = True

    def infer_n_in(self, input_type: InputType):
        return dataclasses.replace(self,
                                   layer=self.layer.infer_n_in(input_type))

    def with_defaults(self, **defaults):
        inner = self.layer.with_defaults(**defaults) if self.layer \
            else self.layer
        return dataclasses.replace(super().with_defaults(**defaults),
                                   layer=inner)

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.layer.output_type(input_type)
        size = inner.size * 2 if self.merge == "concat" else inner.size
        if not self.return_sequences:
            return InputType.feed_forward(size)
        return InputType.recurrent(size, inner.timesteps)

    def init_params(self, gen, input_type, dtype=torch.float32):
        pf, _ = self.layer.init_params(gen, input_type, dtype)
        pb, _ = self.layer.init_params(gen, input_type, dtype)
        return {"fwd": pf, "bwd": pb}, {}

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        yf, _ = self.layer.apply(params["fwd"], x, train=train, rng=rng,
                                 mask=mask)
        xr = torch.flip(x, dims=(1,))
        mr = None if mask is None else torch.flip(mask, dims=(1,))
        yb, _ = self.layer.apply(params["bwd"], xr, train=train, rng=rng,
                                 mask=mr)
        if not self.return_sequences:
            # reversed time puts right-padding first, where the mask
            # carries the initial state through, so the backward's last
            # step is its full-sequence state
            return self._merge(_last_unmasked(yf, mask), yb[:, -1, :]), state
        return self._merge(yf, torch.flip(yb, dims=(1,))), state

    def _merge(self, yf, yb):
        if self.merge == "concat":
            return torch.cat([yf, yb], dim=-1)
        if self.merge == "add":
            return yf + yb
        if self.merge == "mul":
            return yf * yb
        if self.merge in ("ave", "average"):
            return 0.5 * (yf + yb)
        raise ValueError(f"Unknown merge {self.merge!r}")


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesBidirectionalLSTM(Layer):
    """Bidirectional peephole LSTM with concatenated activations:
    Bidirectional(GravesLSTM, merge=concat)."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def _inner(self) -> Bidirectional:
        return Bidirectional(
            layer=GravesLSTM(n_in=self.n_in, n_out=self.n_out,
                             activation=self.activation,
                             weight_init=self.weight_init),
            merge="concat")

    def infer_n_in(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.size)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out * 2, input_type.timesteps)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return self._inner().init_params(gen, input_type, dtype)

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        return self._inner().apply(params, x, state=state, train=train,
                                   rng=rng, mask=mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(OutputLayer):
    """Per-timestep dense + activation over [B, T, n_in]; its
    `pre_output` and `score` are OutputLayer's (`x @ W` batches over the
    leading [B, T] axes, and the loss masks per timestep)."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def infer_n_in(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.size)
        return self


@register_layer
@dataclasses.dataclass(frozen=True)
class LastTimeStep(Layer):
    """Wrapper: emit only the last (unmasked) timestep of an RNN layer."""

    layer: Optional[Any] = None

    def infer_n_in(self, input_type: InputType):
        return dataclasses.replace(self,
                                   layer=self.layer.infer_n_in(input_type))

    def with_defaults(self, **defaults):
        inner = self.layer.with_defaults(**defaults) if self.layer \
            else self.layer
        return dataclasses.replace(super().with_defaults(**defaults),
                                   layer=inner)

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.layer.output_type(input_type)
        return InputType.feed_forward(inner.size)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return self.layer.init_params(gen, input_type, dtype)

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        y, st = self.layer.apply(params, x, state=state, train=train,
                                 rng=rng, mask=mask)
        return _last_unmasked(y, mask), st
